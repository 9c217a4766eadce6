"""Host-side graph preprocessing (numpy); counterpart of
``gcnn_keras_tpu/graph/preprocess.py``.

Carried so far: the dense cutoff neighbour list (``set_range``) and the
node-triple angle list (``set_angle``). The C++ cell-list backend of the JAX
package (``native/neighborlist.cpp``) is a later slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def set_range(graph: Dict[str, np.ndarray], max_distance: float = 4.0,
              max_neighbours: int = 15, node_coordinates: str = "node_coordinates",
              do_invert_distance: bool = False, self_loops: bool = False,
              exclusive: bool = True, backend: str = "auto") -> Dict[str, np.ndarray]:
    """Cutoff/kNN neighbour list -> ``range_indices`` (M,2) [receiver, sender]
    + ``range_attributes`` (M,1) distances.

    Every backend but ``'native'`` takes the dense O(n^2) numpy path, which
    is what the JAX package runs for molecules under 256 atoms.
    ``backend='native'`` raises ``NotImplementedError``.
    """
    if backend == "native":
        raise NotImplementedError(
            "set_range(backend='native'): the C++ neighbour list is not "
            "ported yet; use backend='numpy'")
    xyz = np.asarray(graph[node_coordinates], dtype=np.float64)
    n = xyz.shape[0]
    diff = xyz[:, None, :] - xyz[None, :, :]
    dist = np.linalg.norm(diff, axis=-1)
    mask = np.ones((n, n), dtype=bool)
    if exclusive:
        # strict less-than, as the reference's adjacency cutoff
        mask &= dist < max_distance
    # cap the neighbour count per receiving node; max_neighbours + 1 sorted
    # entries are kept so the self slot (distance 0) does not eat one
    if max_neighbours is not None and max_neighbours + 1 < n:
        order = np.argsort(dist, axis=1, kind="stable")
        keep = np.zeros_like(mask)
        rows = np.arange(n)[:, None]
        keep[rows, order[:, :max_neighbours + 1]] = True
        mask &= keep
    if not self_loops:
        np.fill_diagonal(mask, False)
    recv, send = np.nonzero(mask)
    d = dist[recv, send]
    attr = (1.0 / np.maximum(d, 1e-12) if do_invert_distance else d).astype(np.float32)
    out = dict(graph)
    out["range_indices"] = np.stack([recv, send], axis=1).astype(np.int64)
    out["range_attributes"] = attr[:, None]
    return out


def set_angle(graph: Dict[str, np.ndarray], range_indices: str = "range_indices",
              allow_multi_edges: bool = False,
              max_angles: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Angle triples (i, j, k): for every central node i, the ordered pairs
    of distinct neighbours j != k -> ``angle_indices_nodes`` (A, 3), in the
    JAX package's order (centres ascending, then ``j``'s and ``k``'s
    positions in the centre's neighbour list)."""
    ei = np.asarray(graph[range_indices])
    if len(ei) == 0:
        angles = np.zeros((0, 3), dtype=np.int64)
    else:
        recv, send = ei[:, 0], ei[:, 1]
        # within a group of m neighbours, pair p -> (a, b) with
        # a = p // (m-1), b' = p % (m-1), b = b' + (b' >= a)
        order = np.argsort(recv, kind="stable")
        recv_s, send_s = recv[order], send[order]
        uniq, starts, counts = np.unique(recv_s, return_index=True,
                                         return_counts=True)
        pairs_per = counts * (counts - 1)
        total = int(pairs_per.sum())
        grp = np.repeat(np.arange(len(uniq)), pairs_per)
        p = np.arange(total) - np.repeat(np.cumsum(pairs_per) - pairs_per,
                                         pairs_per)
        m_g = counts[grp]
        a = p // (m_g - 1)
        b = p % (m_g - 1)
        b = b + (b >= a)
        base = starts[grp]
        angles = np.stack([uniq[grp], send_s[base + a], send_s[base + b]],
                          axis=1).astype(np.int64)
        if not allow_multi_edges:
            angles = angles[angles[:, 1] != angles[:, 2]]
    if max_angles is not None and len(angles) > max_angles:
        angles = angles[:max_angles]
    out = dict(graph)
    out["angle_indices_nodes"] = angles.astype(np.int64)
    return out
