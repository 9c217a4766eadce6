"""Host-side graph preprocessing (numpy); counterpart of
``gcnn_keras_tpu/graph/preprocess.py``.

Only the dense cutoff neighbour list is carried so far. The C++ cell-list
backend of the JAX package (``native/neighborlist.cpp``) is a later slice.
"""
from __future__ import annotations

from typing import Dict

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
