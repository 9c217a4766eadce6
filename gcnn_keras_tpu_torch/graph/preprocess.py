"""Host-side graph preprocessing (numpy); counterpart of
``gcnn_keras_tpu/graph/preprocess.py``.

Every preprocessor of the JAX module, under its registered name
(``get_preprocessor``, which ``GraphDict.apply_preprocessor`` and
``map_list`` reach): the cutoff neighbour lists, molecular
(``set_range``) and periodic (``set_range_periodic``), the node-triple
angle list (``set_angle``), the edge-pair angle lists of DimeNet++
(``set_angle_edge_pairs``) and MXMNet (``set_angle_pairs_kgcnn``), GCN's
edge weights, and the edge-list and property utilities. The two neighbour
lists take the C++ cell list of ``native/neighborlist.cpp`` (through the
port's ``native`` loader) as the JAX package's do: under
``backend="auto"`` from 256 atoms (192 for periodic cells), and always
under ``"native"``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from .. import native


def set_range(graph: Dict[str, np.ndarray], max_distance: float = 4.0,
              max_neighbours: int = 15, node_coordinates: str = "node_coordinates",
              do_invert_distance: bool = False, self_loops: bool = False,
              exclusive: bool = True, backend: str = "auto") -> Dict[str, np.ndarray]:
    """Cutoff/kNN neighbour list -> ``range_indices`` (M,2) [receiver, sender]
    + ``range_attributes`` (M,1) distances.

    ``backend='auto'`` takes the C++ cell list (``native/neighborlist.cpp``,
    O(n)) for an exclusive cutoff without self loops under a neighbour cap
    from 256 atoms, and the dense O(n^2) numpy path otherwise; ``'numpy'``
    forces the dense path; ``'native'`` requires the library and raises
    ``RuntimeError`` without it.
    """
    xyz = np.asarray(graph[node_coordinates], dtype=np.float64)
    n = xyz.shape[0]

    use_native = (backend in ("auto", "native") and exclusive
                  and not self_loops and max_neighbours is not None
                  and (backend == "native" or n >= 256))
    if use_native:
        res = native.neighbor_list(xyz, max_distance, max_neighbours)
        if res is not None:
            pairs, d = res
            attr = (1.0 / np.maximum(d, 1e-12) if do_invert_distance else d).astype(np.float32)
            out = dict(graph)
            out["range_indices"] = pairs
            out["range_attributes"] = attr[:, None]
            return out
        if backend == "native":
            raise RuntimeError("native neighbour list unavailable "
                               "(g++ missing and no prebuilt library)")
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


def set_range_periodic(graph: Dict[str, np.ndarray], max_distance: float = 4.0,
                       max_neighbours: Optional[int] = None,
                       node_coordinates: str = "node_coordinates",
                       lattice: str = "graph_lattice",
                       exclusive: bool = True,
                       backend: str = "auto") -> Dict[str, np.ndarray]:
    """Periodic neighbour list over the lattice's images ->
    ``range_indices`` (M,2) [receiver, sender], ``range_image`` (M,3), the
    integer image of the SENDER (``d = x_i - (x_j + s @ L)``), and
    ``range_attributes`` (M,1) distances, in (receiver, sender) order.

    The images span the cutoff over the lattice's plane spacings; a
    receiver keeps its ``max_neighbours`` nearest. ``backend='auto'`` takes
    the C++ periodic cell list for an exclusive cutoff from 192 atoms, and
    this dense O(images n^2) path otherwise; ``'numpy'`` forces the dense
    path; ``'native'`` requires the library and raises ``RuntimeError``
    without it.
    """
    xyz = np.asarray(graph[node_coordinates], dtype=np.float64)
    lat = np.asarray(graph[lattice], dtype=np.float64)  # rows = lattice vectors
    n = xyz.shape[0]

    use_native = (backend in ("auto", "native") and exclusive
                  and (backend == "native" or n >= 192))
    if use_native:
        res = native.neighbor_list_periodic(xyz, lat, max_distance, max_neighbours)
        if res is not None:
            pairs, imgs, d = res
            out = dict(graph)
            out["range_indices"] = pairs
            out["range_image"] = imgs
            out["range_attributes"] = d[:, None].astype(np.float32)
            return out
        if backend == "native":
            raise RuntimeError("native neighbour list unavailable "
                               "(g++ missing and no prebuilt library)")
    # images needed along each lattice direction: cutoff / plane spacing
    recip = np.linalg.inv(lat).T
    spacing = 1.0 / np.maximum(np.linalg.norm(recip, axis=1), 1e-12)
    n_img = np.maximum(np.ceil(max_distance / spacing).astype(int), 1)
    images = np.stack(np.meshgrid(*[np.arange(-k, k + 1) for k in n_img], indexing="ij"),
                      axis=-1).reshape(-1, 3)
    shifts = images @ lat  # (I, 3)
    # receiver i at xyz[i], sender j at xyz[j] + shift: x_i - (x_j + s)
    diff = xyz[None, :, None, :] - shifts[:, None, None, :] - xyz[None, None, :, :]
    dist = np.linalg.norm(diff, axis=-1)  # (I, n_recv, n_send)
    mask = dist <= max_distance if exclusive else np.ones_like(dist, dtype=bool)
    central = int(np.nonzero(np.all(images == 0, axis=1))[0][0])
    mask[central][np.diag_indices(n)] = False  # no self pair in the central cell

    img_idx, recv, send = np.nonzero(mask)
    d = dist[img_idx, recv, send]
    if max_neighbours is not None:
        keep = np.zeros(len(d), dtype=bool)
        for r in range(n):
            sel = np.nonzero(recv == r)[0]
            if len(sel) > max_neighbours:
                sel = sel[np.argsort(d[sel], kind="stable")[:max_neighbours]]
            keep[sel] = True
        img_idx, recv, send, d = img_idx[keep], recv[keep], send[keep], d[keep]

    order = np.lexsort((send, recv))
    out = dict(graph)
    out["range_indices"] = np.stack([recv, send], axis=1)[order].astype(np.int64)
    out["range_image"] = images[img_idx][order].astype(np.int64)
    out["range_attributes"] = d[order][:, None].astype(np.float32)
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


def set_angle_edge_pairs(graph: Dict[str, np.ndarray],
                         range_indices: str = "range_indices",
                         allow_backtrack: bool = False) -> Dict[str, np.ndarray]:
    """DimeNet's edge-pair angle list ``angle_indices`` (P, 2): the pairs
    ``(e1, e2)`` with ``receiver(e1) == sender(e2)``, without the
    backtracking pair (``sender(e1) == receiver(e2)``) unless
    ``allow_backtrack``. In the JAX package's order: by ``e2``, then by
    ``e1`` in the stable receiver order."""
    ei = np.asarray(graph[range_indices])
    recv, send = ei[:, 0], ei[:, 1]
    pairs = []
    order = np.argsort(recv, kind="stable")
    recv_s = recv[order]
    n_max = int(recv.max()) + 2 if len(recv) else 1
    bounds = np.searchsorted(recv_s, np.arange(n_max))
    for e2 in range(len(ei)):
        j, i = send[e2], recv[e2]
        if j + 1 >= len(bounds):
            continue
        in_j = order[bounds[j]:bounds[j + 1]]  # the edges into j
        if not allow_backtrack:
            in_j = in_j[send[in_j] != i]
        if len(in_j):
            pairs.append(np.stack([in_j, np.full(len(in_j), e2)], axis=1))
    out = dict(graph)
    out["angle_indices"] = (np.concatenate(pairs, axis=0) if pairs
                            else np.zeros((0, 2), dtype=np.int64))
    return out


def set_angle_pairs_kgcnn(graph: Dict[str, np.ndarray],
                          range_indices: str = "edge_indices",
                          edge_pairing: str = "jk",
                          out_key: str = "angle_indices_1",
                          allow_self_edges: bool = False,
                          allow_multi_edges: bool = False,
                          allow_reverse_edges: bool = False) -> Dict[str, np.ndarray]:
    """The edge-pair list of kgcnn's ``get_angle_indices`` with its
    ``edge_pairing`` (MXMNet: ``"jk"``, and ``"ik"`` with self edges):
    edge ``n = (i, j)`` pairs with every edge ``m`` whose ``pos_fix`` index
    equals ``n``'s ``pos_ij`` index, ``k`` being ``m``'s other end. One
    (E, E) match per graph; pairs in row-major order of ``(n, m)``, as the
    JAX package gives them."""
    ei = np.asarray(graph[range_indices], dtype=np.int64)
    out = dict(graph)
    if len(ei) == 0:
        out[out_key] = np.zeros((0, 2), dtype=np.int64)
        return out
    if "k" not in edge_pairing or ("i" not in edge_pairing and "j" not in edge_pairing):
        raise ValueError(f"Invalid edge_pairing {edge_pairing!r}")
    pos_fix = 0 if edge_pairing[0] != "k" else 1
    pos_ij = 0 if "i" in edge_pairing else 1
    n_e = len(ei)
    match = ei[None, :, pos_fix] == ei[:, None, pos_ij]
    if not allow_multi_edges:
        match &= ~((ei[None, :, 0] == ei[:, None, 0]) & (ei[None, :, 1] == ei[:, None, 1]))
    if not allow_reverse_edges:
        match &= ~((ei[None, :, 0] == ei[:, None, 1]) & (ei[None, :, 1] == ei[:, None, 0]))
    diag = np.arange(n_e)
    match[diag, diag] = bool(allow_self_edges)
    n_idx, m_idx = np.nonzero(match)
    out[out_key] = np.stack([n_idx, m_idx], axis=1).astype(np.int64)
    return out


def set_edge_weights_uniform(graph: Dict[str, np.ndarray], value: float = 1.0,
                             edge_indices: str = "edge_indices") -> Dict[str, np.ndarray]:
    """``edge_weights`` (M, 1) float32, all ``value``."""
    ei = np.asarray(graph[edge_indices])
    out = dict(graph)
    out["edge_weights"] = np.full((ei.shape[0], 1), value, dtype=np.float32)
    return out


def normalize_edge_weights_symmetric(graph: Dict[str, np.ndarray],
                                     edge_indices: str = "edge_indices",
                                     edge_weights: str = "edge_weights") -> Dict[str, np.ndarray]:
    """GCN's symmetric normalization ``w_ij / sqrt(d_i d_j)``, the degrees
    summed over the receivers (``edge_indices[:, 0]``); weights 1 where the
    graph has none."""
    ei = np.asarray(graph[edge_indices])
    n = _num_nodes(graph, ei)
    w = np.asarray(graph.get(edge_weights)) if edge_weights in graph else \
        np.ones((ei.shape[0], 1), dtype=np.float32)
    w = w.reshape(len(ei), -1)
    deg = np.zeros(n)
    np.add.at(deg, ei[:, 0], w[:, 0])
    norm = 1.0 / np.sqrt(np.maximum(deg[ei[:, 0]] * deg[ei[:, 1]], 1e-12))
    out = dict(graph)
    out[edge_weights] = (w * norm[:, None]).astype(np.float32)
    return out


def make_undirected_edges(graph: Dict[str, np.ndarray],
                          edge_indices: str = "edge_indices") -> Dict[str, np.ndarray]:
    """``edge_indices`` with every edge's reverse added, each pair once, in
    sorted order."""
    ei = np.asarray(graph[edge_indices])
    out = dict(graph)
    out[edge_indices] = np.unique(np.concatenate([ei, ei[:, ::-1]], axis=0),
                                  axis=0).astype(np.int64)
    return out


def add_edge_self_loops(graph: Dict[str, np.ndarray],
                        edge_indices: str = "edge_indices") -> Dict[str, np.ndarray]:
    """``edge_indices`` followed by a self loop ``[i, i]`` of every node."""
    ei = np.asarray(graph[edge_indices])
    loops = np.stack([np.arange(_num_nodes(graph, ei))] * 2, axis=1)
    out = dict(graph)
    out[edge_indices] = np.concatenate([ei, loops], axis=0).astype(np.int64)
    return out


def sort_edge_indices(graph: Dict[str, np.ndarray],
                      edge_indices: str = "edge_indices",
                      edge_attributes: Sequence[str] = ()) -> Dict[str, np.ndarray]:
    """``edge_indices`` in (receiver, sender) order, and each of
    ``edge_attributes`` that the graph has in the same order."""
    ei = np.asarray(graph[edge_indices])
    order = np.lexsort((ei[:, 1], ei[:, 0]))
    out = dict(graph)
    out[edge_indices] = ei[order]
    for k in edge_attributes:
        if k in graph:
            out[k] = np.asarray(graph[k])[order]
    return out


def compute_reverse_edges_index_map(graph: Dict[str, np.ndarray],
                                    edge_indices: str = "edge_indices") -> Dict[str, np.ndarray]:
    """``edge_indices_reverse`` (M, 1): the position of each edge's
    reverse, or the edge's own position where it has none."""
    ei = np.asarray(graph[edge_indices])
    key = {(int(a), int(b)): i for i, (a, b) in enumerate(ei)}
    rev = np.array([key.get((int(b), int(a)), i) for i, (a, b) in enumerate(ei)],
                   dtype=np.int64)
    out = dict(graph)
    out["edge_indices_reverse"] = rev[:, None]
    return out


def count_nodes_and_edges(graph: Dict[str, np.ndarray],
                          edge_indices: str = "edge_indices") -> Dict[str, np.ndarray]:
    """``total_nodes`` and ``total_edges`` as 0-d arrays."""
    ei = np.asarray(graph[edge_indices])
    out = dict(graph)
    out["total_nodes"] = np.array(_num_nodes(graph, ei))
    out["total_edges"] = np.array(ei.shape[0])
    return out


def pad_property(graph: Dict[str, np.ndarray], key: str, pad_width, value=0):
    """``key`` padded by ``np.pad(..., pad_width, constant_values=value)``."""
    out = dict(graph)
    out[key] = np.pad(np.asarray(graph[key]), pad_width, constant_values=value)
    return out


def shift_to_unit_cell(graph: Dict[str, np.ndarray],
                       node_coordinates: str = "node_coordinates",
                       lattice: str = "graph_lattice") -> Dict[str, np.ndarray]:
    """The coordinates wrapped into the unit cell (fractional coordinates
    modulo 1), float32."""
    xyz = np.asarray(graph[node_coordinates], dtype=np.float64)
    lat = np.asarray(graph[lattice], dtype=np.float64)
    frac = (xyz @ np.linalg.inv(lat)) % 1.0
    out = dict(graph)
    out[node_coordinates] = (frac @ lat).astype(np.float32)
    return out


def expand_distance_gauss_basis(graph: Dict[str, np.ndarray], bins: int = 20,
                                distance: float = 4.0, sigma: float = 0.4,
                                offset: float = 0.0,
                                range_attributes: str = "range_attributes") -> Dict[str, np.ndarray]:
    """``range_attributes`` expanded on the host into ``bins`` Gaussians
    centred on ``linspace(offset, distance, bins)`` (endpoint included;
    the models expand on the device instead)."""
    d = np.asarray(graph[range_attributes]).reshape(-1, 1)
    centers = np.linspace(offset, distance, bins)
    out = dict(graph)
    out[range_attributes] = np.exp(-0.5 / sigma**2 * (d - centers[None]) ** 2).astype(np.float32)
    return out


def _num_nodes(graph: Dict[str, np.ndarray], ei: np.ndarray) -> int:
    """The node count of the first node array present, else one past the
    largest node id of ``ei``."""
    for key in ("node_number", "node_coordinates", "node_attributes"):
        if key in graph:
            return int(np.asarray(graph[key]).shape[0])
    return int(ei.max()) + 1 if ei.size else 0


class GraphPreprocessorBase:
    """A preprocessor function and its keyword arguments, called on a graph
    dict: the counterpart of the JAX package's class of the same name."""

    def __init__(self, fn: Callable, **config):
        self._fn = fn
        self._config = config

    def __call__(self, graph: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self._fn(graph, **self._config)

    def get_config(self) -> Dict:
        return dict(self._config)


# the JAX package's registry
_PREPROCESSORS = {
    "set_range": set_range,
    "set_angle": set_angle,
    "set_angle_edge_pairs": set_angle_edge_pairs,
    "set_range_periodic": set_range_periodic,
    "make_undirected_edges": make_undirected_edges,
    "add_edge_self_loops": add_edge_self_loops,
    "sort_edge_indices": sort_edge_indices,
    "set_edge_weights_uniform": set_edge_weights_uniform,
    "normalize_edge_weights_symmetric": normalize_edge_weights_symmetric,
    "set_edge_indices_reverse": compute_reverse_edges_index_map,
    "count_nodes_and_edges": count_nodes_and_edges,
    "pad_property": pad_property,
    "shift_to_unit_cell": shift_to_unit_cell,
    "expand_distance_gauss_basis": expand_distance_gauss_basis,
    "set_angle_pairs_kgcnn": set_angle_pairs_kgcnn,
}


def get_preprocessor(name: str, **config) -> GraphPreprocessorBase:
    """The preprocessor registered as ``name`` with ``config`` bound."""
    return GraphPreprocessorBase(_PREPROCESSORS[name], **config)
