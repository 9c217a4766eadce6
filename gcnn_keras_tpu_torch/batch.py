"""Flat padded disjoint graph batching; counterpart of ``gcnn_keras_tpu/batch.py``.

A batch of graphs is stored as flat node / edge arrays in *disjoint*
(globally shifted) indexing with padded shapes:

- ``nodes[key]``   : ``(N_pad, ...)`` flat per-node tensors.
- ``edges[key]``   : ``(E_pad, ...)`` flat per-edge tensors.
- ``globals[key]`` : ``(G, ...)`` per-graph tensors.
- ``senders`` / ``receivers`` : ``(E_pad,)`` int32 global node ids; messages
  flow sender -> receiver, ``edge_indices[:, 0]`` is the receiver.
- ``graph_id`` / ``node_loc`` : ``(N_pad,)`` int32 graph slot and position
  within the graph of each node.
- padding nodes live in the *last* graph slot; padding edges point
  sender == receiver == the dead node ``N_pad - 1``.

Edges are sorted by receiver at build time, so sums over receivers run on
the sorted segment-sum kernel, and ``edges['sender_perm']`` (the stable
argsort of senders) lets every sender gather's transpose run on it too.

Assembly is host numpy, carried whole from the JAX package so that the
result matches its ``batch_graphs(np_out=True)`` bit for bit; only the last
step turns the arrays into tensors on the chosen device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .utils.devices import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class GraphBatch:
    """A padded batch of graphs in flat disjoint form, as torch tensors."""

    nodes: Dict[str, Tensor]
    edges: Dict[str, Tensor]
    globals: Dict[str, Tensor]
    senders: Tensor
    receivers: Tensor
    graph_id: Tensor
    node_loc: Tensor
    node_mask: Tensor
    edge_mask: Tensor
    angles: Optional[Tensor] = None
    angle_mask: Optional[Tensor] = None
    # (A2, 2) pairs of edge positions (in final sorted order) sharing a node
    angle_edges: Optional[Tensor] = None
    angle_edge_mask: Optional[Tensor] = None
    angle_edges_2: Optional[Tensor] = None
    angle_edge_mask_2: Optional[Tensor] = None
    # a second edge set in disjoint indexing, sorted by receiver
    senders2: Optional[Tensor] = None
    receivers2: Optional[Tensor] = None
    edge2_mask: Optional[Tensor] = None
    n_graphs: int = 1
    max_nodes: int = 0
    # True when every real edge sender / angle neighbour lies within +-128
    # rows of its receiver / centre (always True for max_nodes <= 128)
    edge_window_local: bool = False
    angle_window_local: bool = False
    # set on one shard of an edge-partitioned graph (parallel/partitioned.py):
    # the mesh the shards live on (its axis name on a stacked host batch);
    # ``senders`` then index the table ``sender_node_table`` builds, the
    # rows [left halo | local | right halo] when ``halo_size > 0``, else
    # every shard's rows
    part_axis: Any = None
    halo_size: int = 0
    n_shards: int = 1

    @property
    def n_node(self) -> int:
        return self.graph_id.shape[0]

    @property
    def n_edge(self) -> int:
        return self.senders.shape[0]

    @property
    def edge_graph_id(self) -> Tensor:
        return self.graph_id[self.receivers]

    def replace(self, **kv) -> "GraphBatch":
        return dataclasses.replace(self, **kv)

    def replace_nodes(self, **kv) -> "GraphBatch":
        return self.replace(nodes={**self.nodes, **kv})

    def replace_globals(self, **kv) -> "GraphBatch":
        return self.replace(globals={**self.globals, **kv})

    def _map(self, fn) -> "GraphBatch":
        """The batch with ``fn`` applied to every array (tensor, or numpy
        array of a batch built with ``np_out=True``)."""
        def apply(v):
            if isinstance(v, dict):
                return {k: fn(t) for k, t in v.items()}
            return fn(v) if isinstance(v, (torch.Tensor, np.ndarray)) else v
        return GraphBatch(**{f.name: apply(getattr(self, f.name))
                             for f in dataclasses.fields(self)})

    def to(self, device: DeviceLike, non_blocking: bool = False) -> "GraphBatch":
        """Copy of the batch with every array a tensor on ``device``;
        ``non_blocking`` copies from pinned memory asynchronously."""
        return self._map(lambda t: torch.as_tensor(t).to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        """Copy of the batch with every array a tensor in page-locked host
        memory, from which ``to(device, non_blocking=True)`` copies without
        holding up the host."""
        return self._map(lambda t: torch.as_tensor(t).pin_memory())


# ---------------------------------------------------------------------------
# Host-side (numpy) batch assembly
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_size(n: int, multiple: int = 128, min_size: int = 128) -> int:
    """Round ``n`` up to a bucket boundary: powers of two of ``min_size``
    until 1024, then multiples of ``multiple``."""
    n = max(n, 1)
    size = min_size
    while size < n and size < 1024:
        size *= 2
    if size >= n:
        return size
    return _round_up(n, max(multiple, 128))


def batch_graphs(
    graphs: Sequence[Dict[str, np.ndarray]],
    n_node_pad: Optional[int] = None,
    n_edge_pad: Optional[int] = None,
    n_graph_pad: Optional[int] = None,
    n_angle_pad: Optional[int] = None,
    edge_index_key: str = "edge_indices",
    angle_index_key: str = "angle_indices_nodes",
    angle_edge_index_key: str = "angle_indices",
    n_angle_edge_pad: Optional[int] = None,
    angle_edge_index_key_2: str = "angle_indices_2",
    second_edge_index_key: Optional[str] = None,
    n_edge2_pad: Optional[int] = None,
    global_keys: Sequence[str] = (),
    sort_edges_by_receiver: bool = True,
    max_nodes: Optional[int] = None,
    compute_reverse_edges: bool = False,
    device: DeviceLike = None,
    np_out: bool = False,
) -> GraphBatch:
    """Assemble a list of per-graph numpy dicts into one flat GraphBatch on
    ``device`` (the CUDA card unless ``device="cpu"``); with ``np_out`` its
    arrays stay numpy arrays on the host, as the JAX package's
    ``np_out=True`` gives them, and ``device`` is not read.

    Arrays whose leading dimension equals the node count are node
    properties, ones whose leading dim equals the edge count edge
    properties; names in ``global_keys`` (or scalars) become per-graph
    globals.
    """
    dev = None if np_out else resolve_device(device)
    n_real = len(graphs)
    if n_real == 0:
        raise ValueError("batch_graphs needs at least one graph")

    counts_n = []
    counts_e = []
    counts_a = []
    for g in graphs:
        ei = np.asarray(g[edge_index_key])
        n_nodes = _infer_num_nodes(g, edge_index_key)
        counts_n.append(n_nodes)
        counts_e.append(ei.shape[0])
        if angle_index_key in g:
            counts_a.append(np.asarray(g[angle_index_key]).shape[0])
        else:
            counts_a.append(0)

    tot_n, tot_e, tot_a = sum(counts_n), sum(counts_e), sum(counts_a)
    # Always reserve >=1 padding node + the padding graph slot so padding
    # edges have a dead node to point at.
    N = n_node_pad if n_node_pad is not None else bucket_size(tot_n + 1)
    E = n_edge_pad if n_edge_pad is not None else bucket_size(max(tot_e, 1))
    G = n_graph_pad if n_graph_pad is not None else n_real + 1
    has_angles = tot_a > 0 or n_angle_pad is not None
    A = n_angle_pad if n_angle_pad is not None else (bucket_size(max(tot_a, 1)) if has_angles else 0)
    if N < tot_n + 1:
        raise ValueError(f"n_node_pad={N} too small for {tot_n} nodes (+1 pad)")
    if E < tot_e:
        raise ValueError(f"n_edge_pad={E} too small for {tot_e} edges")
    if G < n_real + 1:
        raise ValueError(f"n_graph_pad={G} too small for {n_real} graphs (+1 pad)")
    if has_angles and A < tot_a:
        raise ValueError(f"n_angle_pad={A} too small for {tot_a} angles")

    # Node offsets per graph for disjoint indexing.
    offsets = np.concatenate([[0], np.cumsum(counts_n[:-1])]).astype(np.int64)

    graph_id = np.full((N,), G - 1, dtype=np.int32)
    node_loc = np.zeros((N,), dtype=np.int32)
    node_mask = np.zeros((N,), dtype=bool)
    for gi, (off, cn) in enumerate(zip(offsets, counts_n)):
        graph_id[off : off + cn] = gi
        node_loc[off : off + cn] = np.arange(cn, dtype=np.int32)
        node_mask[off : off + cn] = True
    # padding nodes: sequential slots of the padding graph
    n_pad_nodes = N - tot_n
    node_loc[tot_n:] = np.arange(n_pad_nodes, dtype=np.int32)

    dead_node = N - 1
    senders = np.full((E,), dead_node, dtype=np.int32)
    receivers = np.full((E,), dead_node, dtype=np.int32)
    edge_mask = np.zeros((E,), dtype=bool)
    e_off = 0
    for gi, g in enumerate(graphs):
        ei = np.asarray(g[edge_index_key], dtype=np.int64)
        m = ei.shape[0]
        if m:
            receivers[e_off : e_off + m] = ei[:, 0] + offsets[gi]
            senders[e_off : e_off + m] = ei[:, 1] + offsets[gi]
            edge_mask[e_off : e_off + m] = True
        e_off += m

    # Classification must be CONSISTENT across graphs (a graph with
    # n_nodes == n_edges is shape-ambiguous), so names are classified once,
    # by prefix first, then by shape on the first graph that carries the key.
    def _classify(k: str, v: np.ndarray, cn: int, ce: int) -> str:
        if k in global_keys or v.ndim == 0:
            return "global"
        if k.startswith(("node_",)):
            return "node"
        if k.startswith(("edge_", "range_", "bond_")):
            return "edge"
        if k.startswith(("graph_", "total_")):
            return "global"
        if k in ("force", "forces", "esp", "esp_grad", "charge", "charges",
                 "node_representation"):
            return "node"
        if k in ("energy", "energies", "num_nodes"):
            return "global"
        if v.ndim >= 1 and v.shape[0] == cn:
            return "node"
        if v.ndim >= 1 and v.shape[0] == ce:
            return "edge"
        return "global"

    _skip_keys = {edge_index_key, angle_index_key, angle_edge_index_key,
                  angle_edge_index_key_2}
    _skip_prefix = None
    if second_edge_index_key is not None:
        _skip_keys.add(second_edge_index_key)
        # sibling per-edge properties of the second set cannot ride the
        # primary edge arrays
        if second_edge_index_key.endswith("_indices"):
            _skip_prefix = second_edge_index_key[: -len("indices")]

    kind: Dict[str, str] = {}
    for gi, g in enumerate(graphs):
        for k, v in g.items():
            if k in _skip_keys or (_skip_prefix and k.startswith(_skip_prefix)):
                continue
            if k not in kind:
                kind[k] = _classify(k, np.asarray(v), counts_n[gi], counts_e[gi])

    node_props: Dict[str, List[np.ndarray]] = {}
    edge_props: Dict[str, List[np.ndarray]] = {}
    glob_props: Dict[str, List[np.ndarray]] = {}
    for gi, g in enumerate(graphs):
        for k, v in g.items():
            if k in _skip_keys or (_skip_prefix and k.startswith(_skip_prefix)):
                continue
            v = np.asarray(v)
            dest = {"node": node_props, "edge": edge_props,
                    "global": glob_props}[kind[k]]
            dest.setdefault(k, []).append(np.atleast_1d(v) if v.ndim == 0 else v)

    def _pad_cat(parts: List[np.ndarray], total: int) -> np.ndarray:
        cat = np.concatenate(parts, axis=0) if parts else np.zeros((0,))
        pad_shape = (total - cat.shape[0],) + cat.shape[1:]
        pad = np.zeros(pad_shape, dtype=cat.dtype)
        return np.concatenate([cat, pad], axis=0)

    nodes = {k: _pad_cat(v, N) for k, v in node_props.items()}
    edges = {k: _pad_cat(v, E) for k, v in edge_props.items()}
    globals_ = {k: _stack_pad(v, G) for k, v in glob_props.items()}
    globals_["graph_mask"] = np.concatenate(
        [np.ones(n_real, dtype=bool), np.zeros(G - n_real, dtype=bool)])
    globals_["num_nodes"] = _stack_pad(
        [np.asarray(c, dtype=np.int32) for c in counts_n], G)

    # Angles.
    angles = None
    angle_mask = None
    if has_angles:
        angles = np.full((A, 3), dead_node, dtype=np.int32)
        angle_mask = np.zeros((A,), dtype=bool)
        a_off = 0
        for gi, g in enumerate(graphs):
            if angle_index_key not in g:
                continue
            ai = np.asarray(g[angle_index_key], dtype=np.int64)
            m = ai.shape[0]
            if m:
                angles[a_off : a_off + m] = ai + offsets[gi]
                angle_mask[a_off : a_off + m] = True
            a_off += m
        # sort triples by CENTER node (stable; padding rows point at the
        # dead last node and stay at the end)
        a_order = np.argsort(angles[:, 0], kind="stable")
        angles = angles[a_order]
        angle_mask = angle_mask[a_order]

    # Edge-pair angle indices: per-graph local edge positions -> global
    # positions in the FINAL (sorted) edge order.
    e_offsets = np.concatenate([[0], np.cumsum(counts_e[:-1])]).astype(np.int64)

    def _build_angle_edges(key: str, pad: Optional[int]):
        if not any(key in g for g in graphs):
            return None, None
        tot_ae = sum(np.asarray(g[key]).shape[0] for g in graphs if key in g)
        AE = pad if pad is not None else bucket_size(max(tot_ae, 1))
        if AE < tot_ae:
            raise ValueError(f"angle-edge pad {AE} too small for {tot_ae} ({key})")
        ae_arr = np.full((AE, 2), E - 1, dtype=np.int64)
        ae_mask = np.zeros((AE,), dtype=bool)
        ae_off = 0
        for gi, g in enumerate(graphs):
            if key not in g:
                continue
            ae = np.asarray(g[key], dtype=np.int64)
            m = ae.shape[0]
            if m:
                ae_arr[ae_off:ae_off + m] = ae + e_offsets[gi]
                ae_mask[ae_off:ae_off + m] = True
            ae_off += m
        return ae_arr, ae_mask

    angle_edges, angle_edge_mask = _build_angle_edges(
        angle_edge_index_key, n_angle_edge_pad)
    angle_edges_2, angle_edge_mask_2 = _build_angle_edges(
        angle_edge_index_key_2, None)

    # Second edge set, disjoint indexing, its own stable sort by receiver.
    senders2 = receivers2 = edge2_mask = None
    if second_edge_index_key is not None and \
            any(second_edge_index_key in g for g in graphs):
        counts_e2 = [np.asarray(g[second_edge_index_key]).shape[0]
                     if second_edge_index_key in g else 0 for g in graphs]
        tot_e2 = sum(counts_e2)
        E2 = n_edge2_pad if n_edge2_pad is not None else bucket_size(max(tot_e2, 1))
        if E2 < tot_e2:
            raise ValueError(f"n_edge2_pad={E2} too small for {tot_e2} edges")
        senders2 = np.full((E2,), dead_node, dtype=np.int32)
        receivers2 = np.full((E2,), dead_node, dtype=np.int32)
        edge2_mask = np.zeros((E2,), dtype=bool)
        e2_off = 0
        for gi, g in enumerate(graphs):
            if second_edge_index_key not in g:
                continue
            ei2 = np.asarray(g[second_edge_index_key], dtype=np.int64)
            m = ei2.shape[0]
            if m:
                receivers2[e2_off:e2_off + m] = ei2[:, 0] + offsets[gi]
                senders2[e2_off:e2_off + m] = ei2[:, 1] + offsets[gi]
                edge2_mask[e2_off:e2_off + m] = True
            e2_off += m
        order2s = np.argsort(receivers2, kind="stable")
        senders2 = senders2[order2s]
        receivers2 = receivers2[order2s]
        edge2_mask = edge2_mask[order2s]

    # Sort edges by receiver (stable) so sums run on the sorted kernel.
    if sort_edges_by_receiver:
        order = np.argsort(receivers, kind="stable")
        senders = senders[order]
        receivers = receivers[order]
        edge_mask = edge_mask[order]
        edges = {k: v[order] for k, v in edges.items()}
        if angle_edges is not None or angle_edges_2 is not None:
            inv_order = np.empty_like(order)
            inv_order[order] = np.arange(E)
            if angle_edges is not None:
                angle_edges = inv_order[angle_edges]
            if angle_edges_2 is not None:
                angle_edges_2 = inv_order[angle_edges_2]

    if sort_edges_by_receiver:
        # slot of each edge within its receiver's group
        if E:
            starts = np.searchsorted(receivers, receivers, side="left")
            edges["edge_slot"] = (np.arange(E) - starts).astype(np.int32)
        else:
            edges["edge_slot"] = np.zeros(0, dtype=np.int32)
        # stable permutation into SENDER-sorted order: the transpose of a
        # sender gather (d_x scatters by sender) becomes a sorted segment-sum
        edges["sender_perm"] = np.argsort(senders, kind="stable") \
            .astype(np.int32)

    if compute_reverse_edges:
        # global reverse-edge position per edge (self if no reverse exists),
        # computed AFTER sorting so it indexes the final edge order
        key_fwd = senders.astype(np.int64) * N + receivers
        key_rev = receivers.astype(np.int64) * N + senders
        order2 = np.argsort(key_fwd, kind="stable")
        pos = np.clip(np.searchsorted(key_fwd[order2], key_rev), 0, max(E - 1, 0))
        cand = order2[pos] if E else np.zeros(0, dtype=np.int64)
        match = key_fwd[cand] == key_rev if E else np.zeros(0, dtype=bool)
        edges["edge_pair_index"] = np.where(match, cand, np.arange(E)).astype(np.int32)

    if max_nodes is None:
        max_nodes = int(max(counts_n)) if counts_n else 0
    elif counts_n and max_nodes < max(counts_n):
        raise ValueError(f"max_nodes={max_nodes} < largest graph {max(counts_n)}")

    if max_nodes <= 128:
        edge_window_local = True
        angle_window_local = angles is not None
    else:
        em = np.asarray(edge_mask, bool)
        edge_window_local = bool(not em.any() or np.max(np.abs(
            senders[em].astype(np.int64)
            - receivers[em].astype(np.int64))) <= 128)
        angle_window_local = False
        if angles is not None:
            am = np.asarray(angle_mask, bool)
            if am.any():
                a_real = np.asarray(angles)[am].astype(np.int64)
                angle_window_local = bool(max(
                    np.max(np.abs(a_real[:, 1] - a_real[:, 0])),
                    np.max(np.abs(a_real[:, 2] - a_real[:, 0]))) <= 128)
            else:
                angle_window_local = True

    def conv(x):
        if x is None:
            return None
        x = np.ascontiguousarray(x)
        return x if np_out else torch.as_tensor(x, device=dev)

    return GraphBatch(
        nodes={k: conv(v) for k, v in nodes.items()},
        edges={k: conv(v) for k, v in edges.items()},
        globals={k: conv(v) for k, v in globals_.items()},
        senders=conv(senders),
        receivers=conv(receivers),
        graph_id=conv(graph_id),
        node_loc=conv(node_loc),
        node_mask=conv(node_mask),
        edge_mask=conv(edge_mask),
        angles=conv(angles),
        angle_mask=conv(angle_mask),
        angle_edges=conv(angle_edges),
        angle_edge_mask=conv(angle_edge_mask),
        angle_edges_2=conv(angle_edges_2),
        angle_edge_mask_2=conv(angle_edge_mask_2),
        senders2=conv(senders2),
        receivers2=conv(receivers2),
        edge2_mask=conv(edge2_mask),
        n_graphs=G,
        max_nodes=max_nodes,
        edge_window_local=edge_window_local,
        angle_window_local=angle_window_local,
    )


def _stack_pad(parts: List[np.ndarray], total: int) -> np.ndarray:
    arrs = [np.asarray(p) for p in parts]
    arrs = [a[None] if a.ndim == 0 else a.reshape(1, *a.shape) for a in arrs]
    cat = np.concatenate(arrs, axis=0)
    pad_shape = (total - cat.shape[0],) + cat.shape[1:]
    return np.concatenate([cat, np.zeros(pad_shape, dtype=cat.dtype)], axis=0)


def _infer_num_nodes(g: Dict[str, np.ndarray], edge_index_key: str) -> int:
    for key in ("node_number", "node_coordinates", "node_attributes", "node_labels"):
        if key in g:
            return int(np.asarray(g[key]).shape[0])
    ei = np.asarray(g[edge_index_key])
    return int(ei.max()) + 1 if ei.size else 0


# ---------------------------------------------------------------------------
# Device-side helpers
# ---------------------------------------------------------------------------

def flat_to_padded(values: Tensor, batch: GraphBatch, fill: float = 0.0) -> Tensor:
    """Scatter flat node values ``(N, ...)`` to per-graph padded
    ``(G, M, ...)`` with ``M = max(batch.max_nodes, 1)``. Padding nodes of
    the padding graph may lie beyond M; they are clipped into a scratch row
    ``M`` and dropped."""
    G, M = batch.n_graphs, max(batch.max_nodes, 1)
    out = values.new_full((G, M + 1) + tuple(values.shape[1:]), fill)
    loc = batch.node_loc.clamp_max(M).long()
    src = torch.where(_bcast(batch.node_mask, values), values,
                      values.new_full((), fill))
    # (graph_id, loc) is unique except in the scratch row, where every
    # value written is ``fill``
    out = out.index_put((batch.graph_id.long(), loc), src)
    return out[:, :M]


def padded_to_flat(padded: Tensor, batch: GraphBatch) -> Tensor:
    """Gather per-graph padded ``(G, M, ...)`` back to flat ``(N, ...)``;
    padding nodes get 0."""
    M = padded.shape[1]
    loc = batch.node_loc.clamp_max(M - 1).long()
    vals = padded[batch.graph_id.long(), loc]
    return torch.where(_bcast(batch.node_mask, vals), vals, vals.new_zeros(()))


def sender_node_table(batch: GraphBatch, values: Tensor) -> Tensor:
    """The node table ``batch.senders`` indexes: ``values`` itself, or on a
    shard of an edge-partitioned graph the halo exchange, each shard's
    boundary slabs sent to its ring neighbours and concatenated as [left
    halo | local | right halo] (``halo_size > 0``), else the tiled
    all-gather of every shard's rows. Both collectives are autograd
    Functions whose transposes return each neighbour's share of a gradient
    (the forces on the halo rows) to the shard that owns the rows."""
    if batch.part_axis is None:
        return values
    from .parallel.collectives import all_gather, ppermute
    h = batch.halo_size
    if h < 0:
        raise ValueError("halo_size must be >= 0")
    if h > 0:
        from_left = ppermute(values[-h:], batch.part_axis, 1)
        from_right = ppermute(values[:h], batch.part_axis, -1)
        return torch.cat([from_left, values, from_right], dim=0)
    return all_gather(values, batch.part_axis)


def refuse_partitioned(batch: GraphBatch, layer: str) -> None:
    """Raise where ``layer``, which reads no halo table, meets a shard of an
    edge-partitioned graph: its neighbour ids there index the
    halo-exchanged table, not the shard's own nodes, so it would compute
    wrong numbers (the JAX package's computes them without a word)."""
    if batch.part_axis is not None:
        raise NotImplementedError(
            f"{layer} on an edge-partitioned batch: the layer reads no halo table, as in the "
            f"JAX package, so the shard's neighbour ids would index the wrong nodes")


def graph_psum(batch: GraphBatch, per_graph: Tensor) -> Tensor:
    """The global per-graph value of a shard-local per-graph reduction
    ``(G, ...)``: the sum over the shards of an edge-partitioned batch, the
    identity otherwise."""
    if batch.part_axis is None:
        return per_graph
    from .parallel.collectives import psum
    return psum(per_graph, batch.part_axis)


def _bcast(mask: Tensor, ref: Tensor) -> Tensor:
    return mask.reshape(tuple(mask.shape) + (1,) * (ref.dim() - mask.dim()))
