"""Edge-partitioned message passing for graphs too large for one device;
counterpart of ``gcnn_keras_tpu/parallel/edge_partition.py``.

The nodes of one graph are block-partitioned over the ranks after a
locality sort, and every edge goes to its receiver's shard. The host half
(``PartitionedGraph``, ``partition_graph``, ``required_halo_size``,
``encode_halo_senders``) is a numpy copy of the JAX package's and gives its
arrays bit for bit. The device half runs on each rank on its own slice:

- ``make_partitioned_aggregate``: the sender features all-gathered, then
  gathered by global sender id;
- ``make_halo_aggregate``: with a locality-sorted partition the remote
  senders lie on the ring neighbours, so each rank sends its boundary slabs
  to them and gathers from [left halo | local | right halo], O(halo)
  traffic instead of O(N).

Both mask the padding edges and sum the messages by receiver with
``ops/segment.py`` ``segment_sum(indices_are_sorted=True)``, the sorted
segment-sum kernel on the card; both differentiate through the collectives'
transposes.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.segment import segment_sum
from .collectives import all_gather, all_gather_tiled, ppermute
from .mesh import Mesh

Tensor = torch.Tensor


class PartitionedGraph:
    """Host-side container: stacked per-device arrays (leading dim D)."""

    def __init__(self, node_feats, senders_global, receivers_local,
                 edge_mask, node_mask, n_local: int, order: np.ndarray):
        self.node_feats = node_feats          # (D, N_loc, F)
        self.senders_global = senders_global  # (D, E_loc) int32, PERMUTED ids
        self.receivers_local = receivers_local  # (D, E_loc) int32
        self.edge_mask = edge_mask            # (D, E_loc) bool
        self.node_mask = node_mask            # (D, N_loc) bool
        self.n_local = n_local
        self.order = order                    # permutation: new_id -> old_id


def partition_graph(node_feats: np.ndarray, senders: np.ndarray,
                    receivers: np.ndarray, n_devices: int,
                    locality_sort: bool = True,
                    positions: Optional[np.ndarray] = None) -> PartitionedGraph:
    """Block-partition nodes over devices; edges go to the receiver's shard.

    ``locality_sort`` orders nodes by the first principal axis of
    ``positions`` (if given), so that halo edges join neighbouring shards.
    Each shard's edges are sorted by local receiver; padding edges (to a
    multiple of 128) aggregate into the last local slot with zero values.
    """
    n = node_feats.shape[0]
    if locality_sort and positions is not None:
        center = positions - positions.mean(0)
        u, s, vt = np.linalg.svd(center, full_matrices=False)
        order = np.argsort(center @ vt[0])
    else:
        order = np.arange(n)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)

    n_loc = (n + n_devices - 1) // n_devices
    n_pad = n_loc * n_devices
    feats = np.zeros((n_pad,) + node_feats.shape[1:], dtype=node_feats.dtype)
    feats[:n] = node_feats[order]
    node_mask = np.zeros(n_pad, dtype=bool)
    node_mask[:n] = True

    new_send = inv[senders]
    new_recv = inv[receivers]
    owner = new_recv // n_loc

    dev_edges: List[Tuple[np.ndarray, np.ndarray]] = []
    e_loc = 0
    for d in range(n_devices):
        sel = owner == d
        dev_edges.append((new_send[sel], new_recv[sel]))
        e_loc = max(e_loc, int(sel.sum()))
    e_loc = max(((e_loc + 127) // 128) * 128, 128)

    D = n_devices
    sg = np.zeros((D, e_loc), dtype=np.int32)
    rl = np.zeros((D, e_loc), dtype=np.int32)
    em = np.zeros((D, e_loc), dtype=bool)
    for d, (s_, r_) in enumerate(dev_edges):
        m = len(s_)
        o = np.argsort(r_ % n_loc, kind="stable")
        sg[d, :m] = s_[o]
        rl[d, :m] = (r_ % n_loc)[o]
        em[d, :m] = True
        rl[d, m:] = n_loc - 1
    return PartitionedGraph(
        node_feats=feats.reshape(D, n_loc, -1),
        senders_global=sg, receivers_local=rl, edge_mask=em,
        node_mask=node_mask.reshape(D, n_loc), n_local=n_loc, order=order)


def required_halo_size(part: PartitionedGraph) -> int:
    """Smallest halo (rows from each ring neighbour) covering every real
    edge's sender, or -1 if some sender lies beyond the ring neighbours
    (then only the all-gather strategy is valid)."""
    n_loc = part.n_local
    need = 0
    for d in range(part.senders_global.shape[0]):
        lo = d * n_loc
        s = part.senders_global[d][part.edge_mask[d]].astype(np.int64)
        if s.size == 0:
            continue
        rel = s - lo
        if np.any(rel < -n_loc) or np.any(rel >= 2 * n_loc):
            return -1
        need = max(need, int(np.max(np.maximum(-rel, rel - n_loc + 1),
                                    initial=0)))
    return need


def encode_halo_senders(part: PartitionedGraph, halo_size: int,
                        n_devices: int, strict: bool = False):
    """Global sender ids re-encoded as indices into each shard's
    [left_halo | local | right_halo] table. Returns ``(senders_haloidx (D,
    E_loc) int32, ok)``: ``ok`` is False where a real edge's sender lies
    outside the halo (its id is clipped to the table's edge and would
    aggregate the WRONG row, so callers must take the all-gather);
    ``strict=True`` raises instead."""
    n_loc = part.n_local
    sg = part.senders_global
    out = np.zeros_like(sg)
    ok = True
    for d in range(n_devices):
        lo = d * n_loc
        s = sg[d].astype(np.int64)
        rel = s - lo
        idx = rel + halo_size
        left = (rel < 0) & (rel >= -halo_size)
        idx = np.where(left, rel + halo_size, idx)
        inside = (rel >= -halo_size) & (rel < n_loc + halo_size)
        if not np.all(inside | ~part.edge_mask[d]):
            ok = False
        idx = np.clip(idx, 0, n_loc + 2 * halo_size - 1)
        out[d] = idx
    if strict and not ok:
        raise ValueError(
            f"halo_size={halo_size} does not cover all senders "
            f"(need {required_halo_size(part)}); use all-gather instead")
    return out.astype(np.int32), ok


def _aggregate(table: Tensor, senders: Tensor, receivers: Tensor, edge_mask: Tensor,
               n_local: int, message_fn: Optional[Callable]) -> Tensor:
    xj = table.index_select(0, senders.long())
    if message_fn is not None:
        xj = message_fn(xj)
    xj = xj * edge_mask.reshape(-1, *([1] * (xj.dim() - 1))).to(xj.dtype)
    return segment_sum(xj, receivers, n_local, indices_are_sorted=True)


def make_halo_aggregate(mesh: Mesh, halo_size: int,
                        message_fn: Optional[Callable] = None) -> Callable:
    """``fn(feats, senders_haloidx, recv_local, edge_mask) -> (N_loc, F)``
    on this rank's slices: the halo exchange, valid where every remote
    sender lies within ``halo_size`` rows of the neighbouring shards'
    boundaries (``encode_halo_senders``' ids)."""
    def fn(feats, senders_haloidx, recv_local, edge_mask):
        from_left = ppermute(feats[-halo_size:], mesh, 1)
        from_right = ppermute(feats[:halo_size], mesh, -1)
        table = torch.cat([from_left, feats, from_right], dim=0)
        return _aggregate(table, senders_haloidx, recv_local, edge_mask, feats.shape[0],
                          message_fn)
    return fn


def make_partitioned_aggregate(mesh: Mesh, message_fn: Optional[Callable] = None) -> Callable:
    """``fn(feats, senders_global, recv_local, edge_mask) -> (N_loc, F)``
    on this rank's slices: ``out[recv_local[e]] += message_fn(x[sender[e]])``
    over the real edges, the sender features all-gathered over the ranks.
    ``message_fn`` defaults to the identity."""
    def fn(feats, senders_global, recv_local, edge_mask):
        return _aggregate(all_gather(feats, mesh), senders_global, recv_local, edge_mask,
                          feats.shape[0], message_fn)
    return fn


def aggregate_partitioned(part: PartitionedGraph, mesh: Mesh,
                          message_fn: Optional[Callable] = None) -> np.ndarray:
    """One all-gather aggregation of ``part`` over the mesh (each rank takes
    its slice): the flat ``(N, F)`` result in the ORIGINAL node order, on
    every rank."""
    fn = make_partitioned_aggregate(mesh, message_fn)
    r = mesh.rank
    args = [torch.as_tensor(np.asarray(a[r])).to(mesh.device) for a in
            (part.node_feats, part.senders_global, part.receivers_local, part.edge_mask)]
    with torch.no_grad():
        out = all_gather_tiled(fn(*args), mesh).cpu().numpy()
    n = len(part.order)
    result = np.zeros((n, out.shape[-1]), dtype=out.dtype)
    result[part.order] = out[:n]
    return result
