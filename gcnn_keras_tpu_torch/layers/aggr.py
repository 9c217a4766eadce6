"""Gather and aggregation primitives over flat disjoint batches; counterpart
of ``gcnn_keras_tpu/layers/aggr.py``.

Messages flow sender -> receiver; edges are sorted by receiver, so every sum
onto nodes or graphs runs on the sorted segment-sum kernel, and every node
gather with a known sort order has that kernel as its transpose. Padding
edges target the dead padding node, so sums need no masking.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..batch import GraphBatch, _bcast, graph_psum, sender_node_table
from ..ops.cuda.bilinear import bilinear_gather_mul_segsum
from ..ops.cuda.fused_aggregate import (gather_mul_segsum_auto,
                                       gather_with_sorted_transpose)
from ..ops.segment import segment_ops_by_name, segment_softmax

Tensor = torch.Tensor


def gather_nodes(values: Tensor, indices: Tensor) -> Tensor:
    """Edge-wise gather ``values[(N, ...)][indices (E,)] -> (E, ...)`` by
    plain indexing (indices of unknown order)."""
    return values.index_select(0, indices)


def gather_sender_nodes(batch: GraphBatch, values: Tensor) -> Tensor:
    """Sender-side gather whose transpose runs on the sorted segment-sum
    through the build-time ``sender_perm``; a plain gather when the batch
    has none. On a partitioned shard it reads the halo-exchanged table
    (its transpose an ``index_add_``: a shard carries no ``sender_perm``)."""
    if batch.part_axis is not None:
        return gather_nodes(sender_node_table(batch, values), batch.senders)
    perm = batch.edges.get("sender_perm")
    if perm is None:
        return gather_nodes(values, batch.senders)
    return gather_with_sorted_transpose(values, batch.senders, perm)


def gather_receiver_nodes(batch: GraphBatch, values: Tensor) -> Tensor:
    """Receiver-side gather; receivers are already sorted, so its
    transpose needs no permutation."""
    return gather_with_sorted_transpose(values, batch.receivers, None)


def gather_state(state: Tensor, batch: GraphBatch) -> Tensor:
    """Broadcast per-graph state ``(G, ...)`` to the nodes ``(N, ...)``."""
    return state.index_select(0, batch.graph_id)


def pool_edges_to_nodes(batch: GraphBatch, edge_values: Tensor,
                        mode: str = "sum",
                        pooling_method: Optional[str] = None) -> Tensor:
    """Aggregate edge messages ``(E, ...)`` onto receiving nodes ``(N, ...)``.
    ``pooling_method`` is an alias for ``mode``. A partitioned shard masks
    its padding edges' messages and sums only."""
    mode = pooling_method or mode
    if batch.part_axis is not None:
        if mode != "sum":
            raise NotImplementedError(
                f"partitioned graphs only support sum aggregation, got {mode}")
        edge_values = edge_values * _bcast(batch.edge_mask, edge_values).to(edge_values.dtype)
    return segment_ops_by_name(mode, edge_values, batch.receivers, batch.n_node,
                               indices_are_sorted=True)


def pool_weighted_edges_to_nodes(batch: GraphBatch, edge_values: Tensor,
                                 edge_weights: Tensor, mode: str = "sum",
                                 normalize: bool = False) -> Tensor:
    """``pool_edges_to_nodes`` of ``edge_values * edge_weights`` (weights
    ``(E,)`` or ``(E, 1)`` broadcast over the features); ``normalize``
    divides each node's sum by the sum of its edges' weights."""
    w = edge_weights
    if w.dim() == edge_values.dim() - 1:
        w = w[..., None]
    out = pool_edges_to_nodes(batch, edge_values * w, mode=mode)
    if normalize:
        out = out / pool_edges_to_nodes(batch, w).clamp_min(1e-12)
    return out


def pool_edges_to_nodes_attention(batch: GraphBatch, edge_values: Tensor,
                                  attention_logits: Tensor) -> Tensor:
    """The sum onto the receivers of ``edge_values`` weighted by the softmax
    of ``attention_logits`` over each receiver's real edges."""
    coeff = segment_softmax(attention_logits, batch.receivers, batch.n_node,
                            mask=batch.edge_mask)
    return pool_edges_to_nodes(batch, edge_values * coeff)


def relational_pool_edges_to_nodes(batch: GraphBatch, edge_values: Tensor,
                                   edge_relations: Tensor, num_relations: int,
                                   mode: str = "sum") -> Tensor:
    """Per-relation aggregation ``(E, ...) -> (N, num_relations, ...)``: one
    segment reduction over the combined id ``receiver * num_relations +
    relation``. Those ids are not sorted, so a sum takes ``index_add_``, as
    the JAX package takes XLA's scatter for them."""
    combined = batch.receivers.long() * num_relations + edge_relations.long()
    out = segment_ops_by_name(mode, edge_values, combined, batch.n_node * num_relations)
    return out.reshape((batch.n_node, num_relations) + tuple(edge_values.shape[1:]))


def gather_mul_pool_edges(batch: GraphBatch, nodes: Tensor,
                          edge_filter: Tensor, mode: str = "sum",
                          fused=False) -> Tensor:
    """``out[r] = sum_e nodes[senders[e]] * edge_filter[e]``, the cfconv
    chain.

    ``fused=True`` with a ``sender_perm``, 2-D inputs and ``mode="sum"``
    takes the AD-closed fused kernel (``ops/cuda/bilinear.py`` ``GMS``:
    the kernel forward, the unfused sorted-segment-sum backward, any
    order). ``fused="vjp"``, or a batch without a perm, takes
    ``gather_mul_segsum_auto`` (the custom-VJP route). A batch without a
    perm was built unsorted, so its receivers are not taken as sorted there
    (the JAX package passes them as sorted). The default is unfused: a
    sender gather, a multiply and a sorted sum. A partitioned shard takes
    the unfused route in every mode: its senders index the halo-exchanged
    table and its padding edges are masked."""
    if batch.part_axis is not None:
        xj = gather_sender_nodes(batch, nodes)
        return pool_edges_to_nodes(batch, xj * edge_filter, mode=mode)
    perm = batch.edges.get("sender_perm")
    if fused and mode == "sum":
        if fused != "vjp" and perm is not None and nodes.dim() == 2 \
                and edge_filter.dim() == 2:
            return bilinear_gather_mul_segsum(
                nodes, edge_filter, batch.senders, batch.receivers, perm,
                batch.max_nodes)
        return gather_mul_segsum_auto(
            nodes, edge_filter, batch.senders, batch.receivers, batch.n_node,
            batch.max_nodes, indices_are_sorted=perm is not None,
            sender_perm=perm)
    xj = gather_sender_nodes(batch, nodes)
    return pool_edges_to_nodes(batch, xj * edge_filter, mode=mode)


def pool_nodes_to_graph(batch: GraphBatch, node_values: Tensor,
                        mode: str = "sum",
                        pooling_method: Optional[str] = None) -> Tensor:
    """Whole-graph readout ``(N, ...) -> (G, ...)``. Padding nodes all live
    in the padding graph slot, so no masking is needed.

    On a partitioned shard the result is the global per-graph sum (the
    shards' sums summed, on every shard): the readout MLPs after it are
    nonlinear. Its derivatives follow JAX's recipe: differentiate
    ``output / n_shards`` (``parallel/partitioned.py``), since the sum
    over the shards is its own transpose."""
    mode = pooling_method or mode
    out = segment_ops_by_name(mode, node_values, batch.graph_id,
                              batch.n_graphs, indices_are_sorted=True)
    if batch.part_axis is not None:
        if mode != "sum":
            raise NotImplementedError(
                f"partitioned graphs only support sum readout, got {mode}")
        out = graph_psum(batch, out)
    return out


def pool_nodes_to_graph_attention(batch: GraphBatch, node_values: Tensor,
                                  attention_logits: Tensor) -> Tensor:
    """Graph readout weighted by the softmax of ``attention_logits`` over
    each graph's real nodes."""
    coeff = segment_softmax(attention_logits, batch.graph_id, batch.n_graphs,
                            mask=batch.node_mask)
    return pool_nodes_to_graph(batch, node_values * coeff)


def pool_edges_to_graph(batch: GraphBatch, edge_values: Tensor,
                        mode: str = "sum") -> Tensor:
    """Readout over edges ``(E, ...) -> (G, ...)`` by ``edge_graph_id``,
    taken as unsorted (``index_add_`` for a sum), as in the JAX package."""
    return segment_ops_by_name(mode, edge_values, batch.edge_graph_id, batch.n_graphs)
