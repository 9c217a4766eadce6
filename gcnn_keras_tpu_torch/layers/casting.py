"""Tensor-format casts; counterpart of ``gcnn_keras_tpu/layers/casting.py``
(the kgcnn names' surface): flat <-> per-graph padded with a mask, the edge
list -> a dense or COO adjacency."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..batch import GraphBatch, flat_to_padded, padded_to_flat

Tensor = torch.Tensor


def cast_flat_to_padded(batch: GraphBatch, values: Tensor,
                        fill: float = 0.0) -> Tuple[Tensor, Tensor]:
    """``(N, F)`` -> ``((G, M, F), (G, M) mask)``, kgcnn's ``ChangeTensorType``
    from ragged to masked."""
    padded = flat_to_padded(values, batch, fill=fill)
    mask = flat_to_padded(batch.node_mask.to(torch.float32), batch) > 0
    return padded, mask


def cast_padded_to_flat(batch: GraphBatch, padded: Tensor) -> Tensor:
    return padded_to_flat(padded, batch)


def dense_adjacency(batch: GraphBatch, values: Tensor, n_max: int) -> Tensor:
    """``(G, M, M, ...)``: each real edge's ``values (E, ...)`` summed into
    ``(graph, receiver slot, sender slot)`` by an accumulating scatter
    (duplicate edges add, as XLA's scatter-add); the slots of padding nodes
    beyond ``n_max`` clip to ``n_max - 1``."""
    mask = batch.edge_mask.to(values.dtype).reshape((-1,) + (1,) * (values.dim() - 1))
    ri = batch.node_loc[batch.receivers].clamp_max(n_max - 1).long()
    si = batch.node_loc[batch.senders].clamp_max(n_max - 1).long()
    adj = values.new_zeros((batch.n_graphs, n_max, n_max) + tuple(values.shape[1:]))
    return adj.index_put_((batch.edge_graph_id.long(), ri, si), values * mask, accumulate=True)


def cast_edges_to_dense_adjacency(batch: GraphBatch,
                                  edge_values: Optional[Tensor] = None) -> Tensor:
    """The edge list -> the ``(G, M, M)`` dense adjacency: column 0 of
    ``edge_values``, or 1 per real edge."""
    w = edge_values.reshape(batch.n_edge, -1)[:, 0] if edge_values is not None \
        else batch.edge_mask.to(torch.float32)
    return dense_adjacency(batch, w, max(batch.max_nodes, 1))


def cast_edges_to_coo(batch: GraphBatch) -> Tuple[Tensor, Tensor, Tensor]:
    """The disjoint COO adjacency: ``(receivers, senders, edge mask)``."""
    return batch.receivers, batch.senders, batch.edge_mask
