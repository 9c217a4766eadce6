"""Dense-block (per-molecule padded) message passing helpers; counterpart of
``gcnn_keras_tpu/layers/dense_block.py``.

For batches of small molecules node features can live as ``(G, M, F)``
padded blocks and messages flow over a dense ``(G, M, M)`` adjacency mask:
each per-edge filter MLP becomes one matmul over all pairs and each
aggregation a masked multiply and a sum over the neighbour axis, with no
gather or scatter in the interaction loop, for about M^2 / E_avg more
elementwise work. SchNet's ``dense_block=True`` runs on them. No kernel runs
here.
"""
from __future__ import annotations

import torch

from ..batch import GraphBatch, flat_to_padded

Tensor = torch.Tensor


def dense_adjacency(batch: GraphBatch) -> Tensor:
    """The edge list as a dense ``(G, M, M)`` float mask: ``adj[g, i, j] =
    1`` iff the batch holds a valid edge j -> i inside graph g (i receives,
    j sends). Multi-edges collapse to 1, so the dense block needs simple
    graphs, as range graphs without periodic images are. No gradient flows
    through it."""
    G, M = batch.n_graphs, max(batch.max_nodes, 1)
    loc = batch.node_loc.long().clamp_max(M)
    ei = torch.where(batch.edge_mask, loc[batch.receivers.long()], M)
    ej = loc[batch.senders.long()]
    eg = batch.graph_id.long()[batch.receivers.long()]
    adj = torch.zeros((G, M + 1, M + 1), dtype=torch.float32, device=loc.device)
    # every write is 1: duplicates (multi-edges, padding edges in the scratch
    # row) give the same result in any order
    adj = adj.index_put((eg, ei, ej), torch.ones((), device=loc.device))
    return adj[:, :M, :M]


def dense_pair_distances(coordinates: Tensor, batch: GraphBatch, adj: Tensor) -> Tensor:
    """All pair distances in each molecule, ``(G, M, M)``, from the flat
    ``(N, 3)`` coordinates (differentiable). Pairs without an edge take
    sqrt(1) instead, so that coincident padding rows give no NaN gradient;
    callers mask by ``adj``."""
    pos = flat_to_padded(coordinates, batch)  # (G, M, 3)
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    d2 = (diff * diff).sum(-1)
    return torch.sqrt(torch.where(adj > 0, d2, torch.ones((), dtype=d2.dtype,
                                                          device=d2.device)))


def padded_node_mask(batch: GraphBatch) -> Tensor:
    """The valid-node mask in the padded layout, ``(G, M)`` float32."""
    return flat_to_padded(batch.node_mask.to(torch.float32), batch)
