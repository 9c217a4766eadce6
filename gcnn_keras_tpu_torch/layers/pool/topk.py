"""Top-k graph coarsening (gPool); counterpart of
``gcnn_keras_tpu/layers/pool/topk.py`` (``PoolingTopK``, ``UnPoolingTopK``,
``AdjacencyPower``).

As in the JAX package the shapes stay fixed: a pooled node stays as a
zeroed slot and its edges are gated, where kgcnn shrinks the graph. The
selection on the flat batch counts each graph's current nodes with an
integer ``segment_sum`` and ranks each node among the valid nodes of its
own graph.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ...batch import GraphBatch
from ...ops.segment import segment_sum
from ..casting import dense_adjacency
from ..mlp import glorot_uniform_

Tensor = torch.Tensor


class PoolingTopK(nn.Module):
    """gPool over ``in_features`` wide nodes: the score ``n . p / ||p||``
    (``p`` the ``score_kernel`` (1, in_features), glorot-uniform, or ones
    with ``kernel_initializer="ones"``); of each graph's ``n`` current
    nodes the ``round(k n)`` lowest scores are removed (round half to even,
    ties by node index), the survivors gated by ``sigmoid(score)``.
    ``mask`` restricts the current nodes (stacked pooling). Returns
    ``(gated nodes, keep mask, scores)``."""

    def __init__(self, in_features: int, k: float = 0.1, kernel_initializer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        p = torch.ones(1, in_features) if kernel_initializer == "ones" \
            else glorot_uniform_(torch.empty(1, in_features), generator)
        self.score_kernel = nn.Parameter(p)

    def forward(self, batch: GraphBatch, nodes: Tensor,
                mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
        p = self.score_kernel
        score = (nodes @ p[0]) / torch.sqrt((p * p).sum()).clamp_min(1e-12)
        valid = batch.node_mask if mask is None else (mask & batch.node_mask)
        num_nodes = segment_sum(valid.to(torch.int32), batch.graph_id, batch.n_graphs,
                                indices_are_sorted=True)
        n_remove = torch.round(self.k * num_nodes)
        big = torch.where(valid, score, torch.inf)
        same_graph = batch.graph_id[:, None] == batch.graph_id[None, :]
        idx = torch.arange(score.shape[0], device=score.device)
        lower = (big[None, :] < big[:, None]) | (
            (big[None, :] == big[:, None]) & (idx[None, :] < idx[:, None]))
        rank = (lower & same_graph & valid[None, :]).sum(1)
        keep = (rank >= n_remove[batch.graph_id.long()]) & valid
        gated = nodes * torch.sigmoid(score)[:, None] * keep[:, None].to(nodes.dtype)
        return gated, keep, score


class UnPoolingTopK(nn.Module):
    """The pooled features back in the kept slots, the original features
    elsewhere."""

    def forward(self, original_nodes: Tensor, pooled_nodes: Tensor,
                keep_mask: Tensor) -> Tensor:
        m = keep_mask[:, None].to(original_nodes.dtype)
        return pooled_nodes * m + original_nodes * (1 - m)


class AdjacencyPower(nn.Module):
    """The ``n``-th power of each graph's dense adjacency (column 0 of the
    edge weights summed into ``(G, M, M)``), read back at the edges:
    ``(E, 1)``."""

    def __init__(self, n: int = 2):
        super().__init__()
        self.n = n

    def forward(self, batch: GraphBatch, edge_weights: Tensor) -> Tensor:
        M = max(batch.max_nodes, 1)
        w = edge_weights.reshape(edge_weights.shape[0], -1)[:, 0]
        adj = dense_adjacency(batch, w, M)
        out = adj
        for _ in range(self.n - 1):
            out = torch.matmul(out, adj)
        ri = batch.node_loc[batch.receivers].clamp_max(M - 1).long()
        si = batch.node_loc[batch.senders].clamp_max(M - 1).long()
        return out[batch.edge_graph_id.long(), ri, si][:, None]
