"""Test doubles for explanation code; counterpart of
``gcnn_keras_tpu/xai/testing.py`` (kgcnn's ``MockMegan`` and
``VgdMockDataset``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..data.dataset import MemoryGraphDataset
from ..ops.segment import segment_sum


class MockImportanceModel(nn.Module):
    """A stand-in for an explainable model with no weights: each node's
    importance in every channel is its in-degree over the batch's largest
    (at least 1), each edge's is its mask, and the output is zeros ``(G,
    1)``, so explanation pipelines can be tested without training."""

    def __init__(self, importance_channels: int = 2):
        super().__init__()
        self.k = importance_channels

    def forward(self, batch: GraphBatch, **kwargs):
        ones = batch.edge_mask.to(torch.float32)
        # a batch with a sender perm has its receivers sorted: the sorted
        # sum; else index_add_, as the JAX model takes XLA's scatter-add
        deg = segment_sum(ones, batch.receivers, batch.n_node,
                          indices_are_sorted=batch.edges.get("sender_perm") is not None)
        node_imp = torch.stack([deg / deg.max().clamp_min(1.0)] * self.k, dim=1)
        edge_imp = torch.stack([ones] * self.k, dim=1)
        return {"output": torch.zeros((batch.n_graphs, 1), device=ones.device),
                "node_importances": node_imp, "edge_importances": edge_imp}


class VgdMockDataset(MemoryGraphDataset):
    """Random graphs with ground-truth importance masks: 5-11 nodes, each
    with up to two random undirected edges, 8 float node attributes, the
    nodes drawn above 0.7 as the "important" motif and their count as the
    graph label; the same draws as the JAX package's for a seed."""

    def __init__(self, num_graphs: int = 16, seed: int = 0, **kwargs):
        super().__init__(dataset_name="VgdMock", **kwargs)
        rs = np.random.RandomState(seed)
        for _ in range(num_graphs):
            n = rs.randint(5, 12)
            ei = []
            for i in range(n):
                for _ in range(2):
                    j = rs.randint(n)
                    if j != i:
                        ei.append([i, j])
                        ei.append([j, i])
            ei = np.unique(np.array(ei, dtype=np.int64), axis=0)
            motif = rs.rand(n) > 0.7
            self.append({
                "node_attributes": rs.randn(n, 8).astype(np.float32),
                "node_number": rs.randint(1, 9, size=n),
                "edge_indices": ei,
                "node_importances_true": motif.astype(np.float32),
                "graph_labels": np.array([float(motif.sum())], dtype=np.float32),
            })
