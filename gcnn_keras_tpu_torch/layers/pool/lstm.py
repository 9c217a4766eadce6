"""The LSTM neighbour pooling (GraphSAGE's LSTM aggregator); counterpart of
``gcnn_keras_tpu/layers/pool/lstm.py`` (``PoolingLocalEdgesLSTM``).

Each receiver's edge messages go into a fixed ``(N, max_neighbors, F)``
neighbour matrix at their ``edge_slot`` (the batch's rank of an edge among
its receiver's, ``batch_graphs(sort_edges_by_receiver=True)``), then a
masked LSTM runs over the neighbour axis: flax's ``OptimizedLSTMCell``, its
gates i, f, g, o from the input Denses ``ii``, ``if``, ``ig``, ``io``
(``kernel`` (F, units), no bias) and the recurrent ``hi``, ``hf``, ``hg``,
``ho`` (``kernel`` (units, units) and ``bias``), under ``lstm/cell``; a
step leaves a node's carry as it was where its slot is empty. The result is
the final hidden state ``(N, units)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...batch import GraphBatch
from ..mlp import FlaxDense

Tensor = torch.Tensor

_GATES = ("i", "f", "g", "o")


class PoolingLocalEdgesLSTM(nn.Module):
    def __init__(self, in_features: int, units: int, max_neighbors: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.units = units
        self.max_neighbors = max_neighbors
        cell = nn.Module()
        # flax's initializers: lecun-normal input kernels, orthogonal recurrent ones
        for gate in _GATES:
            cell.add_module(f"i{gate}", FlaxDense.lecun(in_features, units, False, generator))
        for gate in _GATES:
            cell.add_module(f"h{gate}", FlaxDense(nn.init.orthogonal_(
                torch.empty(units, units), generator=generator), True))
        self.lstm = nn.Module()
        self.lstm.cell = cell

    def forward(self, batch: GraphBatch, edge_values: Tensor) -> Tensor:
        slot = batch.edges.get("edge_slot")
        if slot is None:
            raise ValueError("PoolingLocalEdgesLSTM needs the batch's edge_slot "
                             "(batch_graphs with sort_edges_by_receiver=True)")
        K = self.max_neighbors
        slot = slot.clamp_max(K - 1).long()
        N, F = batch.n_node, edge_values.shape[-1]
        rec = batch.receivers.long()
        nbr = edge_values.new_zeros((N, K, F)).index_put_(
            (rec, slot), edge_values * batch.edge_mask[:, None].to(edge_values.dtype))
        valid = torch.zeros((N, K), dtype=torch.bool, device=edge_values.device).index_put_(
            (rec, slot), batch.edge_mask.bool())
        cell = self.lstm.cell
        gates_i = [getattr(cell, f"i{g}") for g in _GATES]
        gates_h = [getattr(cell, f"h{g}") for g in _GATES]
        c = h = edge_values.new_zeros((N, self.units))
        for step in range(K):
            x, m = nbr[:, step], valid[:, step, None]
            i, f, g, o = (gi(x) + gh(h) for gi, gh in zip(gates_i, gates_h))
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            c, h = torch.where(m, c_new, c), torch.where(m, h_new, h)
        return h
