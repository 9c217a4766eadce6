"""GCN convolution; counterpart of ``gcnn_keras_tpu/layers/conv/gcn.py``.

``h_i' = act(sum_j w_ij (W h_j))`` with edge weights normalized when the
graph is preprocessed (``graph/preprocess.py``
``normalize_edge_weights_symmetric``). The weighted sum onto the receivers
is the sorted segment-sum, and the sender gather has it as its transpose.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ...batch import GraphBatch
from ...ops.activ import get_activation
from ..aggr import gather_sender_nodes, pool_weighted_edges_to_nodes
from ..mlp import Dense

Tensor = torch.Tensor


class GCNConv(nn.Module):
    """The flax module's Dense is unnamed (``Dense_0``); so is the port's."""

    def __init__(self, in_features: int, units: int, activation: Any = "relu",
                 use_bias: bool = True, pooling_method: str = "sum",
                 normalize_by_weights: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pooling_method = pooling_method
        self.normalize_by_weights = normalize_by_weights
        self.Dense_0 = Dense(in_features, units, use_bias=use_bias, generator=generator)
        self._act = get_activation(activation)

    def forward(self, batch: GraphBatch, nodes: Tensor, edge_weights: Tensor) -> Tensor:
        hj = gather_sender_nodes(batch, self.Dense_0(nodes))
        return self._act(pool_weighted_edges_to_nodes(
            batch, hj, edge_weights, mode=self.pooling_method,
            normalize=self.normalize_by_weights))
