"""The message-passing template; counterpart of
``gcnn_keras_tpu/layers/message.py`` (kgcnn's ``MessagePassingBase``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from .aggr import gather_nodes, pool_edges_to_nodes

Tensor = torch.Tensor


class MessagePassing(nn.Module):
    """Gather both ends' features, ``message_function``, aggregate onto the
    receivers by ``pooling_method`` (a sum: the sorted segment-sum kernel),
    ``update_nodes``. Subclass it and override the two functions."""

    def __init__(self, pooling_method: str = "sum"):
        super().__init__()
        self.pooling_method = pooling_method

    def message_function(self, x_i: Tensor, x_j: Tensor,
                         edge_attr: Optional[Tensor]) -> Tensor:
        raise NotImplementedError

    def update_nodes(self, nodes: Tensor, aggregated: Tensor) -> Tensor:
        raise NotImplementedError

    def forward(self, batch: GraphBatch, nodes: Tensor,
                edge_attr: Optional[Tensor] = None) -> Tensor:
        x_i = gather_nodes(nodes, batch.receivers)
        x_j = gather_nodes(nodes, batch.senders)
        msg = self.message_function(x_i, x_j, edge_attr)
        agg = pool_edges_to_nodes(batch, msg, mode=self.pooling_method)
        return self.update_nodes(nodes, agg)
