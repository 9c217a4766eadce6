"""Shared model-building blocks; counterpart of
``gcnn_keras_tpu/models/common.py`` (``OptionalInputEmbedding`` and
``GraphOutputHead``)."""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.mlp import MLP

Tensor = torch.Tensor


class OptionalInputEmbedding(nn.Module):
    """Embedding lookup iff the input has no feature dimension: integer
    ``(N,)`` -> ``(N, output_dim)``; a float ``(N, F)`` passes through.
    The table starts as U(-0.05, 0.05), the keras default."""

    def __init__(self, input_dim: int = 95, output_dim: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(nn.init.uniform_(
            torch.empty(input_dim, output_dim), -0.05, 0.05, generator=generator))

    def forward(self, x: Tensor) -> Tensor:
        if not x.is_floating_point() and x.dim() == 1:
            return F.embedding(x, self.weight)
        return x


class GraphOutputHead(nn.Module):
    """The output MLP (``output_mlp``) with the reference's
    ``output_embedding`` switch: per node (``"node"``), or per graph
    (``"graph"``): the nodes pooled by ``pooling_method`` before the MLP
    (``pool_first``), or the MLP per node, masked, then pooled."""

    def __init__(self, in_features: int, units: Union[int, Sequence[int]] = (64, 1),
                 activation: Any = ("relu", "linear"), output_embedding: str = "graph",
                 pooling_method: str = "sum", pool_first: bool = False,
                 use_bias: Any = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if output_embedding not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {output_embedding}")
        units = list(units) if isinstance(units, (list, tuple)) else [units]
        if not isinstance(activation, (list, tuple)):
            activation = [activation] * len(units)
        self.output_embedding = output_embedding
        self.pooling_method = pooling_method
        self.pool_first = pool_first
        self.output_mlp = MLP(in_features, units, activation=list(activation),
                              use_bias=use_bias, generator=generator)

    def forward(self, batch: GraphBatch, nodes: Tensor) -> Tensor:
        if self.output_embedding == "node":
            return self.output_mlp(nodes)
        if self.pool_first:
            return self.output_mlp(pool_nodes_to_graph(batch, nodes, mode=self.pooling_method))
        out = self.output_mlp(nodes) * batch.node_mask[:, None].to(nodes.dtype)
        return pool_nodes_to_graph(batch, out, mode=self.pooling_method)
