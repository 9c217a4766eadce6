"""Shared model-building blocks; counterpart of
``gcnn_keras_tpu/models/common.py`` (``OptionalInputEmbedding`` and
``GraphOutputHead``), with the port's input widths at build
(``input_embedding``, ``embed_input``, ``edge_input``)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

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


# what an input is called when it is embedded, by kind
_INTEGER_INPUT = {"node": "integer node numbers", "edge": "integer edge attributes"}
_WIDTH_KEY = {"node": "in_features", "edge": "edge_in_features"}


def input_embedding(cfg: Dict[str, Any], in_features: Optional[int],
                    generator: Optional[torch.Generator]
                    ) -> Tuple[Optional[OptionalInputEmbedding], int]:
    """``(embedding, width)`` of one input: for integer input
    (``in_features`` None) the ``OptionalInputEmbedding`` of ``cfg`` and its
    ``output_dim``; for float features of width ``in_features`` no table
    (the JAX module creates none for float input) and that width; for an
    input the batches do not hold (``in_features`` 0) neither."""
    if in_features is None:
        return OptionalInputEmbedding(**cfg, generator=generator), cfg["output_dim"]
    return None, in_features


def mlp_width(units: Union[int, Sequence[int]]) -> int:
    """The output width of an MLP of ``units``."""
    return units[-1] if isinstance(units, (list, tuple)) else int(units)


def edge_input(batch: GraphBatch, embedding: Optional[OptionalInputEmbedding],
               edge_in_features: Optional[int]) -> Optional[Tensor]:
    """The batch's ``edge_attributes`` through :func:`embed_input`, or None
    where the model was built without them (``edge_in_features`` 0); raises
    ``ValueError`` where the batch and the build disagree on having them."""
    ed = batch.edges.get("edge_attributes")
    if (ed is None) != (edge_in_features == 0):
        raise ValueError(f"the model was built with edge_in_features={edge_in_features}, "
                         f"the batch has {'no ' if ed is None else ''}edge_attributes "
                         "(0 builds it for batches without them)")
    return None if ed is None else embed_input(ed, embedding, edge_in_features, "edge")


def embed_input(x: Tensor, embedding: Optional[OptionalInputEmbedding],
                in_features: Optional[int], kind: str = "node") -> Tensor:
    """``x`` through ``embedding``, or as it is where the model was built for
    float features (``embedding`` None); raises ``ValueError`` on input of
    the other kind or width, naming the build argument (``kind`` "node":
    ``in_features``, "edge": ``edge_in_features``)."""
    float_input = x.is_floating_point() or x.dim() != 1
    if embedding is None:
        if not float_input or x.shape[-1] != in_features:
            raise ValueError(f"the model was built for float {kind} features of width "
                             f"{in_features} ({_WIDTH_KEY[kind]}), got {x.dtype} "
                             f"{tuple(x.shape)}")
        return x
    if float_input:
        raise ValueError(f"the model was built for {_INTEGER_INPUT[kind]}; give make_model "
                         f"the feature width ({_WIDTH_KEY[kind]})")
    return embedding(x)


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
