"""R-GCN; counterpart of ``gcnn_keras_tpu/models/rgcn.py``.

``depth`` relational GCN convolutions (``layers/conv/basic.py``
``RelationalGCNConv``) over ``edges['edge_relations']`` (all relation 0
where the batch has none), with ``edges['edge_weights']`` where given;
then the output MLP, on the nodes mean-pooled per graph for
``output_embedding="graph"``. The default 20 relations lie above
``RelationalDense``'s ``dense_relation_threshold`` (16), so each layer
multiplies the relations its edges hold one at a time, as the JAX package
does past it. ``in_features``: the width of float node features (None:
integer node numbers).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.basic import RelationalGCNConv
from ..layers.mlp import MLP
from ..utils.devices import DeviceLike, resolve_device
from .common import embed_input, input_embedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64}},
    dense_relation_kwargs={"units": 64, "num_relations": 20},
    dense_kwargs={"units": 64},
    activation_kwargs={"activation": "swish"},
    depth=5,
    output_embedding="graph",
    output_mlp={"units": [64, 1], "activation": ["relu", "linear"]},
    in_features=None,
)


def edge_relations(batch: GraphBatch) -> Tensor:
    """Each edge's relation: the first column of ``edges['edge_relations']``,
    or 0 for every edge where the batch has none."""
    rel = batch.edges.get("edge_relations")
    if rel is None:
        return torch.zeros(batch.n_edge, dtype=torch.int64, device=batch.receivers.device)
    return rel.reshape(batch.n_edge, -1)[:, 0].long()


def graph_readout(cfg: Dict[str, Any], batch: GraphBatch, n: Tensor) -> Tensor:
    """The nodes, masked and pooled per graph by ``node_pooling_args`` (mean
    by default), for ``output_embedding="graph"``; else the nodes."""
    if cfg["output_embedding"] != "graph":
        return n
    return pool_nodes_to_graph(batch, n * batch.node_mask[:, None].to(n.dtype),
                               **cfg.get("node_pooling_args", {"pooling_method": "mean"}))


class RGCN(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        rel = cfg["dense_relation_kwargs"]
        for i in range(cfg["depth"]):
            self.add_module(f"rgcn_{i}", RelationalGCNConv(
                width, rel["units"], rel["num_relations"],
                activation=cfg["activation_kwargs"]["activation"], generator=generator))
            width = rel["units"]
        out = cfg["output_mlp"]
        self.out_mlp = MLP(width, out["units"], activation=out["activation"],
                           generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = embed_input(x, self.embedding, cfg["in_features"])
        rel = edge_relations(batch)
        ew = batch.edges.get("edge_weights")
        for i in range(cfg["depth"]):
            n = getattr(self, f"rgcn_{i}")(batch, n, rel, ew)
        return {"output": self.out_mlp(graph_readout(cfg, batch, n))}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> RGCN:
    """R-GCN with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return RGCN(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
