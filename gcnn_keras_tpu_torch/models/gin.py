"""GIN; counterpart of ``gcnn_keras_tpu/models/gin.py`` (``make_model``,
``make_model_edge``).

``depth`` GIN convolutions (GINE with edge features), each followed by its
``gin_mlp_i``, a dense -> ``GraphBatchNorm`` -> activation stack by
default. The graph readout mean-pools every layer's node embedding (the
input's too), runs each through its own ``out_mlp_i`` and sums them before
the ``final`` MLP.

Inputs: ``nodes['node_attributes']`` or ``nodes['node_number']``, embedded
where they are integers; ``make_model_edge`` also takes float
``edges['edge_attributes']``. A torch module needs its input widths when it
is built: ``in_features`` is the width of float node features (None:
integer node numbers and an embedding table), ``edge_in_features`` that of
the edge features (0: batches without them, as the JAX model then runs
GIN). ``train`` goes to each ``GraphBatchNorm`` (batch statistics and
running averages updated) and to dropout.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.basic import GIN as GINConv
from ..layers.conv.basic import GINE as GINEConv
from ..layers.mlp import MLP, Dense
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding, mlp_width
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64}},
    depth=3,
    dropout=0.0,
    gin_args={"pooling_method": "sum", "epsilon_learnable": False},
    # dense -> graph-batch-norm -> activation per layer
    gin_mlp={"units": [64, 64], "activation": ["relu", "linear"],
             "use_normalization": True, "normalization_technique": "graph_batch"},
    last_mlp={"units": [64, 64, 64], "activation": ["relu", "relu", "linear"]},
    output_embedding="graph",
    output_mlp={"units": [1], "activation": ["linear"]},
    node_pooling_args={"pooling_method": "mean"},
    in_features=None,
    edge_in_features=0,
)


class GINModel(nn.Module):
    def __init__(self, config: Dict[str, Any], use_edges: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        self.use_edges = use_edges and cfg["edge_in_features"] != 0
        if self.use_edges and cfg["edge_in_features"] is None:
            raise ValueError("make_model_edge takes float edge_attributes: give their "
                             "width (edge_in_features)")
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        n_units = mlp_width(cfg["gin_mlp"]["units"])
        self.embed_to_units = Dense(width, n_units, generator=generator)
        if self.use_edges:
            self.edge_to_units = Dense(cfg["edge_in_features"], n_units, generator=generator)
        mlp = cfg["gin_mlp"]
        for i in range(cfg["depth"]):
            conv = GINEConv(**cfg["gin_args"]) if self.use_edges else GINConv(**cfg["gin_args"])
            self.add_module(f"gine_{i}" if self.use_edges else f"gin_{i}", conv)
            self.add_module(f"gin_mlp_{i}", MLP(
                n_units, mlp["units"], activation=mlp["activation"],
                use_normalization=mlp.get("use_normalization", False),
                normalization_technique=mlp.get("normalization_technique", "graph_batch"),
                generator=generator))
        last, out = cfg["last_mlp"], cfg["output_mlp"]
        if cfg["output_embedding"] == "graph":
            for i in range(cfg["depth"] + 1):
                self.add_module(f"out_mlp_{i}", MLP(n_units, last["units"],
                                                    activation=last["activation"],
                                                    generator=generator))
        else:
            self.last_mlp_node = MLP(n_units, last["units"], activation=last["activation"],
                                     generator=generator)
        self.final = MLP(mlp_width(last["units"]), out["units"], activation=out["activation"],
                         generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        h = self.embed_to_units(embed_input(x, self.embedding, cfg["in_features"]))
        if self.use_edges:
            ed = self.edge_to_units(edge_input(batch, None, cfg["edge_in_features"]))
        embeddings = [h]
        for i in range(cfg["depth"]):
            if self.use_edges:
                h = getattr(self, f"gine_{i}")(batch, h, ed)
            else:
                h = getattr(self, f"gin_{i}")(batch, h)
            h = getattr(self, f"gin_mlp_{i}")(h, mask=batch.node_mask, train=train)
            embeddings.append(h)
        if cfg["output_embedding"] == "graph":
            pool_mode = cfg.get("node_pooling_args", {}).get("pooling_method", "mean")
            mask = batch.node_mask[:, None]
            out = 0
            for i, e in enumerate(embeddings):
                p = pool_nodes_to_graph(batch, e * mask.to(e.dtype), mode=pool_mode)
                p = getattr(self, f"out_mlp_{i}")(p)
                if cfg.get("dropout"):
                    p = F.dropout(p, cfg["dropout"], training=train)
                out = out + p
        else:
            out = self.last_mlp_node(h)
        return {"output": self.final(out)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> GINModel:
    """GIN with the JAX package's defaults updated by ``kwargs`` (with
    ``in_features``, see the module docstring), on ``device`` (the CUDA card
    unless ``device="cpu"``); weights from ``generator`` (a CPU
    ``torch.Generator``; seed 0 if None)."""
    return _build(kwargs, False, device, generator)


def make_model_edge(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
                    **kwargs) -> GINModel:
    """GIN with GINE convolutions over float edge features of width
    ``edge_in_features``, as :func:`make_model` builds GIN."""
    return _build(kwargs, True, device, generator)


def _build(kwargs, use_edges, device, generator) -> GINModel:
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return GINModel(update_model_kwargs(model_default, kwargs), use_edges=use_edges,
                    generator=generator).to(dev)
