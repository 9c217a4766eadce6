"""GAT and GATv2; counterpart of ``gcnn_keras_tpu/models/gat.py``
(``make_model``, ``make_model_v2``).

The node features are mapped to the attention width (``embed_to_units``),
then each of ``depth`` layers runs ``attention_heads_num`` heads
``head_{layer}_{k}`` (GAT or GATv2, with the edge features where
``attention_args["use_edge_features"]``), concatenated or averaged and
activated; then the output MLP, on the nodes mean-pooled per graph for
``output_embedding="graph"``. Each head's attention-weighted sum runs on
the sorted segment-sum kernel.

Inputs and widths at build as ``models/sage.py``: ``in_features`` (None:
integer node numbers), ``edge_in_features`` (None: integer
``edge_attributes``, embedded by ``input_embedding["edge"]``; a width:
float ones; 0: batches without them).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.basic import AttentionHeadGAT, AttentionHeadGATV2
from ..layers.mlp import MLP, Dense
from ..ops.activ import get_activation
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 5, "output_dim": 64}},
    attention_args={"units": 64, "use_edge_features": True, "use_bias": True,
                    "use_final_activation": False, "activation": "leaky_relu"},
    pooling_nodes_args={"pooling_method": "mean"},
    depth=1,
    attention_heads_num=5,
    attention_heads_concat=False,
    output_embedding="graph",
    output_mlp={"units": [64, 32, 1], "activation": ["relu", "relu", "sigmoid"]},
    in_features=None,
    edge_in_features=None,
)


class GATModel(nn.Module):
    def __init__(self, config: Dict[str, Any], v2: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        head = AttentionHeadGATV2 if v2 else AttentionHeadGAT
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        self.edge_embedding, e_width = input_embedding(
            cfg["input_embedding"].get("edge", {"input_dim": 5, "output_dim": 64}),
            cfg["edge_in_features"], generator)
        att = cfg["attention_args"]
        units, heads = att["units"], cfg["attention_heads_num"]
        self.embed_to_units = Dense(width, units, generator=generator)
        width = units
        for i in range(cfg["depth"]):
            for k in range(heads):
                self.add_module(f"head_{i}_{k}", head(width, edge_features=e_width,
                                                      generator=generator, **att))
            width = units * heads if cfg["attention_heads_concat"] else units
        self._act = get_activation(att.get("activation", "leaky_relu"))
        out = cfg["output_mlp"]
        self.out_mlp = MLP(width, out["units"], activation=out["activation"],
                           generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        h = self.embed_to_units(embed_input(x, self.embedding, cfg["in_features"]))
        ed = edge_input(batch, self.edge_embedding, cfg["edge_in_features"])
        heads = cfg["attention_heads_num"]
        for i in range(cfg["depth"]):
            out = [getattr(self, f"head_{i}_{k}")(batch, h, ed) for k in range(heads)]
            if cfg["attention_heads_concat"]:
                h = torch.cat(out, dim=-1)
            else:
                # averaged heads pass through the attention activation
                h = self._act(sum(out) / len(out))
        if cfg["output_embedding"] == "graph":
            h = pool_nodes_to_graph(batch, h * batch.node_mask[:, None].to(h.dtype),
                                    **cfg["pooling_nodes_args"])
        return {"output": self.out_mlp(h)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> GATModel:
    """GAT with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    return _build(kwargs, False, device, generator)


def make_model_v2(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
                  **kwargs) -> GATModel:
    """GATv2: the same scaffold with GATv2 heads."""
    return _build(kwargs, True, device, generator)


def _build(kwargs, v2, device, generator) -> GATModel:
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return GATModel(update_model_kwargs(model_default, kwargs), v2=v2,
                    generator=generator).to(dev)
