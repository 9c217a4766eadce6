"""GraphSAGE; counterpart of ``gcnn_keras_tpu/models/sage.py``.

``depth`` layers of: the senders' features (with the edge features, where
``use_edge_features``) through ``edge_mlp_i``, pooled onto the receivers
(mean by default), concatenated with the node's own, through
``node_mlp_i`` and ``norm_i`` (a ``GraphLayerNorm``); then the output MLP,
on the nodes pooled per graph for ``output_embedding="graph"``.

Inputs and widths at build as ``models/gin.py``: ``in_features`` (None:
integer node numbers), ``edge_in_features`` (None: integer
``edge_attributes``, embedded by ``input_embedding["edge"]``; a width:
float ones; 0: batches without them).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import gather_nodes, pool_edges_to_nodes, pool_nodes_to_graph
from ..layers.mlp import MLP
from ..layers.norm import GraphLayerNorm
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding, mlp_width
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 5, "output_dim": 32}},
    node_mlp_args={"units": [64, 32], "activation": ["relu", "linear"]},
    edge_mlp_args={"units": 64, "activation": "relu"},
    pooling_args={"pooling_method": "mean"},
    pooling_nodes_args={"pooling_method": "mean"},
    gather_args={},
    concat_args={},
    use_edge_features=True,
    depth=3,
    output_embedding="graph",
    output_mlp={"units": [32, 16, 1], "activation": ["relu", "relu", "linear"]},
    in_features=None,
    edge_in_features=None,
)


class GraphSAGE(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        self.embedding, n_width = input_embedding(cfg["input_embedding"]["node"],
                                                  cfg["in_features"], generator)
        self.edge_embedding, e_width = input_embedding(
            cfg["input_embedding"].get("edge", {"input_dim": 5, "output_dim": 32}),
            cfg["edge_in_features"], generator)
        if not cfg["use_edge_features"]:
            e_width = 0
        edge, node, out = cfg["edge_mlp_args"], cfg["node_mlp_args"], cfg["output_mlp"]
        for i in range(cfg["depth"]):
            self.add_module(f"edge_mlp_{i}", MLP(n_width + e_width, edge["units"],
                                                 activation=edge["activation"],
                                                 generator=generator))
            self.add_module(f"node_mlp_{i}", MLP(n_width + mlp_width(edge["units"]),
                                                 node["units"], activation=node["activation"],
                                                 generator=generator))
            n_width = mlp_width(node["units"])
            self.add_module(f"norm_{i}", GraphLayerNorm(n_width))
        # the JAX model reads no use_bias here: every layer has one
        self.out_mlp = MLP(n_width, out["units"], activation=out["activation"],
                           generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = embed_input(x, self.embedding, cfg["in_features"])
        ed = edge_input(batch, self.edge_embedding, cfg["edge_in_features"])
        for i in range(cfg["depth"]):
            eu = gather_nodes(n, batch.senders)
            if cfg["use_edge_features"] and ed is not None:
                eu = torch.cat([eu, ed], dim=-1)
            eu = getattr(self, f"edge_mlp_{i}")(eu)
            nu = torch.cat([n, pool_edges_to_nodes(batch, eu, **cfg["pooling_args"])], dim=-1)
            n = getattr(self, f"norm_{i}")(getattr(self, f"node_mlp_{i}")(nu))
        if cfg["output_embedding"] == "graph":
            n = pool_nodes_to_graph(batch, n * batch.node_mask[:, None].to(n.dtype),
                                    **cfg["pooling_nodes_args"])
        return {"output": self.out_mlp(n)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> GraphSAGE:
    """GraphSAGE with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return GraphSAGE(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
