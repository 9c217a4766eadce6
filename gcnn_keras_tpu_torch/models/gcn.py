"""GCN models; counterpart of ``gcnn_keras_tpu/models/gcn.py`` (``GCN``,
``GCNWeighted``).

Inputs in the batch: ``nodes['node_attributes']`` (float features) or
integer ``nodes['node_number']``, and ``edges['edge_weights']``, normalized
when the graph is preprocessed. The features are mapped to the GCN width
(``embed_to_units``), run through ``depth`` ``GCNConv`` layers and read out
by the output head.

``in_features`` is the width of float node features: a torch ``Dense``
needs it when it is built, where flax reads it from the first batch. With
it the model holds no embedding table (the JAX ``OptionalInputEmbedding``
creates none for float input); ``None`` means integer node numbers and an
embedding table.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.gcn import GCNConv
from ..layers.mlp import MLP, Dense
from ..utils.devices import DeviceLike, resolve_device
from .common import GraphOutputHead, embed_input, input_embedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64}},
    gcn_args={"units": 100, "activation": "relu", "pooling_method": "sum"},
    depth=3,
    # the reference's graph readout is PoolingNodes(), whose default is mean
    node_pooling_args={"pooling_method": "mean"},
    output_embedding="graph",
    output_mlp={"units": [140, 70, 1], "activation": ["relu", "relu", "linear"]},
    node_key="node_attributes",
    edge_weight_key="edge_weights",
    in_features=None,
)

model_default_weighted = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64}},
    gcn_args={"units": 100, "activation": "relu", "pooling_method": "sum"},
    depth=3,
    output_embedding="graph",
    output_mlp={"units": [25, 10, 1], "activation": ["relu", "relu", "sigmoid"]},
    node_key="node_attributes",
    edge_weight_key="edge_weights",
    node_weight_key="node_weights",
    in_features=None,
)


class _GCNStack(nn.Module):
    """The embedding (integer input only), ``embed_to_units`` and the
    ``gcn_i`` layers that both GCN models share."""

    def _build_stack(self, cfg: Dict[str, Any], generator: Optional[torch.Generator]) -> None:
        self.config = cfg
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        units = cfg["gcn_args"]["units"]
        self.embed_to_units = Dense(width, units, generator=generator)
        for i in range(cfg["depth"]):
            self.add_module(f"gcn_{i}", GCNConv(units, **cfg["gcn_args"],
                                                generator=generator))

    def _node_features(self, batch: GraphBatch) -> Tensor:
        cfg = self.config
        x = batch.nodes.get(cfg["node_key"], batch.nodes.get("node_number"))
        h = embed_input(x, self.embedding, cfg["in_features"])
        ew = batch.edges[cfg["edge_weight_key"]]
        if ew.dim() == 1:
            ew = ew[:, None]
        h = self.embed_to_units(h)
        for i in range(cfg["depth"]):
            h = getattr(self, f"gcn_{i}")(batch, h, ew)
        return h


class GCN(_GCNStack):
    def __init__(self, config: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._build_stack(config, generator)
        out = config["output_mlp"]
        self.output = GraphOutputHead(
            config["gcn_args"]["units"], units=out["units"], activation=out["activation"],
            use_bias=out.get("use_bias", True),
            pooling_method=config.get("node_pooling_args", {}).get("pooling_method", "mean"),
            output_embedding=config["output_embedding"],
            # the reference pools the nodes first, then applies the output MLP
            pool_first=True, generator=generator)

    def forward(self, batch: GraphBatch) -> Dict[str, Tensor]:
        return {"output": self.output(batch, self._node_features(batch))}


class GCNWeighted(_GCNStack):
    """The same stack; the graph readout is the mean over each graph of the
    node features times ``nodes['node_weights']``, then the MLP
    (``output``)."""

    def __init__(self, config: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {config['output_embedding']}")
        self._build_stack(config, generator)
        out = config["output_mlp"]
        self.output = MLP(config["gcn_args"]["units"], out["units"],
                          activation=out["activation"], use_bias=out.get("use_bias", True),
                          generator=generator)

    def forward(self, batch: GraphBatch) -> Dict[str, Tensor]:
        h = self._node_features(batch)
        if self.config["output_embedding"] == "graph":
            nw = batch.nodes[self.config["node_weight_key"]]
            if nw.dim() == 1:
                nw = nw[:, None]
            # padding nodes live in the last graph slot: no mask needed
            h = pool_nodes_to_graph(batch, h * nw, pooling_method="mean")
        return {"output": self.output(h)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> GCN:
    """GCN with the JAX package's defaults updated by ``kwargs`` (and
    ``in_features``, the width of float node features), on ``device`` (the
    CUDA card unless ``device="cpu"``). Weights are drawn from ``generator``
    (a CPU ``torch.Generator``; seed 0 if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return GCN(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)


def make_model_weighted(device: DeviceLike = None,
                        generator: Optional[torch.Generator] = None,
                        **kwargs) -> GCNWeighted:
    """:class:`GCNWeighted`, as :func:`make_model` builds :class:`GCN`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return GCNWeighted(update_model_kwargs(model_default_weighted, kwargs),
                       generator=generator).to(dev)
