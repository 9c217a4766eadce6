"""DMPNN, the directed message passing network; counterpart of
``gcnn_keras_tpu/models/dmpnn.py``.

Messages live on directed edges: ``h0 = edge_init([n_j || e_ij])`` for the
edge j -> i, then ``depth`` rounds of ``h = act(edge_dense_shared(m) +
h0)`` with ``m_ij`` the sum of the messages into j less the message of the
reverse edge i -> j (``edge_pair_index``); the messages summed onto each
node, concatenated with its features, go through ``node_dense``; then the
output MLP, on the nodes summed per graph for ``output_embedding="graph"``.
Every sum onto the nodes or graphs is the sorted segment-sum kernel; the
gathers are plain.

The batch needs ``batch_graphs(compute_reverse_edges=True)``: without
``edge_pair_index`` the model raises ``ValueError`` (JAX: an assert).
Inputs and widths at build as ``models/sage.py``: ``in_features`` (None:
integer node numbers), ``edge_in_features`` (None: integer
``edge_attributes``, embedded by ``input_embedding["edge"]``; a width:
float ones; 0: batches without them, one zero per edge, as in JAX).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import gather_nodes, pool_edges_to_nodes, pool_nodes_to_graph
from ..layers.mlp import MLP, Dense
from ..ops.activ import get_activation
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 5, "output_dim": 64}},
    pooling_args={"pooling_method": "sum"},
    edge_initialize={"units": 128, "use_bias": True, "activation": "relu"},
    edge_dense={"units": 128, "use_bias": True, "activation": "linear"},
    edge_activation={"activation": "relu"},
    node_dense={"units": 128, "use_bias": True, "activation": "relu"},
    depth=5,
    dropout=None,
    output_embedding="graph",
    output_mlp={"units": [64, 1], "activation": ["relu", "linear"]},
    in_features=None,
    edge_in_features=None,
)


def reverse_edges(batch: GraphBatch, model: str) -> Tensor:
    """The batch's ``edge_pair_index``, or ``ValueError`` naming how to
    build it."""
    pair = batch.edges.get("edge_pair_index")
    if pair is None:
        raise ValueError(f"{model} needs batch_graphs(compute_reverse_edges=True): the "
                         "batch has no edge_pair_index")
    return pair


class DMPNN(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        self.edge_embedding, e_width = input_embedding(
            cfg["input_embedding"].get("edge", {"input_dim": 5, "output_dim": 64}),
            cfg["edge_in_features"], generator)
        units = cfg["edge_initialize"]["units"]
        # the JAX Denses take units and activation only (a bias each)
        self.edge_init = Dense(width + (e_width or 1), units,
                               activation=cfg["edge_initialize"]["activation"],
                               generator=generator)
        self.edge_dense_shared = Dense(units, cfg["edge_dense"]["units"],
                                       activation=cfg["edge_dense"]["activation"],
                                       generator=generator)
        self._act = get_activation(cfg["edge_activation"]["activation"])
        self.node_dense = Dense(cfg["edge_dense"]["units"] + width, cfg["node_dense"]["units"],
                                activation=cfg["node_dense"]["activation"], generator=generator)
        self.out_mlp = MLP(cfg["node_dense"]["units"], cfg["output_mlp"]["units"],
                           activation=cfg["output_mlp"]["activation"], generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        pair = reverse_edges(batch, "DMPNN").long()
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = embed_input(x, self.embedding, cfg["in_features"])
        ed = edge_input(batch, self.edge_embedding, cfg["edge_in_features"])
        if ed is None:
            ed = n.new_zeros(batch.n_edge, 1)
        h0 = self.edge_init(torch.cat([gather_nodes(n, batch.senders), ed], dim=-1))
        h = h0
        for _ in range(cfg["depth"]):
            # into each directed edge j -> i: the messages into j, less i -> j's
            pooled = pool_edges_to_nodes(batch, h, **cfg["pooling_args"])
            m = gather_nodes(pooled, batch.senders) - h.index_select(0, pair)
            h = self._act(self.edge_dense_shared(m) + h0)
        mv = pool_edges_to_nodes(batch, h, **cfg["pooling_args"])
        hv = self.node_dense(torch.cat([mv, n], dim=-1))
        if cfg["output_embedding"] == "graph":
            hv = pool_nodes_to_graph(batch, hv * batch.node_mask[:, None].to(hv.dtype))
        return {"output": self.out_mlp(hv)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> DMPNN:
    """DMPNN with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return DMPNN(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
