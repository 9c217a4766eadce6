"""AttentiveFP; counterpart of ``gcnn_keras_tpu/models/attentivefp.py``
(with its layers ``AttentiveHeadFP`` and ``PoolingNodesAttentive``).

``node_in`` takes the nodes to ``attention_args["units"]``; ``depthato``
rounds of an attention head (the first reads the edge features too) and a
keras GRU cell (``gru_i``); for ``output_embedding="graph"`` the attentive
readout ``pool_attentive``, then the output MLP. Every attention sum, onto
the nodes and onto the graphs, and the readout's first sum pool, is the
sorted segment-sum kernel; the gathers are plain.

Dropout (``dropout``, 0.2) acts after each GRU round past the first under
``train=True`` only. Its masks are drawn from a ``torch.Generator`` (the
call's ``generator``, else the model's own, seeded with 0 on the inputs'
device), so they are not the JAX package's masks: only
``train=False`` (the default) matches the JAX model.

Inputs and widths at build as ``models/sage.py``: ``in_features`` (None:
integer node numbers), ``edge_in_features`` (None: integer
``edge_attributes``, embedded by ``input_embedding["edge"]``; a width:
float ones). The first head reads the edge features, so 0 raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..batch import GraphBatch
from ..layers.aggr import (gather_nodes, gather_state, pool_edges_to_nodes_attention,
                           pool_nodes_to_graph, pool_nodes_to_graph_attention)
from ..layers.conv.basic import KerasGRUCellUpdate
from ..layers.mlp import MLP, Dense
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 5, "output_dim": 64}},
    attention_args={"units": 200},
    depthato=2, depthmol=2,
    dropout=0.2,
    output_embedding="graph",
    output_mlp={"units": [200, 1], "activation": ["kgcnn>leaky_relu", "linear"]},
    in_features=None,
    edge_in_features=None,
)


class AttentiveHeadFP(nn.Module):
    """The attention head over each node's incoming edges: with
    ``use_edge_features`` ``n_in = fc1(h_i)`` and ``n_out = fc2([h_j ||
    e_ij])`` (leaky relu each), else ``h_i`` and ``h_j``; then
    ``a_ij = alpha(alpha_activation([n_in || n_out]))``, the softmax of
    ``a`` over each receiver's edges weighting ``linear_trafo(n_out)``,
    summed onto the receiver, through elu."""

    def __init__(self, in_features: int, units: int, use_edge_features: bool = False,
                 edge_features: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_edge_features = use_edge_features
        if use_edge_features:
            self.fc1 = Dense(in_features, units, activation="kgcnn>leaky_relu",
                             generator=generator)
            self.fc2 = Dense(in_features + edge_features, units,
                             activation="kgcnn>leaky_relu", generator=generator)
            in_features = units
        self.linear_trafo = Dense(in_features, units, generator=generator)
        self.alpha_activation = Dense(2 * in_features, units, activation="kgcnn>leaky_relu",
                                      generator=generator)
        self.alpha = Dense(units, 1, use_bias=False, generator=generator)

    def forward(self, batch: GraphBatch, nodes: Tensor,
                edges: Optional[Tensor] = None) -> Tensor:
        n_in = gather_nodes(nodes, batch.receivers)
        n_out = gather_nodes(nodes, batch.senders)
        if self.use_edge_features:
            n_in = self.fc1(n_in)
            n_out = self.fc2(torch.cat([n_out, edges], dim=-1))
        a_ij = self.alpha(self.alpha_activation(torch.cat([n_in, n_out], dim=-1)))
        return F.elu(pool_edges_to_nodes_attention(batch, self.linear_trafo(n_out), a_ij))


class PoolingNodesAttentive(nn.Module):
    """The attentive graph readout: the sum pool of the nodes, then ``depth``
    keras GRU steps (``gru``) on elu of the softmax-weighted pool of
    ``linear_trafo(n)``, with logits ``alpha([state || n])`` over each
    graph's real nodes."""

    def __init__(self, in_features: int, units: int, depth: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        self.linear_trafo = Dense(in_features, units, generator=generator)
        self.alpha = Dense(units + in_features, 1, activation="kgcnn>leaky_relu",
                           generator=generator)
        self.gru = KerasGRUCellUpdate(units, units, generator=generator)

    def forward(self, batch: GraphBatch, nodes: Tensor) -> Tensor:
        h = pool_nodes_to_graph(batch, nodes)
        wn = self.linear_trafo(nodes)
        for _ in range(self.depth):
            av = self.alpha(torch.cat([gather_state(h, batch), nodes], dim=-1))
            h = self.gru(h, F.elu(pool_nodes_to_graph_attention(batch, wn, av)))
        return h


class AttentiveFP(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        if cfg["edge_in_features"] == 0:
            raise ValueError("AttentiveFP's first head reads edge_attributes: give their "
                             "width (edge_in_features; None for integer classes)")
        units = cfg["attention_args"]["units"]
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        self.edge_embedding, e_width = input_embedding(
            cfg["input_embedding"].get("edge", {"input_dim": 5, "output_dim": 64}),
            cfg["edge_in_features"], generator)
        self.node_in = Dense(width, units, generator=generator)
        for i in range(cfg["depthato"]):
            self.add_module(f"head_{i}", AttentiveHeadFP(
                units, units, use_edge_features=i == 0, edge_features=e_width,
                generator=generator))
            self.add_module(f"gru_{i}", KerasGRUCellUpdate(units, units, generator=generator))
        if cfg["output_embedding"] == "graph":
            self.pool_attentive = PoolingNodesAttentive(units, units, depth=cfg["depthmol"],
                                                        generator=generator)
        self.out_mlp = MLP(units, cfg["output_mlp"]["units"],
                           activation=cfg["output_mlp"]["activation"], generator=generator)
        self._generators: Dict[str, torch.Generator] = {}

    def _dropout(self, x: Tensor, generator: Optional[torch.Generator]) -> Tensor:
        rate = self.config["dropout"]
        if generator is None:
            key = str(x.device)
            if key not in self._generators:
                self._generators[key] = torch.Generator(device=x.device).manual_seed(0)
            generator = self._generators[key]
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def forward(self, batch: GraphBatch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = embed_input(x, self.embedding, cfg["in_features"])
        ed = edge_input(batch, self.edge_embedding, cfg["edge_in_features"])
        nk = self.node_in(n)
        for i in range(cfg["depthato"]):
            ck = getattr(self, f"head_{i}")(batch, nk, ed if i == 0 else None)
            nk = getattr(self, f"gru_{i}")(nk, ck)
            if i > 0 and train and cfg.get("dropout"):
                nk = self._dropout(nk, generator)
        if cfg["output_embedding"] == "graph":
            # padding nodes carry zero features into the masked readout
            nk = self.pool_attentive(batch, nk * batch.node_mask[:, None].to(nk.dtype))
        return {"output": self.out_mlp(nk)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> AttentiveFP:
    """AttentiveFP with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return AttentiveFP(update_model_kwargs(model_default, kwargs),
                       generator=generator).to(dev)
