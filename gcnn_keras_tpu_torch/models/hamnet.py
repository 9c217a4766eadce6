"""HamNet; counterpart of ``gcnn_keras_tpu/models/hamnet.py`` (with its
layers ``HamNaiveDynMessage`` and ``HamNetFingerprintGenerator``).

The nodes and edges are embedded and go through ``node_init`` and
``edge_init`` (tanh). Positions ``q`` and momenta ``p``: with
``given_coordinates`` the batch's ``node_coordinates`` (zeros where it has
none) and zeros; without, ``q_net`` and ``p_net`` (tanh) of the embedded
nodes, the JAX package's extension. Each of ``depth`` rounds runs a
message layer ``message_i`` and unites its node and edge messages with the
states as ``union_type_node`` and ``union_type_edge`` say: ``"gru"`` a
keras GRU cell (``gru_union_i``, ``gru_union_e_i``), ``"naive"`` a tanh
Dense of the two concatenated (``union_i``, ``union_e_i``), anything else
the message alone. For ``output_embedding="graph"`` the fingerprint
generator reads the graphs out, then the output MLP (its ``use_bias``
list applies where it is as long as ``units``, else every layer has a
bias, as in JAX). The attention sums onto the nodes and graphs and the
fingerprint's mean pool are the sorted segment-sum kernel; the gathers are
plain.

Inputs and widths at build as ``models/sage.py``: ``in_features`` (None:
integer node numbers), ``edge_in_features`` (None: integer
``edge_attributes``, embedded by ``input_embedding["edge"]``; a width:
float ones); the message layers read the edges, so 0 raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..batch import GraphBatch
from ..layers.aggr import (gather_nodes, gather_state, pool_edges_to_nodes_attention,
                           pool_nodes_to_graph, pool_nodes_to_graph_attention)
from ..layers.conv.basic import KerasGRUCellUpdate
from ..layers.mlp import MLP, Dense
from ..ops.activ import get_activation
from ..utils.devices import DeviceLike, resolve_device
from .common import embed_input, input_embedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    name="HamNet",
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 5, "output_dim": 64}},
    message_kwargs={"units": 128, "units_edge": 128},
    fingerprint_kwargs={"units": 128, "units_attend": 128, "depth": 2},
    gru_kwargs={"units": 128},
    verbose=10, depth=1,
    union_type_node="gru",
    union_type_edge="None",
    given_coordinates=True,
    output_embedding="graph", output_to_tensor=True,
    output_mlp={"use_bias": [True, True, False], "units": [25, 10, 1],
                "activation": ["relu", "relu", "linear"]},
    in_features=None,
    edge_in_features=None,
)


class HamNaiveDynMessage(nn.Module):
    """The message of the receiver i from the sender j, with
    ``p_uv = p_j - p_i`` and ``q_uv = q_j - q_i``: the node message
    ``elu(sum_j softmax_i(dense_align([p_uv || q_uv || e_ij]))
    dense_attend(h_j))`` and the edge message ``dense_e([h_i || p_uv ||
    q_uv || h_j])``."""

    def __init__(self, node_features: int, edge_features: int, units: int = 128,
                 units_edge: int = 128, activation: Any = "kgcnn>leaky_relu",
                 activation_last: Any = "elu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_attend = Dense(node_features, units, activation=activation,
                                  generator=generator)
        self.dense_align = Dense(6 + edge_features, 1, generator=generator)
        self.dense_e = Dense(2 * node_features + 6, units_edge, activation=activation,
                             generator=generator)
        self._act_last = get_activation(activation_last)

    def forward(self, batch: GraphBatch, h: Tensor, e: Tensor, p: Tensor,
                q: Tensor) -> Tuple[Tensor, Tensor]:
        hi, hj = gather_nodes(h, batch.receivers), gather_nodes(h, batch.senders)
        p_uv = gather_nodes(p, batch.senders) - gather_nodes(p, batch.receivers)
        q_uv = gather_nodes(q, batch.senders) - gather_nodes(q, batch.receivers)
        align = self.dense_align(torch.cat([p_uv, q_uv, e], dim=-1))
        mv = self._act_last(pool_edges_to_nodes_attention(batch, self.dense_attend(hj), align))
        return mv, self.dense_e(torch.cat([hi, p_uv, q_uv, hj], dim=-1))


class HamNetFingerprintGenerator(nn.Module):
    """The graph readout: ``s = pool(vertex2mol(h))`` (``pooling_method``),
    then ``depth`` rounds of the attentive readout (``attend_t`` of the
    nodes weighted by the softmax of ``align_t([s || h])`` over each graph's
    real nodes, summed, through elu), a keras GRU cell ``gru_t`` and the
    activation."""

    def __init__(self, in_features: int, units: int = 128, units_attend: int = 128,
                 depth: int = 2, activation: Any = "kgcnn>leaky_relu",
                 pooling_method: str = "mean", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth, self.pooling_method = depth, pooling_method
        self._act = get_activation(activation)
        self.vertex2mol = Dense(in_features, units, activation=activation, generator=generator)
        for t in range(depth):
            self.add_module(f"attend_{t}", Dense(in_features, units_attend,
                                                 activation=activation, generator=generator))
            self.add_module(f"align_{t}", Dense(units + in_features, 1, generator=generator))
        for t in range(depth):
            self.add_module(f"gru_{t}", KerasGRUCellUpdate(units_attend, units,
                                                           generator=generator))

    def forward(self, batch: GraphBatch, h: Tensor) -> Tensor:
        state = pool_nodes_to_graph(batch, self.vertex2mol(h), mode=self.pooling_method)
        for t in range(self.depth):
            align = getattr(self, f"align_{t}")(torch.cat([gather_state(state, batch), h], -1))
            mm = F.elu(pool_nodes_to_graph_attention(batch, getattr(self, f"attend_{t}")(h),
                                                     align))
            state = self._act(getattr(self, f"gru_{t}")(state, mm))
        return state


class HamNet(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        if cfg["edge_in_features"] == 0:
            raise ValueError("HamNet's messages read edge_attributes: give their width "
                             "(edge_in_features; None for integer classes)")
        mu = cfg["gru_kwargs"]["units"]
        self.node_embed, width = input_embedding(cfg["input_embedding"]["node"],
                                                 cfg["in_features"], generator)
        self.edge_embed, e_width = input_embedding(cfg["input_embedding"]["edge"],
                                                   cfg["edge_in_features"], generator)
        if not cfg["given_coordinates"]:
            self.q_net = Dense(width, 3, activation="tanh", generator=generator)
            self.p_net = Dense(width, 3, activation="tanh", generator=generator)
        self.node_init = Dense(width, mu, activation="tanh", generator=generator)
        self.edge_init = Dense(e_width, mu, activation="tanh", generator=generator)
        msg = cfg["message_kwargs"]
        h_w = e_w = mu
        for i in range(cfg["depth"]):
            self.add_module(f"message_{i}", HamNaiveDynMessage(h_w, e_w, **msg,
                                                               generator=generator))
            nu_w, eu_w = msg.get("units", 128), msg.get("units_edge", 128)
            h_w = self._union(f"gru_union_{i}", f"union_{i}", cfg["union_type_node"],
                              h_w, nu_w, mu, generator)
            e_w = self._union(f"gru_union_e_{i}", f"union_e_{i}", cfg["union_type_edge"],
                              e_w, eu_w, mu, generator)
        out = cfg["output_mlp"]
        units = out["units"]
        use_bias = out.get("use_bias", True)
        if isinstance(use_bias, (list, tuple)) and len(use_bias) != len(units):
            use_bias = True
        if cfg["output_embedding"] == "graph":
            self.fingerprint = HamNetFingerprintGenerator(h_w, **cfg["fingerprint_kwargs"],
                                                          generator=generator)
            h_w = cfg["fingerprint_kwargs"].get("units", 128)
        self.out_mlp = MLP(h_w, units, activation=out["activation"], use_bias=use_bias,
                           generator=generator)

    def _union(self, gru_name: str, dense_name: str, kind: str, state_width: int,
               message_width: int, mu: int, generator) -> int:
        """Builds the union of a state with its message; returns the new
        state's width."""
        if kind == "gru":
            self.add_module(gru_name, KerasGRUCellUpdate(message_width, mu, generator=generator))
            return mu
        if kind == "naive":
            self.add_module(dense_name, Dense(state_width + message_width, mu,
                                              activation="tanh", generator=generator))
            return mu
        return message_width

    def _unite(self, kind: str, gru_name: str, dense_name: str, state: Tensor,
               message: Tensor) -> Tensor:
        if kind == "gru":
            return getattr(self, gru_name)(state, message)
        if kind == "naive":
            return getattr(self, dense_name)(torch.cat([state, message], dim=-1))
        return message

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        h = embed_input(batch.nodes.get("node_attributes", batch.nodes.get("node_number")),
                        self.node_embed, cfg["in_features"])
        ed = batch.edges.get("edge_attributes", batch.edges.get("edge_number"))
        if ed is None:
            raise ValueError("HamNet reads edge_attributes; the batch has none")
        e = embed_input(ed, self.edge_embed, cfg["edge_in_features"], "edge")
        if cfg["given_coordinates"]:
            q = batch.nodes.get("node_coordinates")
            q = h.new_zeros(batch.n_node, 3) if q is None else q
            p = torch.zeros_like(q)
        else:
            q, p = self.q_net(h), self.p_net(h)
        h, e = self.node_init(h), self.edge_init(e)
        for i in range(cfg["depth"]):
            nu, eu = getattr(self, f"message_{i}")(batch, h, e, p, q)
            h = self._unite(cfg["union_type_node"], f"gru_union_{i}", f"union_{i}", h, nu)
            e = self._unite(cfg["union_type_edge"], f"gru_union_e_{i}", f"union_e_{i}", e, eu)
        if cfg["output_embedding"] == "graph":
            h = self.fingerprint(batch, h)
        return {"output": self.out_mlp(h)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> HamNet:
    """HamNet with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return HamNet(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
