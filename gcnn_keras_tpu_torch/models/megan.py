"""MEGAN, the multi-explanation graph attention network; counterpart of
``gcnn_keras_tpu/models/megan.py`` (with its ``MultiHeadGATV2``, which
returns each head's attention logits).

One attention layer ``att_i`` per entry of ``units``: ``importance_channels``
(K) GATv2 heads, concatenated. The edge importances are the importance
activation of the layers' logits summed, (E, K), zero on padding edges;
each node takes the mean of its edges' importances over both directions
(the mean onto the receivers, the sorted segment-sum kernel, and onto the
senders, an unsorted ``index_add_`` and a ``bincount``, as in JAX). The
node importances are the activation of the ``node_imp_*`` MLP times that
mean, (N, K). K readouts of the nodes, each weighted by one channel, are
pooled per graph (``final_pooling``, the kernel for a sum) and
concatenated into the ``final_*`` Denses. The model returns ``output``,
``node_importances`` and ``edge_importances``.

Inputs and widths at build: ``in_features`` as in ``models/sage.py``
(None: integer node numbers, embedded); the JAX heads concatenate the edge
features as they are, so they are floats: ``edge_in_features`` is their
width (0, the default: batches without them); None raises. With
``use_edge_features=False`` the edges are not read.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import gather_nodes, pool_edges_to_nodes, pool_edges_to_nodes_attention
from ..layers.mlp import Dense
from ..ops.activ import get_activation
from ..ops.segment import segment_ops_by_name
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64}},
    units=[32, 32, 32],
    importance_units=[16],
    importance_channels=2,
    importance_activation="sigmoid",
    final_units=[16, 1],
    final_activation="linear",
    final_pooling="sum",
    activation="kgcnn>leaky_relu",
    use_bias=True,
    use_edge_features=True,
    dropout_rate=0.0,
    sparsity_factor=0.0,
    regression_reference=None,
    output_embedding="graph",
    in_features=None,
    edge_in_features=0,
)


class MultiHeadGATV2(nn.Module):
    """``num_heads`` GATv2 heads over ``[x_i || x_j (|| e_ij)]``: head k
    takes ``head_k_linear(x)`` of the senders, weighted by the softmax of
    ``head_k_alpha(head_k_alpha_act(e_ij))`` over each receiver's edges,
    summed onto the receiver, through the activation. Returns the heads
    concatenated (or averaged) and their logits (E, num_heads)."""

    def __init__(self, in_features: int, units: int, num_heads: int,
                 edge_features: int = 0, activation: Any = "kgcnn>leaky_relu",
                 use_bias: bool = True, concat_heads: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.concat_heads = num_heads, concat_heads
        self.edge_features = edge_features
        self._act = get_activation(activation)
        for k in range(num_heads):
            self.add_module(f"head_{k}_linear", Dense(in_features, units, activation=activation,
                                                      use_bias=use_bias, generator=generator))
            self.add_module(f"head_{k}_alpha_act", Dense(
                2 * in_features + edge_features, units, activation=activation,
                use_bias=use_bias, generator=generator))
            self.add_module(f"head_{k}_alpha", Dense(units, 1, use_bias=False,
                                                     generator=generator))

    def forward(self, batch: GraphBatch, x: Tensor,
                ed: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        parts = [gather_nodes(x, batch.receivers), gather_nodes(x, batch.senders)]
        e_ij = torch.cat(parts + ([ed] if self.edge_features else []), dim=-1)
        h_list: List[Tensor] = []
        a_list: List[Tensor] = []
        for k in range(self.num_heads):
            wn = getattr(self, f"head_{k}_linear")(x)
            a = getattr(self, f"head_{k}_alpha")(getattr(self, f"head_{k}_alpha_act")(e_ij))
            h = pool_edges_to_nodes_attention(batch, gather_nodes(wn, batch.senders), a)
            h_list.append(self._act(h))
            a_list.append(a)
        h_out = torch.cat(h_list, dim=-1) if self.concat_heads \
            else sum(h_list) / float(self.num_heads)
        return h_out, torch.cat(a_list, dim=-1)


class MEGAN(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["edge_in_features"] is None:
            raise ValueError("MEGAN takes float edge_attributes: give their width "
                             "(edge_in_features; 0 for batches without them)")
        K = cfg["importance_channels"]
        self.node_embed, width = input_embedding(cfg["input_embedding"]["node"],
                                                 cfg["in_features"], generator)
        self.edge_features = cfg["edge_in_features"] if cfg["use_edge_features"] else 0
        for i, u in enumerate(cfg["units"]):
            self.add_module(f"att_{i}", MultiHeadGATV2(
                width, u, K, self.edge_features, activation=cfg["activation"],
                use_bias=cfg["use_bias"], generator=generator))
            width = K * u
        imp_units = list(cfg["importance_units"]) + [K]
        imp_acts = ["relu"] * len(cfg["importance_units"]) + ["linear"]
        fan_in = width
        for li, (u, a) in enumerate(zip(imp_units, imp_acts)):
            self.add_module(f"node_imp_{li}", Dense(fan_in, u, activation=a,
                                                    use_bias=cfg["use_bias"],
                                                    generator=generator))
            fan_in = u
        final_units = list(cfg["final_units"])
        final_acts = ["relu"] * (len(final_units) - 1) + [cfg["final_activation"]]
        fan_in = K * width
        for li, (u, a) in enumerate(zip(final_units, final_acts)):
            self.add_module(f"final_{li}", Dense(fan_in, u, activation=a,
                                                 use_bias=cfg["use_bias"],
                                                 generator=generator))
            fan_in = u
        self._imp_act = get_activation(cfg["importance_activation"])

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        K = cfg["importance_channels"]
        x = embed_input(batch.nodes.get("node_attributes", batch.nodes.get("node_number")),
                        self.node_embed, cfg["in_features"])
        ed = edge_input(batch, None, cfg["edge_in_features"]) \
            if cfg["use_edge_features"] else None
        alphas = []
        for i in range(len(cfg["units"])):
            x, alpha = getattr(self, f"att_{i}")(batch, x, ed)
            alphas.append(alpha)
        edge_importances = self._imp_act(sum(alphas)) \
            * batch.edge_mask[:, None].to(x.dtype)
        # the mean over both directions of each node's edges
        pooled_in = pool_edges_to_nodes(batch, edge_importances, mode="mean")
        pooled_out = segment_ops_by_name("mean", edge_importances, batch.senders, batch.n_node)
        pooled_edges = 0.5 * (pooled_out + pooled_in)
        ni = x
        for li in range(len(cfg["importance_units"]) + 1):
            ni = getattr(self, f"node_imp_{li}")(ni)
        node_importances = self._imp_act(ni) * pooled_edges
        node_mask = batch.node_mask[:, None].to(x.dtype)
        out = torch.cat([segment_ops_by_name(cfg["final_pooling"],
                                             x * node_importances[:, k:k + 1] * node_mask,
                                             batch.graph_id, batch.n_graphs,
                                             indices_are_sorted=True)
                         for k in range(K)], dim=-1)
        for li in range(len(cfg["final_units"])):
            out = getattr(self, f"final_{li}")(out)
        if cfg.get("regression_reference") is not None:
            out = out + cfg["regression_reference"]
        return {"output": out, "node_importances": node_importances,
                "edge_importances": edge_importances}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> MEGAN:
    """MEGAN with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return MEGAN(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
