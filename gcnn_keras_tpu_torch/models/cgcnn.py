"""CGCNN, the crystal graph convolutional network; counterpart of
``gcnn_keras_tpu/models/cgcnn.py`` (``make_model``, ``make_crystal_model``:
one model).

The edges are their lengths (``edge_distances``: through the lattice
images of a periodic batch) in a Gaussian basis (``gauss_args``), or with
``make_distances=False`` the batch's float ``edge_attributes`` of width
``edge_in_features``. The embedded nodes are projected (``proj``) to
``units``; each of ``depth`` ``CGCNNLayer``s gates ``sigmoid(bn_f(w_f
z)) * softplus(bn_s(w_s z))`` on ``z = [n_i, n_j, e_ij]``, sums the
messages onto the receivers (kernel #1), batch-normalizes the sum
(``bn_out``) and adds it to the nodes before ``activation_out``. The
readout is the mean per graph (kernel #1 and a ``bincount``), then
``out_mlp``.

The three ``GraphBatchNorm``s key on the call's ``train``: the running
averages at ``train=False`` (the JAX model's ``use_running_average=not
train``), the masked batch statistics at ``train=True``, which move the
running averages as the JAX model does under ``mutable=["batch_stats"]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import gather_nodes, pool_edges_to_nodes, pool_nodes_to_graph
from ..layers.geometry import edge_distances, gauss_basis
from ..layers.mlp import MLP, Dense
from ..layers.norm import GraphBatchNorm
from ..ops.activ import get_activation
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64}},
    make_distances=True, expand_distance=True,
    gauss_args={"bins": 60, "distance_max": 6.0, "offset": 0.0, "sigma": 0.4},
    conv_layer_args={"units": 64, "activation_s": "softplus", "activation_out": "softplus",
                     "batch_normalization": True},
    depth=4,
    node_pooling_args={"pooling_method": "mean"},
    output_embedding="graph",
    output_mlp={"units": [64, 1], "activation": ["softplus", "linear"]},
    in_features=None,
    edge_in_features=0,
)


class CGCNNLayer(nn.Module):
    """One gated convolution (kgcnn's ``cgcnn_conv.py``) over nodes of
    ``units`` and edges of ``edge_width``."""

    def __init__(self, edge_width: int, units: int = 64, activation_s: Any = "softplus",
                 activation_out: Any = "softplus", batch_normalization: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_f = Dense(2 * units + edge_width, units, generator=generator)
        self.w_s = Dense(2 * units + edge_width, units, generator=generator)
        self.batch_normalization = batch_normalization
        if batch_normalization:
            self.bn_f, self.bn_s, self.bn_out = (GraphBatchNorm(units) for _ in range(3))
        self._act_s = get_activation(activation_s)
        self._act_out = get_activation(activation_out)

    def forward(self, batch: GraphBatch, nodes: Tensor, edges: Tensor,
                train: bool = False) -> Tensor:
        z = torch.cat([gather_nodes(nodes, batch.receivers),
                       gather_nodes(nodes, batch.senders), edges], dim=-1)
        x_f, x_s = self.w_f(z), self.w_s(z)
        if self.batch_normalization:
            x_f = self.bn_f(x_f, batch.edge_mask, train)
            x_s = self.bn_s(x_s, batch.edge_mask, train)
        msg = torch.sigmoid(x_f) * self._act_s(x_s)
        msg = msg * batch.edge_mask[:, None].to(msg.dtype)
        agg = pool_edges_to_nodes(batch, msg, mode="sum")
        if self.batch_normalization:
            agg = self.bn_out(agg, batch.node_mask, train)
        return self._act_out(nodes + agg)


class CGCNN(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        self.embedding, n_width = input_embedding(cfg["input_embedding"]["node"],
                                                  cfg["in_features"], generator)
        if cfg["make_distances"]:
            e_width = cfg["gauss_args"]["bins"] if cfg["expand_distance"] else 1
        elif not cfg["edge_in_features"]:
            raise ValueError("CGCNN without make_distances reads float edge_attributes: "
                             "give their width (edge_in_features)")
        else:
            e_width = cfg["edge_in_features"]
        units = cfg["conv_layer_args"]["units"]
        self.proj = Dense(n_width, units, generator=generator)
        for i in range(cfg["depth"]):
            self.add_module(f"conv_{i}", CGCNNLayer(e_width, **cfg["conv_layer_args"],
                                                    generator=generator))
        out = cfg["output_mlp"]
        # the JAX model's output MLP takes units and activation only
        self.out_mlp = MLP(units, out["units"], activation=out["activation"],
                           generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = self.proj(embed_input(x, self.embedding, cfg["in_features"]))
        if cfg["make_distances"]:
            ed = edge_distances(batch)
            if cfg["expand_distance"]:
                ed = gauss_basis(ed, **cfg["gauss_args"])
        else:
            ed = edge_input(batch, None, cfg["edge_in_features"])
        ed = ed * batch.edge_mask[:, None].to(ed.dtype)
        for i in range(cfg["depth"]):
            n = getattr(self, f"conv_{i}")(batch, n, ed, train=train)
        if cfg["output_embedding"] == "graph":
            n = n * batch.node_mask[:, None].to(n.dtype)
            n = pool_nodes_to_graph(batch, n, **cfg["node_pooling_args"])
        return {"output": self.out_mlp(n)}


def make_crystal_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
                       **kwargs) -> CGCNN:
    """CGCNN with the JAX package's defaults updated by ``kwargs``, weights
    drawn from ``generator`` (seed 0 if None) on the CPU, moved to
    ``device`` (the CUDA card unless ``"cpu"``). A batch with
    ``range_image`` and ``graph_lattice`` measures its edges through the
    images."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return CGCNN(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> CGCNN:
    """The same model as :func:`make_crystal_model`, as in the JAX package."""
    return make_crystal_model(device=device, generator=generator, **kwargs)
