"""NMPN, the neural message passing network (MPNN); counterpart of
``gcnn_keras_tpu/models/nmpn.py`` (``make_model``, ``make_crystal_model``).

The nodes are embedded and projected (``node_proj``) to ``node_dim``; two
edge networks, ``edge_net_in`` and ``edge_net_out`` (an MLP, then a Dense
to ``node_dim**2``), give each edge two (F, F) matrices. Each of ``depth``
rounds multiplies them with the sender's and the receiver's state
(``matmul_messages``), sums the concatenated messages onto the receivers
(the sorted segment-sum kernel) and updates the nodes by one keras GRU
cell, ``gru``, shared by the rounds. The readout takes ``[n0 || n]``: for
``output_embedding="graph"`` ``set2set_proj`` and ``Set2Set`` (whose sums
are unsorted, ``index_add_``, as in JAX), or without ``use_set2set`` the
sum per graph; then the output MLP.

Edge inputs: with ``make_distance`` the edge lengths (``edge_distances``,
through the lattice images of a periodic batch), expanded by
``gauss_basis(**gauss_args)`` with ``expand_distance``; else the batch's
``edge_attributes``, ``edge_in_features`` as in ``models/sage.py`` (None:
integer classes, embedded; a width: float ones), which NMPN needs (0
raises, as the JAX model fails on a batch without them). ``in_features``
as in ``models/sage.py``.

At full width the per-edge matrices are large: 2 x (E, F, F) floats, 1.8 GB
at E = 54784 and F = 64.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import gather_nodes, pool_edges_to_nodes, pool_nodes_to_graph
from ..layers.conv.basic import KerasGRUCellUpdate, matmul_messages
from ..layers.geometry import edge_distances, gauss_basis
from ..layers.mlp import MLP, Dense
from ..layers.pool.set2set import Set2Set
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding, mlp_width
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 5, "output_dim": 64}},
    make_distance=False, expand_distance=False,
    gauss_args={"bins": 20, "distance_max": 4.0, "offset": 0.0, "sigma": 0.4},
    set2set_args={"channels": 32, "T": 3, "pooling_method": "sum"},
    pooling_args={"pooling_method": "sum"},
    edge_mlp={"units": [64, 64, 64], "activation": "swish"},
    use_set2set=True,
    depth=3,
    node_dim=64,
    output_embedding="graph",
    output_mlp={"units": [25, 10, 1], "activation": ["selu", "selu", "sigmoid"],
                "use_bias": [True, True, False]},
    in_features=None,
    edge_in_features=None,
)


class NMPN(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        f = cfg["node_dim"]
        self.embedding, n0_width = input_embedding(cfg["input_embedding"]["node"],
                                                   cfg["in_features"], generator)
        self.node_proj = Dense(n0_width, f, generator=generator)
        self.edge_embedding = None
        if cfg["make_distance"]:
            e_width = cfg["gauss_args"]["bins"] if cfg["expand_distance"] else 1
        elif cfg["edge_in_features"] == 0:
            raise ValueError("NMPN without make_distance reads edge_attributes: give their "
                             "width (edge_in_features; None for integer classes)")
        else:
            self.edge_embedding, e_width = input_embedding(
                cfg["input_embedding"].get("edge", {"input_dim": 5, "output_dim": 64}),
                cfg["edge_in_features"], generator)
        mlp = cfg["edge_mlp"]
        for side in ("in", "out"):
            self.add_module(f"edge_net_{side}", MLP(e_width, mlp["units"],
                                                    activation=mlp["activation"],
                                                    generator=generator))
            self.add_module(f"edge_net_{side}_out", Dense(mlp_width(mlp["units"]), f * f,
                                                          generator=generator))
        if cfg["depth"]:  # the JAX model creates it at its first call
            self.gru = KerasGRUCellUpdate(2 * f, f, generator=generator)
        width = n0_width + f
        self.set2set = None
        if cfg["output_embedding"] == "graph" and cfg["use_set2set"]:
            channels = cfg["set2set_args"]["channels"]
            self.set2set_proj = Dense(width, channels, generator=generator)
            self.set2set = Set2Set(**cfg["set2set_args"], generator=generator)
            width = 2 * channels
        out = cfg["output_mlp"]
        # the JAX model's output MLP takes units and activation only
        self.out_mlp = MLP(width, out["units"], activation=out["activation"],
                           generator=generator)

    def _edges(self, batch: GraphBatch) -> Tensor:
        cfg = self.config
        if cfg["make_distance"]:
            ed = edge_distances(batch)
            return gauss_basis(ed, **cfg["gauss_args"]) if cfg["expand_distance"] else ed
        return edge_input(batch, self.edge_embedding, cfg["edge_in_features"])

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        f = cfg["node_dim"]
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n0 = embed_input(x, self.embedding, cfg["in_features"])
        n = self.node_proj(n0)
        ed = self._edges(batch)
        ed = ed * batch.edge_mask[:, None].to(ed.dtype)
        trafo_in = self.edge_net_in_out(self.edge_net_in(ed)).reshape(-1, f, f)
        trafo_out = self.edge_net_out_out(self.edge_net_out(ed)).reshape(-1, f, f)
        for _ in range(cfg["depth"]):
            eu = torch.cat([matmul_messages(trafo_in, gather_nodes(n, batch.senders)),
                            matmul_messages(trafo_out, gather_nodes(n, batch.receivers))],
                           dim=-1)
            n = self.gru(n, pool_edges_to_nodes(batch, eu, **cfg["pooling_args"]))
        n = torch.cat([n0, n], dim=-1)
        if cfg["output_embedding"] == "graph":
            n = n * batch.node_mask[:, None].to(n.dtype)
            n = self.set2set(batch, self.set2set_proj(n)) if self.set2set is not None else \
                pool_nodes_to_graph(batch, n)
        return {"output": self.out_mlp(n)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> NMPN:
    """NMPN with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return NMPN(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)


def make_crystal_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
                       **kwargs) -> NMPN:
    """The periodic variant: :func:`make_model` with ``make_distance`` and
    ``expand_distance`` on by default; a batch with ``range_image`` and
    ``graph_lattice`` measures its edges through the images."""
    kwargs.setdefault("make_distance", True)
    kwargs.setdefault("expand_distance", True)
    return make_model(device=device, generator=generator, **kwargs)
