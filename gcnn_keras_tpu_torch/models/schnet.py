"""SchNet model; counterpart of ``gcnn_keras_tpu/models/schnet.py`` on the
flat path. ``interaction_args`` selects the CFconv's execution mode
(``fused_aggregate``, ``accurate_cfconv``, ``fused_chain``;
``layers/conv/schnet.py``); every mode keeps the default parameter tree.
With ``fused_chain`` the interactions recompute the Gaussian basis from the
positions, so the model needs ``make_distance`` and ``expand_distance`` and
computes the edge basis only when a batch takes the default path.

Periodic support is implicit: a batch that carries ``edges['range_image']``
and ``globals['graph_lattice']`` gets the lattice shift in its edge vectors.
Submodule names follow the flax parameter tree (``embed_to_units``,
``interaction_i/{pre,cfconv/filter_1,...}``, ``last_mlp/dense_k``,
``output_mlp/dense_k``) so that ``utils/convert.py`` can map one onto the
other.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.schnet import SchNetInteraction
from ..layers.geometry import edge_distances, gauss_basis
from ..layers.mlp import MLP, Dense
from ..utils.devices import DeviceLike, resolve_device
from .common import OptionalInputEmbedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64}},
    make_distance=True,
    expand_distance=True,
    gauss_args={"bins": 20, "distance_max": 4.0, "offset": 0.0, "sigma": 0.4},
    interaction_args={"units": 128, "use_bias": True,
                      "activation": "shifted_softplus", "cfconv_pool": "sum"},
    node_pooling_args={"pooling_method": "sum"},
    depth=4,
    last_mlp={"units": [128, 64], "activation": ["shifted_softplus", "shifted_softplus"]},
    output_embedding="graph",
    use_output_mlp=True,
    output_mlp={"units": [64, 1], "activation": ["shifted_softplus", "linear"]},
    dtype=None,
    dense_block=False,
    remat=False,
)


class Schnet(nn.Module):
    def __init__(self, config: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg.get("dtype") not in (None, "float32"):
            raise NotImplementedError(f"Schnet dtype={cfg['dtype']!r} is not ported yet")
        if cfg.get("dense_block"):
            raise NotImplementedError("Schnet dense_block=True is not ported yet")
        if cfg.get("remat"):
            raise NotImplementedError("Schnet remat=True is not ported yet")
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unsupported output_embedding {cfg['output_embedding']}")
        self.config = cfg
        emb = cfg["input_embedding"]["node"]
        self.embedding = OptionalInputEmbedding(**emb, generator=generator)
        units = cfg["interaction_args"]["units"]
        self.embed_to_units = Dense(emb["output_dim"], units, activation="linear",
                                    generator=generator)
        in_basis = cfg["gauss_args"]["bins"] if cfg["expand_distance"] else 1
        inter_args = dict(cfg["interaction_args"])
        if inter_args.get("fused_chain"):
            # the kernels recompute the basis from the positions: only valid
            # when the basis really is gauss(distance(positions))
            if not (cfg["make_distance"] and cfg["expand_distance"]):
                raise ValueError("fused_chain requires make_distance and "
                                 "expand_distance")
            inter_args["gauss_args"] = cfg["gauss_args"]
        for i in range(cfg["depth"]):
            self.add_module(f"interaction_{i}", SchNetInteraction(
                **inter_args, in_basis=in_basis, generator=generator))
        self.last_mlp = MLP(units, cfg["last_mlp"]["units"],
                            activation=cfg["last_mlp"]["activation"],
                            generator=generator)
        self.output_mlp = MLP(self.last_mlp.out_features, cfg["output_mlp"]["units"],
                              activation=cfg["output_mlp"]["activation"],
                              generator=generator) if cfg["use_output_mlp"] else None

    def forward(self, batch: GraphBatch) -> Dict[str, Tensor]:
        cfg = self.config
        z = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = self.embedding(z)
        interactions = [getattr(self, f"interaction_{i}") for i in range(cfg["depth"])]
        ed = None  # the fused chain computes its own basis
        if not all(inter.cfconv.takes_chain(batch) for inter in interactions):
            ed = edge_distances(batch) if cfg["make_distance"] \
                else batch.edges["edge_distance"]
            if cfg["expand_distance"]:
                ed = gauss_basis(ed, **cfg["gauss_args"])
            # zero the basis on padding edges so filters see exact zeros
            ed = ed * batch.edge_mask[:, None].to(ed.dtype)
        n = self.embed_to_units(n)
        for inter in interactions:
            n = inter(batch, n, ed)
        n = self.last_mlp(n)
        if cfg["output_embedding"] == "graph":
            out = n * batch.node_mask[:, None].to(n.dtype)
            out = pool_nodes_to_graph(batch, out, **cfg["node_pooling_args"])
        else:
            out = n
        if self.output_mlp is not None:
            out = self.output_mlp(out)
        return {"output": out}


def make_model(device: DeviceLike = None,
               generator: Optional[torch.Generator] = None, **kwargs) -> Schnet:
    """SchNet with the JAX package's defaults updated by ``kwargs``, on
    ``device`` (the CUDA card unless ``device="cpu"``). Weights are drawn
    from ``generator`` (a CPU ``torch.Generator``; seed 0 if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cfg = update_model_kwargs(model_default, kwargs)
    return Schnet(cfg, generator=generator).to(dev)


def make_crystal_model(device: DeviceLike = None,
                       generator: Optional[torch.Generator] = None,
                       **kwargs) -> Schnet:
    """Periodic variant: the same module; periodicity comes from the batch
    carrying ``range_image`` + ``graph_lattice``."""
    return make_model(device=device, generator=generator, **kwargs)
