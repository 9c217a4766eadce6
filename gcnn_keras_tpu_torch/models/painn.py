"""PAiNN model; counterpart of ``gcnn_keras_tpu/models/painn.py``.

Node embedding -> ``depth`` x (``PAiNNconv`` then ``PAiNNUpdate``, each
added to ``(s, v)``, then the optional layer norms of v and s) -> the
output MLP, after a sum over each graph's nodes (``output_embedding
"graph"``) or per node (``"node"``). The radial basis is kgcnn's Bessel
basis of the edge lengths with its polynomial envelope, zeroed on padding
edges; ``conv_args["cutoff"]`` adds the cosine envelope to every filter.

Periodic support is implicit: a batch that carries ``edges['range_image']``
and ``globals['graph_lattice']`` gets the lattice shift in its edge vectors.
Submodule names follow the flax parameter tree (``conv_i/{dense_1,phi,w}``,
``update_i/{lin_v,lin_u,dense_1,a}``, ``equiv_norm_i``, ``node_norm_i``,
``output_mlp/dense_k``) so that ``utils/convert.py`` can map one onto the
other.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.painn import PAiNNconv, PAiNNUpdate, equivariant_initialize
from ..layers.geometry import bessel_basis_kgcnn, cosine_cutoff_envelope, edge_vectors
from ..layers.mlp import MLP
from ..layers.norm import GraphLayerNorm
from ..utils.devices import DeviceLike, resolve_device
from .common import OptionalInputEmbedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 128}},
    equiv_initialize_kwargs={"dim": 3, "method": "zeros"},
    bessel_basis={"num_radial": 20, "cutoff": 5.0, "envelope_exponent": 5},
    pooling_args={"pooling_method": "sum"},
    conv_args={"units": 128, "cutoff": None, "conv_pool": "sum"},
    update_args={"units": 128},
    equiv_normalization=False,
    node_normalization=False,
    depth=3,
    output_embedding="graph",
    output_mlp={"units": [128, 1], "activation": ["swish", "linear"]},
)


class PAiNN(nn.Module):
    def __init__(self, config: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unsupported output_embedding {cfg['output_embedding']}")
        self.config = cfg
        emb = cfg["input_embedding"]["node"]
        self.embedding = OptionalInputEmbedding(**emb, generator=generator)
        width = emb["output_dim"]
        num_radial = cfg["bessel_basis"]["num_radial"]
        for i in range(cfg["depth"]):
            conv = PAiNNconv(width, num_radial, **cfg["conv_args"], generator=generator)
            update = PAiNNUpdate(width, **cfg["update_args"], generator=generator)
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"update_{i}", update)
            if cfg["equiv_normalization"]:
                self.add_module(f"equiv_norm_{i}", GraphLayerNorm(width))
            if cfg["node_normalization"]:
                self.add_module(f"node_norm_{i}", GraphLayerNorm(width))
        self.output_mlp = MLP(width, cfg["output_mlp"]["units"],
                              activation=cfg["output_mlp"]["activation"],
                              generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        """``train`` is accepted, as the JAX model takes it, and changes
        nothing: PAiNN has no dropout or batch statistics."""
        cfg = self.config
        zin = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        s = self.embedding(zin)
        v = equivariant_initialize(s, **cfg["equiv_initialize_kwargs"])

        vec = edge_vectors(batch)
        d = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True).clamp_min(1e-12))
        dir_ij = vec / d
        bb = cfg["bessel_basis"]
        rbf = bessel_basis_kgcnn(d, num_radial=bb["num_radial"], cutoff=bb["cutoff"],
                                 envelope_exponent=bb.get("envelope_exponent", 5))
        rbf = rbf * batch.edge_mask[:, None].to(rbf.dtype)
        cutoff = cfg["conv_args"].get("cutoff")
        env = cosine_cutoff_envelope(d, cutoff) if cutoff is not None else None

        for i in range(cfg["depth"]):
            ds, dv = getattr(self, f"conv_{i}")(batch, s, v, rbf, env, dir_ij)
            s, v = s + ds, v + dv
            ds, dv = getattr(self, f"update_{i}")(batch, s, v)
            s, v = s + ds, v + dv
            if cfg["equiv_normalization"]:
                v = getattr(self, f"equiv_norm_{i}")(v)
            if cfg["node_normalization"]:
                s = getattr(self, f"node_norm_{i}")(s)

        if cfg["output_embedding"] == "graph":
            # pool the nodes first, then the MLP, as the reference does
            s = pool_nodes_to_graph(batch, s, **cfg["pooling_args"])
        return {"output": self.output_mlp(s)}


def make_model(device: DeviceLike = None,
               generator: Optional[torch.Generator] = None, **kwargs) -> PAiNN:
    """PAiNN with the JAX package's defaults updated by ``kwargs``, on
    ``device`` (the CUDA card unless ``device="cpu"``). Weights are drawn
    from ``generator`` (a CPU ``torch.Generator``; seed 0 if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cfg = update_model_kwargs(model_default, kwargs)
    return PAiNN(cfg, generator=generator).to(dev)


def make_crystal_model(device: DeviceLike = None,
                       generator: Optional[torch.Generator] = None,
                       **kwargs) -> PAiNN:
    """Periodic variant: the same module; periodicity comes from the batch
    carrying ``range_image`` + ``graph_lattice``."""
    return make_model(device=device, generator=generator, **kwargs)
