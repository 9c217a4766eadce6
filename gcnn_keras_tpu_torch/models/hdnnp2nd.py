"""HDNNP 2nd generation, the Behler-Parrinello potential; counterpart of
``gcnn_keras_tpu/models/hdnnp2nd.py`` in its Behler mode.

ACSF G2 and G4 descriptors per atom -> a per-element atomic network
(``RelationalMLP`` by atomic number) -> a sum over each molecule. Submodule
names follow the flax tree (``acsf_g2``, ``acsf_g4``,
``atomic_mlp.rel_dense_i``, ``output_mlp.dense_i``) so that
``utils/convert.py`` maps one onto the other. The weighted (wACSF) and
atom-wise modes and a ``GraphBatchNorm`` over the descriptors are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.acsf import ACSFG2, ACSFG4, ACSFConstNormalization
from ..layers.mlp import MLP, RelationalMLP
from ..utils.devices import DeviceLike, resolve_device
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default_behler = dict(
    g2_kwargs={"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 10.0, "elements": [1, 6, 16]},
    g4_kwargs={"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "rc": 6.0,
               "zeta": [1.0, 8.0], "elements": [1, 6, 16], "multiplicity": 2.0},
    normalize_kwargs={},
    const_normalize_kwargs=None,
    mlp_kwargs={"units": [64, 64, 1], "num_relations": 96,
                "activation": ["swish", "swish", "linear"]},
    node_pooling_args={"pooling_method": "sum"},
    output_embedding="graph",
    use_output_mlp=False,
    output_mlp={"units": [64, 1], "activation": ["swish", "linear"]},
)

_NOT_PORTED = ("HDNNP2nd {} is not ported yet: it needs {}, which come with "
               "the other model families")


class HDNNP2nd(nn.Module):
    """mode: only ``'behler'`` (ACSF G2+G4 tables) so far."""

    def __init__(self, config: Dict[str, Any], mode: str = "behler",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode in ("weighted", "atom_wise"):
            raise NotImplementedError(_NOT_PORTED.format(
                f"mode={mode!r}", "the wACSF layers (layers/conv/wacsf.py)"
                if mode == "weighted" else "precomputed node representations"))
        if mode != "behler":
            raise ValueError(f"unknown HDNNP2nd mode {mode}")
        cfg = config
        # an EMPTY normalize_kwargs dict means no normalization layer
        if cfg.get("normalize_kwargs"):
            raise NotImplementedError(_NOT_PORTED.format(
                "normalize_kwargs", "GraphBatchNorm (layers/norm.py)"))
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unsupported output_embedding {cfg['output_embedding']}")
        self.config = cfg
        self.acsf_g2 = ACSFG2(**ACSFG2.make_param_table(**cfg["g2_kwargs"]))
        self.acsf_g4 = ACSFG4(**ACSFG4.make_param_table(**cfg["g4_kwargs"]))
        self.const_norm = ACSFConstNormalization(**cfg["const_normalize_kwargs"]) \
            if cfg.get("const_normalize_kwargs") else None
        width = self.acsf_g2.out_features + self.acsf_g4.out_features
        self.atomic_mlp = RelationalMLP(width, **cfg["mlp_kwargs"], generator=generator)
        self.output_mlp = MLP(self.atomic_mlp.out_features, cfg["output_mlp"]["units"],
                              activation=cfg["output_mlp"]["activation"],
                              generator=generator) if cfg["use_output_mlp"] else None

    def forward(self, batch: GraphBatch) -> Dict[str, Tensor]:
        cfg = self.config
        z = batch.nodes["node_number"].to(torch.int32)
        rep = torch.cat([self.acsf_g2(batch, z=z), self.acsf_g4(batch, z=z)], dim=-1)
        if self.const_norm is not None:
            rep = self.const_norm(rep)
        n = self.atomic_mlp(rep, z)
        if cfg["output_embedding"] == "graph":
            n = n * batch.node_mask[:, None].to(n.dtype)
            out = pool_nodes_to_graph(batch, n, **cfg["node_pooling_args"])
        else:
            out = n
        if self.output_mlp is not None:
            out = self.output_mlp(out)
        return {"output": out}


def make_model_behler(device: DeviceLike = None,
                      generator: Optional[torch.Generator] = None,
                      **kwargs) -> HDNNP2nd:
    """HDNNP2nd (Behler mode) with the JAX package's defaults updated by
    ``kwargs``, on ``device`` (the CUDA card unless ``device="cpu"``).
    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
    if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cfg = update_model_kwargs(model_default_behler, kwargs)
    return HDNNP2nd(cfg, mode="behler", generator=generator).to(dev)


def make_model_weighted(device: DeviceLike = None, **kwargs) -> HDNNP2nd:
    raise NotImplementedError(_NOT_PORTED.format(
        "make_model_weighted", "the wACSF layers (layers/conv/wacsf.py)"))


def make_model_atom_wise(device: DeviceLike = None, **kwargs) -> HDNNP2nd:
    raise NotImplementedError(_NOT_PORTED.format(
        "make_model_atom_wise", "precomputed node representations"))


def make_model(device: DeviceLike = None, **kwargs) -> HDNNP2nd:
    """The JAX package's default is the weighted variant, which is not
    ported yet; use :func:`make_model_behler`."""
    return make_model_weighted(device=device, **kwargs)
