"""HDNNP 2nd generation, the Behler-Parrinello potential; counterpart of
``gcnn_keras_tpu/models/hdnnp2nd.py``.

Descriptors per atom -> an optional ``GraphBatchNorm`` over them (a
non-empty ``normalize_kwargs``) -> a per-element atomic network
(``RelationalMLP`` by atomic number) -> a sum over each molecule. The
descriptors are, by mode: ACSF G2 and G4 (``"behler"``), wACSF radial and
angular (``"weighted"``, the default model, as in the JAX package), or the
batch's ``node_representation`` (``"atom_wise"``). Submodule names follow
the flax tree (``acsf_g2``, ``acsf_g4``, ``wacsf_rad``, ``wacsf_ang``,
``norm``, ``atomic_mlp.rel_dense_i``, ``output_mlp.dense_i``) so that
``utils/convert.py`` maps one onto the other.

A torch module needs its input widths when built: the atom-wise model
takes ``rep_features`` (the width of ``node_representation``) and the
inverse-distance model ``max_nodes`` (atoms per molecule, whose M(M-1)/2
pair distances are its input), where the JAX package reads them from the
first batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..batch import GraphBatch, flat_to_padded
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.acsf import ACSFG2, ACSFG4, ACSFConstNormalization
from ..layers.conv.wacsf import wACSFAng, wACSFRad
from ..layers.mlp import MLP, RelationalMLP
from ..layers.norm import GraphBatchNorm
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

model_default_weighted = dict(
    w_acsf_rad_kwargs={},
    w_acsf_ang_kwargs={},
    normalize_kwargs={},
    const_normalize_kwargs=None,
    mlp_kwargs={"units": [64, 64, 1], "num_relations": 96,
                "activation": ["swish", "swish", "linear"]},
    node_pooling_args={"pooling_method": "sum"},
    output_embedding="graph",
    use_output_mlp=False,
    output_mlp={"units": [64, 1], "activation": ["swish", "linear"]},
)

model_default_atom_wise = dict(
    mlp_kwargs={"units": [64, 64, 1], "num_relations": 96,
                "activation": ["swish", "swish", "linear"]},
    node_pooling_args={"pooling_method": "sum"},
    output_embedding="graph",
    use_output_mlp=False,
    output_mlp={"units": [64, 1], "activation": ["swish", "linear"]},
    # the width of nodes['node_representation']; the JAX package reads it
    # from the first batch. The default is the width of the weighted
    # model's descriptors (22 radial + 10 angular).
    rep_features=32,
)


class HDNNP2nd(nn.Module):
    """mode: ``'behler'`` (ACSF G2+G4 tables), ``'weighted'`` (wACSF) or
    ``'atom_wise'`` (the batch's ``node_representation``)."""

    def __init__(self, config: Dict[str, Any], mode: str = "behler",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unsupported output_embedding {cfg['output_embedding']}")
        self.config = cfg
        self.mode = mode
        if mode == "behler":
            self.acsf_g2 = ACSFG2(**ACSFG2.make_param_table(**cfg["g2_kwargs"]))
            self.acsf_g4 = ACSFG4(**ACSFG4.make_param_table(**cfg["g4_kwargs"]))
            width = self.acsf_g2.out_features + self.acsf_g4.out_features
        elif mode == "weighted":
            self.wacsf_rad = wACSFRad(**cfg["w_acsf_rad_kwargs"])
            self.wacsf_ang = wACSFAng(**cfg["w_acsf_ang_kwargs"])
            width = self.wacsf_rad.out_features + self.wacsf_ang.out_features
        elif mode == "atom_wise":
            width = cfg["rep_features"]
        else:
            raise ValueError(f"unknown HDNNP2nd mode {mode}")
        # truthy only, as in the JAX package: an EMPTY normalize_kwargs dict
        # means no normalization layer
        self.norm = GraphBatchNorm(width, **cfg["normalize_kwargs"]) \
            if cfg.get("normalize_kwargs") and mode != "atom_wise" else None
        self.const_norm = ACSFConstNormalization(**cfg["const_normalize_kwargs"]) \
            if cfg.get("const_normalize_kwargs") else None
        self.atomic_mlp = RelationalMLP(width, **cfg["mlp_kwargs"], generator=generator)
        self.output_mlp = MLP(self.atomic_mlp.out_features, cfg["output_mlp"]["units"],
                              activation=cfg["output_mlp"]["activation"],
                              generator=generator) if cfg["use_output_mlp"] else None

    def representation(self, batch: GraphBatch, z: Tensor) -> Tensor:
        """The descriptors of the model's mode, ``(N, width)``."""
        if self.mode == "behler":
            return torch.cat([self.acsf_g2(batch, z=z), self.acsf_g4(batch, z=z)], dim=-1)
        if self.mode == "weighted":
            return torch.cat([self.wacsf_rad(batch, z=z), self.wacsf_ang(batch, z=z)], dim=-1)
        return batch.nodes["node_representation"]

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        """``train`` is the JAX call's: ``GraphBatchNorm`` normalizes by the
        batch statistics and updates its running ones only when it is
        True."""
        cfg = self.config
        z = batch.nodes["node_number"].to(torch.int32)
        rep = self.representation(batch, z)
        if self.norm is not None:
            rep = self.norm(rep, batch.node_mask, train)
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


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def make_model_behler(device: DeviceLike = None,
                      generator: Optional[torch.Generator] = None,
                      **kwargs) -> HDNNP2nd:
    """HDNNP2nd (Behler mode) with the JAX package's defaults updated by
    ``kwargs``, on ``device`` (the CUDA card unless ``device="cpu"``).
    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
    if None)."""
    dev = resolve_device(device)
    cfg = update_model_kwargs(model_default_behler, kwargs)
    return HDNNP2nd(cfg, mode="behler", generator=_generator(generator)).to(dev)


def make_model_weighted(device: DeviceLike = None,
                        generator: Optional[torch.Generator] = None,
                        **kwargs) -> HDNNP2nd:
    """HDNNP2nd on wACSF descriptors, as :func:`make_model_behler` builds
    the Behler mode."""
    dev = resolve_device(device)
    cfg = update_model_kwargs(model_default_weighted, kwargs)
    return HDNNP2nd(cfg, mode="weighted", generator=_generator(generator)).to(dev)


def make_model_atom_wise(device: DeviceLike = None,
                         generator: Optional[torch.Generator] = None,
                         **kwargs) -> HDNNP2nd:
    """HDNNP2nd on the batch's ``node_representation`` (``rep_features``
    columns), as :func:`make_model_behler` builds the Behler mode."""
    dev = resolve_device(device)
    cfg = update_model_kwargs(model_default_atom_wise, kwargs)
    return HDNNP2nd(cfg, mode="atom_wise", generator=_generator(generator)).to(dev)


class HDNNP2ndInverseDistances(nn.Module):
    """An MLP (``mlp``) on each molecule's flattened upper-triangle pair
    distances (the reference's ``make_model_inverse_distances``, which
    hardcodes 15 atoms): molecules padded to ``max_nodes`` atoms give
    ``max_nodes (max_nodes - 1) / 2`` inputs. A batch padded to fewer atoms
    is padded on to ``max_nodes`` (the answer of the same molecules batched
    with ``max_nodes=max_nodes``); a batch with a larger molecule raises.
    The JAX model takes its width from its first batch and accepts no
    batch of another width."""

    def __init__(self, config: Dict[str, Any], max_nodes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.max_nodes = int(max_nodes)
        self.register_buffer("pairs", torch.triu_indices(self.max_nodes, self.max_nodes, 1),
                             persistent=False)
        self.mlp = MLP(self.pairs.shape[1], config["mlp_kwargs"]["units"],
                       activation=config["mlp_kwargs"]["activation"], generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        if batch.max_nodes > self.max_nodes:
            raise ValueError(f"the batch holds a molecule of {batch.max_nodes} atoms; the "
                             f"model was built for max_nodes={self.max_nodes}")
        pos = flat_to_padded(batch.nodes["node_coordinates"], batch)  # (G, M, 3)
        pos = F.pad(pos, (0, 0, 0, self.max_nodes - pos.shape[1]))
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
        return {"output": self.mlp(d[:, self.pairs[0], self.pairs[1]])}


def make_model_inverse_distances(device: DeviceLike = None,
                                 generator: Optional[torch.Generator] = None,
                                 max_nodes: int = 15,
                                 **kwargs) -> HDNNP2ndInverseDistances:
    """:class:`HDNNP2ndInverseDistances` with the atom-wise defaults
    updated by ``kwargs`` (its ``mlp_kwargs`` units and activations), for
    molecules padded to ``max_nodes`` atoms (the reference's 15 by
    default)."""
    dev = resolve_device(device)
    cfg = update_model_kwargs(model_default_atom_wise, kwargs)
    return HDNNP2ndInverseDistances(cfg, max_nodes, generator=_generator(generator)).to(dev)


def make_model(device: DeviceLike = None,
               generator: Optional[torch.Generator] = None, **kwargs) -> HDNNP2nd:
    """The weighted variant, the JAX package's default (as the reference's
    ``make_model = make_model_weighted``)."""
    return make_model_weighted(device=device, generator=generator, **kwargs)
