"""HDNNP 4th generation: charge equilibration, long-range electrostatics and
QM/MM embedding (Ko et al. 2021); counterpart of
``gcnn_keras_tpu/models/hdnnp4th.py``.

ACSF G2+G4 -> concat ESP -> a per-element network for the
electronegativity chi -> chi + ESP -> CENT charge solve and screened
electrostatic energy -> QM/MM energy -> concat(rep, q) -> a per-element
network for local energies -> sum over each molecule;
``E = E_short + E_elec + E_qmmm``, with the charges as a second output.

Submodule names follow the flax tree (``acsf_g2``, ``acsf_g4``,
``mlp_charge``, ``mlp_local``, ``cent_electrostatic.cent_charge``,
``cent_electrostatic.electrostatic_energy``, ``norm``, ``output_mlp``) so
that ``utils/convert.py`` maps one onto the other. A non-empty
``normalize_kwargs`` puts a ``GraphBatchNorm`` over concat(rep, ESP); the
models' ``train`` argument is the JAX call's, which that layer keys on.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.acsf import ACSFG2, ACSFG4
from ..layers.conv.hdnnp_electro import (
    CENTChargePlusElectrostaticEnergy, electrostatic_qmmm_energy,
)
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
    mlp_charge_kwargs={"units": [64, 64, 1], "num_relations": 96,
                       "activation": ["swish", "swish", "linear"]},
    mlp_local_kwargs={"units": [64, 64, 1], "num_relations": 96,
                      "activation": ["swish", "swish", "linear"]},
    cent_kwargs={},
    electrostatic_kwargs={"param_trainable": False},
    qmmm_kwargs={},
    node_pooling_args={"pooling_method": "sum"},
    output_embedding="charge+qm_energy",
    use_output_mlp=False,
    output_mlp={"units": [64, 1], "activation": ["swish", "linear"]},
    energy_mean_and_var=None,
)

# keras plumbing keys the reference's electrostatic layers accept that have
# no counterpart here (initializers resolve through use_physical_params;
# constraints and regularizers belong to training)
_ELECTRO_IGNORED = {"name", "param_initializer", "param_regularizer",
                    "param_constraint", "output_to_tensor", "add_eps"}
_ELECTRO_KNOWN = {"param_trainable", "use_physical_params", "multiplicity",
                  "solver", "dense_impl", "cg_tol"} | _ELECTRO_IGNORED

def _electro_opts(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``cent_kwargs`` merged with ``electrostatic_kwargs``, as the reference
    builds ``CENTChargePlusElectrostaticEnergy(**cent_kwargs,
    **electrostatic_kwargs)``; an unknown key raises ``ValueError``."""
    merged = {**(cfg.get("cent_kwargs") or {}),
              **(cfg.get("electrostatic_kwargs") or {})}
    unknown = set(merged) - _ELECTRO_KNOWN
    if unknown:
        raise ValueError(
            f"Unknown electrostatic/cent kwargs: {sorted(unknown)}; "
            f"supported: {sorted(_ELECTRO_KNOWN - _ELECTRO_IGNORED)}")
    return {k: merged[k] for k in ("param_trainable", "use_physical_params",
                                   "multiplicity", "solver", "dense_impl",
                                   "cg_tol")
            if k in merged}


def _norm(cfg: Dict[str, Any], width: int) -> Optional[GraphBatchNorm]:
    """The ``GraphBatchNorm`` over ``width`` columns of a truthy
    ``normalize_kwargs``; an EMPTY dict means no normalization layer, as in
    the JAX package."""
    return GraphBatchNorm(width, **cfg["normalize_kwargs"]) \
        if cfg.get("normalize_kwargs") else None


def _esp(batch: GraphBatch, like: Tensor) -> Tensor:
    esp = batch.nodes.get("esp")
    if esp is None:
        return like.new_zeros(batch.n_node)
    return esp.reshape(batch.n_node, -1)[:, 0]


def _acsf(cfg: Dict[str, Any]) -> Tuple[ACSFG2, ACSFG4]:
    return (ACSFG2(**ACSFG2.make_param_table(**cfg["g2_kwargs"])),
            ACSFG4(**ACSFG4.make_param_table(**cfg["g4_kwargs"])))


class _ChargeEnergyCore(nn.Module):
    """chi network -> CENT solve and electrostatics -> QM/MM -> local
    energies; the block shared by the Behler and the learn models. Its
    submodules sit on the parent model (flax names them there)."""

    def _build_core(self, cfg: Dict[str, Any], rep_features: int,
                    generator: Optional[torch.Generator]) -> None:
        self.mlp_charge = RelationalMLP(rep_features, **cfg["mlp_charge_kwargs"],
                                        generator=generator)
        self.cent_electrostatic = CENTChargePlusElectrostaticEnergy(
            **_electro_opts(cfg), generator=generator)
        self.mlp_local = RelationalMLP(rep_features + 1, **cfg["mlp_local_kwargs"],
                                       generator=generator)
        self.output_mlp = MLP(self.mlp_local.out_features, cfg["output_mlp"]["units"],
                              activation=cfg["output_mlp"]["activation"],
                              generator=generator) if cfg["use_output_mlp"] else None

    def _charge_energy(self, batch: GraphBatch, rep: Tensor, esp: Tensor,
                       z: Tensor) -> Dict[str, Tensor]:
        chi = self.mlp_charge(rep, z)
        q, e_elec = self.cent_electrostatic(batch, chi[:, 0] + esp)
        e_qmmm = electrostatic_qmmm_energy(batch, q, esp)
        local_e = self.mlp_local(torch.cat([rep, q[:, None]], dim=-1), z)
        local_e = local_e * batch.node_mask[:, None].to(local_e.dtype)
        e_short = pool_nodes_to_graph(batch, local_e, **self.config["node_pooling_args"])
        return {"charge": q, "output": e_short + e_elec + e_qmmm,
                "electrostatic_energy": e_elec, "qmmm_energy": e_qmmm,
                "short_range_energy": e_short}


class HDNNP4th(_ChargeEnergyCore):
    """The Behler-mode model: ACSF descriptors computed from the batch."""

    def __init__(self, config: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.acsf_g2, self.acsf_g4 = _acsf(config)
        width = self.acsf_g2.out_features + self.acsf_g4.out_features + 1
        self.norm = _norm(config, width)
        self._build_core(config, width, generator)

    def representation(self, batch: GraphBatch) -> Tuple[Tensor, Tensor, Tensor]:
        """``(rep (N, G2+G4+1), esp (N,), z (N,))``: the descriptors with
        the ESP as their last column."""
        z = batch.nodes["node_number"].to(torch.int32)
        pos = batch.nodes["node_coordinates"]
        esp = _esp(batch, pos)
        rep = torch.cat([self.acsf_g2(batch, z=z), self.acsf_g4(batch, z=z),
                         esp[:, None]], dim=-1)
        return rep, esp, z

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        rep, esp, z = self.representation(batch)
        if self.norm is not None:
            rep = self.norm(rep, batch.node_mask, train)
        result = self._charge_energy(batch, rep, esp, z)
        e_total = result["output"]
        if cfg.get("energy_mean_and_var"):
            mean, var = cfg["energy_mean_and_var"]
            e_total = e_total * torch.sqrt(torch.as_tensor(var, dtype=e_total.dtype,
                                                           device=e_total.device)) + mean
        if self.output_mlp is not None:
            e_total = self.output_mlp(e_total)
        result["output"] = e_total
        if cfg["output_embedding"] == "charge":
            result["output"] = result["charge"]
        elif cfg["output_embedding"] == "electrostatic_energy":
            result["output"] = result["electrostatic_energy"]
        # 'graph', 'total_energy' and 'charge+qm_energy' keep the energy
        return result


def _build(cls, cfg: Dict[str, Any], device: DeviceLike,
           generator: Optional[torch.Generator]):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return cls(cfg, generator=generator).to(dev)


def make_model_behler(device: DeviceLike = None,
                      generator: Optional[torch.Generator] = None,
                      **kwargs) -> HDNNP4th:
    """HDNNP4th (Behler mode) with the JAX package's defaults updated by
    ``kwargs``, on ``device`` (the CUDA card unless ``device="cpu"``).
    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
    if None)."""
    return _build(HDNNP4th, update_model_kwargs(model_default_behler, kwargs),
                  device, generator)


def make_model(device: DeviceLike = None,
               generator: Optional[torch.Generator] = None, **kwargs) -> HDNNP4th:
    return make_model_behler(device=device, generator=generator, **kwargs)


def make_model_behler_charge_separat(device: DeviceLike = None,
                                     generator: Optional[torch.Generator] = None,
                                     **kwargs) -> Tuple[HDNNP4th, HDNNP4th]:
    """Two models with one configuration: ``(charge_model, energy_model)``;
    the first outputs the charges. Both draw from ``generator``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cfg = update_model_kwargs(model_default_behler, kwargs)
    return (_build(HDNNP4th, dict(cfg, output_embedding="charge"), device, generator),
            _build(HDNNP4th, cfg, device, generator))


model_default_rep = dict(
    g2_kwargs=model_default_behler["g2_kwargs"],
    g4_kwargs=model_default_behler["g4_kwargs"],
)


class HDNNP4thRep(nn.Module):
    """The symmetry functions alone, ``concat(G2, G4)`` per atom, with no
    weights: computed once per dataset for :class:`HDNNP4thLearn`."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = config
        self.acsf_g2, self.acsf_g4 = _acsf(config)
        self.out_features = self.acsf_g2.out_features + self.acsf_g4.out_features

    def forward(self, batch: GraphBatch) -> Dict[str, Tensor]:
        z = batch.nodes["node_number"].to(torch.int32)
        rep = torch.cat([self.acsf_g2(batch, z=z), self.acsf_g4(batch, z=z)], dim=-1)
        return {"output": rep, "rep": rep}


def make_model_rep(device: DeviceLike = None, **kwargs) -> HDNNP4thRep:
    dev = resolve_device(device)
    return HDNNP4thRep(update_model_kwargs(model_default_rep, kwargs)).to(dev)


model_default_learn = dict(
    normalize_kwargs={},
    mlp_charge_kwargs=model_default_behler["mlp_charge_kwargs"],
    mlp_local_kwargs=model_default_behler["mlp_local_kwargs"],
    cent_kwargs={},
    electrostatic_kwargs={"param_trainable": False},
    qmmm_kwargs={},
    node_pooling_args={"pooling_method": "sum"},
    output_embedding="graph",
    use_output_mlp=False,
    output_mlp={"units": [64, 1], "activation": ["swish", "linear"]},
    # the width of nodes['rep']; the JAX package reads it from the first
    # batch, a torch module needs it when it is built. The default is the
    # width make_model_rep() gives.
    rep_features=HDNNP4thRep(model_default_rep).out_features,
)


class HDNNP4thLearn(_ChargeEnergyCore):
    """The learnable half of the rep/learn split: takes the precomputed
    ``nodes['rep']`` and ``nodes['esp']`` and runs concat(rep, esp) -> chi
    -> CENT solve and electrostatics -> QM/MM -> local energies."""

    def __init__(self, config: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.norm = _norm(config, config["rep_features"] + 1)
        self._build_core(config, config["rep_features"] + 1, generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        z = batch.nodes["node_number"].to(torch.int32)
        rep = batch.nodes["rep"]
        if rep.shape[-1] != self.config["rep_features"]:
            raise ValueError(f"nodes['rep'] has {rep.shape[-1]} columns; the model "
                             f"was built for rep_features={self.config['rep_features']}")
        esp = _esp(batch, rep)
        rep_esp = torch.cat([rep, esp[:, None]], dim=-1)
        if self.norm is not None:
            rep_esp = self.norm(rep_esp, batch.node_mask, train)
        result = self._charge_energy(batch, rep_esp, esp, z)
        if self.output_mlp is not None:
            result["output"] = self.output_mlp(result["output"])
        return result


def make_model_learn(device: DeviceLike = None,
                     generator: Optional[torch.Generator] = None,
                     **kwargs) -> HDNNP4thLearn:
    cfg = update_model_kwargs(model_default_learn, kwargs)
    # as the reference, only the 'graph' embedding
    if cfg.get("output_embedding", "graph") != "graph":
        raise ValueError("Unsupported output embedding for mode `HDNNP4th` "
                         "make_model_learn: only 'graph' is supported.")
    return _build(HDNNP4thLearn, cfg, device, generator)
