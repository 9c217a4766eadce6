"""Composable hyper-config builders for the ``training/hyper/`` library;
counterpart of ``gcnn_keras_tpu/training/hyper_templates.py``, copied
whole: the library's configs import it by that module path, which the
port's ``HyperParameter`` reads as this module (``training/hyper.py``).

The reference ships 29 standalone per-dataset config files
(``training/hyper/hyper_*.py``, e.g. ``hyper_esol.py``), each a dict keyed by
model name with ``model``/``data``/``training`` sections. Rather than
duplicating those dicts, this module provides archetype builders that the
per-dataset files compose; the result has the same shape the reference's
``HyperParameter`` consumes (``kgcnn/hyper/hyper.py:15``).

Archetypes:
- ``molnet``   — graph-level prediction from node/edge attributes
                 (MoleculeNet/TUDataset-style inputs).
- ``qm``       — geometric graph regression from atomic numbers + coordinates
                 (QM7/QM9-style, ``set_range`` neighbor lists).
- ``crystal``  — periodic variants via ``make_crystal_model``.
- ``force``    — energy+force training via EnergyForceModel wrapping.
- ``citation`` — single-graph node classification.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence


def _merge(base: dict, override: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def model_section(module_name: str, class_name: str = "make_model",
                  **config) -> Dict[str, Any]:
    return {"class_name": class_name, "module_name": module_name,
            "config": config}


def data_section(class_name: str, config: Optional[dict] = None,
                 methods: Optional[List[dict]] = None) -> Dict[str, Any]:
    d: Dict[str, Any] = {"dataset": {"class_name": class_name,
                                     "config": config or {}}}
    if methods:
        d["dataset"]["methods"] = methods
    return d


def training_section(epochs: int = 300, batch_size: int = 32,
                     learning_rate: Any = 1e-3,
                     optimizer: str = "Adam",
                     loss: Optional[str] = None,
                     loss_weights: Optional[dict] = None,
                     scaler: Optional[str] = None,
                     n_splits: int = 5,
                     **extra) -> Dict[str, Any]:
    t: Dict[str, Any] = {
        "fit": {"batch_size": batch_size, "epochs": epochs},
        "compile": {"optimizer": {"class_name": optimizer,
                                  "config": {"learning_rate": learning_rate}}},
        "cross_validation": {"class_name": "KFold",
                             "config": {"n_splits": n_splits,
                                        "random_state": 42, "shuffle": True}},
    }
    if loss:
        t["compile"]["loss"] = loss
    if loss_weights:
        t["compile"]["loss_weights"] = loss_weights
    if scaler:
        t["scaler"] = {"class_name": scaler}
    t.update(extra)
    return t


# --- per-model config blocks -------------------------------------------------
# Keyed by registry module name; values are kwargs understood by the
# corresponding ``make_model`` (defaults mirror each module's model_default).

def _out(units: Sequence[int], activation: Sequence[str]) -> dict:
    return {"units": list(units), "activation": list(activation)}


_MOLNET_MODELS: Dict[str, dict] = {
    "GCN": dict(depth=3, gcn_args={"units": 100}),
    "GAT": dict(depth=2, attention_heads_num=5,
                attention_args={"units": 64}),
    "GATv2": dict(depth=2, attention_heads_num=5,
                  attention_args={"units": 64}),
    "GIN": dict(depth=5, gin_mlp=_out([64, 64], ["relu", "linear"]),
                last_mlp=_out([64, 32], ["relu", "relu"])),
    "GraphSAGE": dict(depth=3,
                      node_mlp_args=_out([64, 32], ["relu", "linear"]),
                      edge_mlp_args={"units": 64, "activation": "relu"}),
    "DMPNN": dict(depth=5, edge_initialize={"units": 128},
                  edge_dense={"units": 128}),
    "CMPNN": dict(depth=5, node_initialize={"units": 300},
                  edge_initialize={"units": 300}),
    "AttentiveFP": dict(depthato=2, depthmol=3, dropout=0.2,
                        attention_args={"units": 200}),
    "INorp": dict(depth=3, node_mlp_args=_out([100, 50], ["relu", "linear"])),
    "HamNet": dict(depth=1, message_kwargs={"units": 128, "units_edge": 128},
                   gru_kwargs={"units": 128},
                   fingerprint_kwargs={"units": 128, "units_attend": 128,
                                       "depth": 2}),
    "Schnet": dict(depth=4, interaction_args={"units": 128},
                   gauss_args={"bins": 20, "distance_max": 4.0}),
    "Megnet": dict(nblocks=3),
    "PAiNN": dict(depth=3, conv_args={"units": 128},
                  update_args={"units": 128}),
    "DimeNetPP": dict(num_blocks=4, emb_size=64, out_emb_size=128,
                      int_emb_size=32, basis_emb_size=8),
    "NMPN": dict(depth=3, use_set2set=True, node_dim=64),
    "MAT": dict(depth=5, heads=8, embedding_units=64),
    "MEGAN": dict(units=[32, 32, 32], importance_channels=2),
    "RGCN": dict(depth=5, dense_relation_kwargs={"units": 64,
                                                 "num_relations": 20}),
    "GNNFilm": dict(depth=5,
                    dense_relation_kwargs={"units": 64, "num_relations": 20},
                    dense_modulation_kwargs={"units": 64,
                                             "num_relations": 20}),
    "MXMNet": dict(depth=4, units=64),
    "EGNN": dict(depth=4),
    "Unet": dict(depth=4, hidden_dim={"units": 32}),
    "HDNNP2nd": dict(),
}

# geometric models usable on QM-style inputs (node_number + coordinates +
# range_indices); Schnet/Megnet/NMPN compute distances themselves.
_QM_OVERRIDES: Dict[str, dict] = {
    "Schnet": dict(make_distance=True, expand_distance=True),
    "Megnet": dict(make_distance=True, expand_distance=True),
    "NMPN": dict(make_distance=True, expand_distance=True,
                 use_set2set=True),
    "PAiNN": {},
    "DimeNetPP": {},
    "MXMNet": {},
    "EGNN": {},
    "MEGAN": {},
    "HDNNP2nd": {},
}


def molnet_model(name: str, output_units: int = 1,
                 output_activation: str = "linear",
                 overrides: Optional[dict] = None) -> Dict[str, Any]:
    """Model section for graph-level prediction on attribute graphs."""
    cfg = copy.deepcopy(_MOLNET_MODELS[name])
    module, _, class_name = name.partition(".")
    if name == "MEGAN":
        cfg["final_units"] = [16, output_units]
        cfg["final_activation"] = output_activation
    else:
        cfg["output_mlp"] = _out([64, 32, output_units],
                                 ["relu", "relu", output_activation])
    cfg["output_embedding"] = "graph"
    cfg = _merge(cfg, overrides)
    return {"model": model_section(module, class_name or "make_model", **cfg)}


def qm_model(name: str, output_units: int = 1,
             overrides: Optional[dict] = None) -> Dict[str, Any]:
    """Model section for geometric regression (QM-style datasets)."""
    cfg = _merge(_MOLNET_MODELS.get(name, {}), _QM_OVERRIDES.get(name, {}))
    if name == "MEGAN":
        cfg["final_units"] = [16, output_units]
        cfg["final_activation"] = "linear"
        cfg.pop("output_mlp", None)
    elif name == "DimeNetPP":
        cfg["num_targets"] = output_units
        cfg.pop("output_mlp", None)
    elif name == "HDNNP2nd":
        cfg = dict(
            g2_kwargs={"eta": [0.0, 0.08, 0.3], "rs": [0.0, 3.0, 5.0],
                       "rc": 6.0, "elements": [1, 6, 7, 8, 9, 16, 17]},
            g4_kwargs={"eta": [0.0, 0.06], "lamda": [-1.0, 1.0],
                       "zeta": [1.0, 4.0], "rc": 6.0,
                       "elements": [1, 6, 7, 8, 9, 16, 17],
                       "multiplicity": 2.0},
            mlp_kwargs={"units": [128, 128, output_units],
                        "num_relations": 96,
                        "activation": ["swish", "swish", "linear"]},
        )
    else:
        cfg["output_mlp"] = _out([128, 64, output_units],
                                 ["swish", "swish", "linear"])
    cfg["output_embedding"] = "graph"
    cfg = _merge(cfg, overrides)
    return {"model": model_section(name, "make_model", **cfg)}


def crystal_model(name: str, output_units: int = 1,
                  overrides: Optional[dict] = None) -> Dict[str, Any]:
    """Model section for periodic crystals via ``make_crystal_model``."""
    cfg = _merge(_MOLNET_MODELS.get(name, {}), _QM_OVERRIDES.get(name, {}))
    if name == "DimeNetPP":
        cfg["num_targets"] = output_units
        cfg.pop("output_mlp", None)
    else:
        cfg["output_mlp"] = _out([128, 64, output_units],
                                 ["swish", "swish", "linear"])
    cfg["output_embedding"] = "graph"
    cfg = _merge(cfg, overrides)
    return {"model": model_section(name, "make_crystal_model", **cfg)}


def force_model(name: str, overrides: Optional[dict] = None) -> Dict[str, Any]:
    """Energy model section for EnergyForceModel training (the driver wraps
    the model — parity with reference keys like ``Schnet.EnergyForceModel``)."""
    m = qm_model(name, output_units=1, overrides=overrides)
    m["model"]["energy_force"] = True
    return m


def citation_model(name: str, num_classes: int,
                   overrides: Optional[dict] = None) -> Dict[str, Any]:
    """Model section for single-graph node classification."""
    cfg = copy.deepcopy(_MOLNET_MODELS[name])
    cfg["output_embedding"] = "node"
    cfg["output_mlp"] = _out([64, num_classes], ["relu", "linear"])
    cfg = _merge(cfg, overrides)
    return {"model": model_section(name, "make_model", **cfg)}


def compose(models: Dict[str, dict], data: dict, training: dict,
            per_model_training: Optional[Dict[str, dict]] = None
            ) -> Dict[str, dict]:
    """Assemble the final ``hyper`` dict: one entry per model key, each with
    model/data/training sections (reference file shape)."""
    out = {}
    for key, m in models.items():
        t = _merge(training, (per_model_training or {}).get(key))
        out[key] = {"model": m["model"], "data": copy.deepcopy(data),
                    "training": t}
    return out
