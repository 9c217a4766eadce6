"""Model constructors by name and config helpers; counterpart of
``gcnn_keras_tpu/models/registry.py`` (``get_model_class``,
``make_model_by_name``, ``update_model_kwargs``, ``register_model``).

A name is a model module's short name (``"Schnet"``), or a path that ends
in one (``"kgcnn.literature.Schnet"``); a name the table does not hold is
imported as a module path, one under ``gcnn_keras_tpu.`` from the port's
package of the same layout. The port holds all twenty-six of the JAX
package's model modules, each with every builder of its JAX module
(HDNNP2nd's ``make_model``, ``make_model_weighted``, ``make_model_behler``,
``make_model_atom_wise`` and ``make_model_inverse_distances`` among them;
GIN's ``make_model_edge``; GAT's ``make_model_v2``; the
``make_crystal_model`` of NMPN, CGCNN, Megnet and DimeNet++;
``GNNExplain``'s ``make_model``, a ``GNNExplainer``).
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

from ..utils.port_modules import port_path

# the builders ``register_model`` records, by name (as in the JAX package,
# ``get_model_class`` does not read it)
_REGISTRY: Dict[str, Callable] = {}

# module name -> import path, the JAX package's table
_MODULES = {
    "GCN": "gcnn_keras_tpu_torch.models.gcn",
    "GIN": "gcnn_keras_tpu_torch.models.gin",
    "GAT": "gcnn_keras_tpu_torch.models.gat",
    "GATv2": "gcnn_keras_tpu_torch.models.gatv2",
    "GraphSAGE": "gcnn_keras_tpu_torch.models.sage",
    "Schnet": "gcnn_keras_tpu_torch.models.schnet",
    "PAiNN": "gcnn_keras_tpu_torch.models.painn",
    "HDNNP2nd": "gcnn_keras_tpu_torch.models.hdnnp2nd",
    "HDNNP4th": "gcnn_keras_tpu_torch.models.hdnnp4th",
    "RGCN": "gcnn_keras_tpu_torch.models.rgcn",
    "GNNFilm": "gcnn_keras_tpu_torch.models.gnnfilm",
    "INorp": "gcnn_keras_tpu_torch.models.inorp",
    "DMPNN": "gcnn_keras_tpu_torch.models.dmpnn",
    "CMPNN": "gcnn_keras_tpu_torch.models.cmpnn",
    "NMPN": "gcnn_keras_tpu_torch.models.nmpn",
    "AttentiveFP": "gcnn_keras_tpu_torch.models.attentivefp",
    "HamNet": "gcnn_keras_tpu_torch.models.hamnet",
    "MEGAN": "gcnn_keras_tpu_torch.models.megan",
    "DimeNetPP": "gcnn_keras_tpu_torch.models.dimenet_pp",
    "Megnet": "gcnn_keras_tpu_torch.models.megnet",
    "CGCNN": "gcnn_keras_tpu_torch.models.cgcnn",
    "EGNN": "gcnn_keras_tpu_torch.models.egnn",
    "MXMNet": "gcnn_keras_tpu_torch.models.mxmnet",
    "MAT": "gcnn_keras_tpu_torch.models.mat",
    "Unet": "gcnn_keras_tpu_torch.models.unet",
    "GNNExplain": "gcnn_keras_tpu_torch.models.gnnexplain",
}


def register_model(name: str):
    """A decorator that records its function in ``_REGISTRY`` under
    ``name`` and returns it unchanged."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_model_class(module_name: str, class_name: str = "make_model") -> Callable:
    """The function ``class_name`` (``make_model`` by default) of a model
    module."""
    short = module_name.split(".")[-1]
    mod = importlib.import_module(port_path(_MODULES.get(short, module_name)))
    return getattr(mod, class_name)


def make_model_by_name(module_name: str, class_name: str = "make_model",
                       config: Dict[str, Any] | None = None, **kwargs):
    """``get_model_class(module_name, class_name)(**config, **kwargs)``;
    ``kwargs`` are the port's ``device`` and ``generator``."""
    return get_model_class(module_name, class_name)(**(config or {}), **kwargs)


def update_model_kwargs(defaults: Dict[str, Any], kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Nested-default merge: a dict value updates the default dict of the
    same key one level deep; any other value replaces it."""
    out = dict(defaults)
    for k, v in (kwargs or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            merged = dict(out[k])
            merged.update(v)
            out[k] = merged
        else:
            out[k] = v
    return out
