"""Model constructors by name and config helpers; counterpart of
``gcnn_keras_tpu/models/registry.py`` (``get_model_class``,
``make_model_by_name``, ``update_model_kwargs``).

A name is a model module's short name (``"Schnet"``), or a path that ends
in one (``"kgcnn.literature.Schnet"``); a name the table does not hold is
imported as a module path, one under ``gcnn_keras_tpu.`` from the port's
package of the same layout. The port holds five of the JAX package's model
modules; the others raise ``ValueError``, by short name or by file.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

# module name -> import path, the ported part of the JAX package's table
_MODULES = {
    "GCN": "gcnn_keras_tpu_torch.models.gcn",
    "Schnet": "gcnn_keras_tpu_torch.models.schnet",
    "PAiNN": "gcnn_keras_tpu_torch.models.painn",
    "HDNNP2nd": "gcnn_keras_tpu_torch.models.hdnnp2nd",
    "HDNNP4th": "gcnn_keras_tpu_torch.models.hdnnp4th",
}
# the rest of the JAX package's table, not ported yet: module name -> file
_ZOO = {"GIN": "gin", "GAT": "gat", "GATv2": "gatv2", "GraphSAGE": "sage",
        "DimeNetPP": "dimenet_pp", "Megnet": "megnet", "NMPN": "nmpn",
        "AttentiveFP": "attentivefp", "DMPNN": "dmpnn", "CGCNN": "cgcnn", "EGNN": "egnn",
        "RGCN": "rgcn", "GNNFilm": "gnnfilm", "INorp": "inorp", "MXMNet": "mxmnet",
        "HamNet": "hamnet", "MAT": "mat", "CMPNN": "cmpnn", "Unet": "unet",
        "MEGAN": "megan", "GNNExplain": "gnnexplain"}


def get_model_class(module_name: str, class_name: str = "make_model") -> Callable:
    """The function ``class_name`` (``make_model`` by default) of a model
    module."""
    short = module_name.split(".")[-1]
    if short in _ZOO or short in _ZOO.values():
        raise ValueError(f"model module {short!r} is not ported yet "
                         "(ROADMAP.md, 'the rest of the zoo')")
    path = _MODULES.get(short, module_name)
    if path.startswith("gcnn_keras_tpu."):
        path = "gcnn_keras_tpu_torch." + path[len("gcnn_keras_tpu."):]
    mod = importlib.import_module(path)
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
