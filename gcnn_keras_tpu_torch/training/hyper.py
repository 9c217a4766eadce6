"""Hyperparameter configuration; counterpart of
``gcnn_keras_tpu/training/hyper.py`` (``HyperParameter``, ``Adan``).

A config (a ``.py`` file defining ``hyper``, a ``.json`` or a ``.yaml``
file, or a dict) has ``model``/``data``/``training`` sections, possibly
keyed by model name. ``make_model`` builds the model through
``models/registry.py`` on the CUDA card unless ``device="cpu"``;
``make_optimizer`` returns a function of the parameters that builds the
optimizer of ``training.compile.optimizer`` with optax's update rule
(``training/optimizers.py``). A serialized schedule (``{"class_name",
"config"}``) as the learning rate goes through ``training/schedules.py``.

A ``.py`` config runs with its imports of the JAX package read as the
port's: ``from gcnn_keras_tpu.training.hyper_templates import ...`` (as
29 of the 30 files of the ``training/hyper`` library begin) takes
``gcnn_keras_tpu_torch.training.hyper_templates``, and any other
``gcnn_keras_tpu.X`` the port's ``X``, or raises ``ValueError`` naming
the module where the port has none. The file is not changed, and
``sys.modules`` gains no module of the JAX package.
"""
from __future__ import annotations

import builtins
import json
import os
import types
from typing import Any, Callable, Optional

from ..utils.port_modules import is_jax_path, port_module, port_path
from . import optimizers
from .optimizers import Adan  # noqa: F401  (the JAX package's name for it here)
from .schedules import get_schedule


def _import_as_port(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` with the JAX package's absolute module paths read as
    the port's; raises ``ValueError`` naming a module the port lacks."""
    if level == 0 and is_jax_path(name):
        port = port_module(name)
        if port is None:
            raise ValueError(f"the config imports {name}, which the port does not have "
                             f"({port_path(name)}; ROADMAP.md)")
        name = port
    return builtins.__import__(name, globals, locals, fromlist, level)


def _run_config(path: str) -> types.ModuleType:
    """The module of the ``.py`` config at ``path``, run with
    ``_import_as_port`` as its ``__import__``."""
    mod = types.ModuleType("hyper_config")
    mod.__file__ = os.path.abspath(path)
    mod.__builtins__ = dict(vars(builtins), __import__=_import_as_port)
    with open(path) as f:
        source = f.read()
    exec(compile(source, mod.__file__, "exec"), vars(mod))
    return mod


class HyperParameter:
    def __init__(self, hyper_info: Any, model_name: Optional[str] = None,
                 model_module: Optional[str] = None,
                 model_class: str = "make_model",
                 dataset_name: Optional[str] = None, **kwargs):
        if isinstance(hyper_info, str):
            self._hyper_all = self._load(hyper_info)
        elif isinstance(hyper_info, dict):
            self._hyper_all = dict(hyper_info)
        else:
            raise TypeError("hyper_info must be a path or dict")
        self.model_name = model_name
        self.model_module = model_module
        self.model_class = model_class
        self.dataset_name = dataset_name
        self._hyper = self._select(self._hyper_all)
        self.verify()

    @staticmethod
    def _load(path: str) -> dict:
        if path.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        if path.endswith((".yaml", ".yml")):
            import yaml
            with open(path) as f:
                return yaml.safe_load(f)
        if path.endswith(".py"):
            return _run_config(path).hyper
        raise ValueError(f"unknown config format: {path}")

    def _select(self, h: dict) -> dict:
        """The section of ``model_name`` where the config is keyed by
        model, the config itself where it has a ``model`` section, its one
        entry where it has one."""
        if self.model_name and self.model_name in h:
            return h[self.model_name]
        if "model" in h:
            return h
        if len(h) == 1:
            return next(iter(h.values()))
        return h

    def verify(self):
        """Raises if the model config names another model than
        ``model_name``."""
        h = self._hyper
        if "model" in h and self.model_name and h["model"].get("config", {}).get(
                "name") not in (None, self.model_name):
            raise ValueError(
                f"config model name {h['model']['config'].get('name')} != {self.model_name}")

    def __getitem__(self, key):
        return self._hyper[key]

    def __contains__(self, key):
        return key in self._hyper

    def make_model(self, **kwargs):
        """The model of the ``model`` section; ``kwargs`` are the port's
        ``device`` and ``generator``."""
        from ..models.registry import get_model_class
        m = self._hyper["model"]
        make = get_model_class(m.get("module_name", self.model_module or self.model_name),
                               m.get("class_name", self.model_class))
        return make(**m.get("config", {}), **kwargs)

    def make_optimizer(self, steps_per_epoch: int = 1) -> Callable:
        """A function of the parameters that builds the optimizer of
        ``training.compile.optimizer`` (Adam at 1e-3 by default): its
        ``class_name`` one of adam, adamw, nadam, sgd, rmsprop and adan,
        its ``config`` the ``learning_rate`` (a number or a serialized
        schedule) and any of ``b1``, ``b2``, ``b3``, ``weight_decay``,
        ``eps`` and ``momentum`` (others are ignored, as in the JAX
        package)."""
        compile_cfg = self._hyper.get("training", {}).get("compile", {})
        opt_cfg = compile_cfg.get("optimizer", {"class_name": "Adam",
                                                "config": {"learning_rate": 1e-3}})
        name = opt_cfg.get("class_name", "Adam").lower()
        cfg = dict(opt_cfg.get("config", {}))
        lr = cfg.pop("learning_rate", 1e-3)
        if isinstance(lr, dict):  # serialized schedule
            lr = get_schedule(lr["class_name"], **lr.get("config", {}))
        table = {
            "adam": optimizers.adam,
            "adamw": optimizers.adamw,
            "nadam": optimizers.nadam,
            "sgd": optimizers.sgd,
            "rmsprop": optimizers.rmsprop,
            "adan": optimizers.adan,
        }
        kwargs = {k: v for k, v in cfg.items()
                  if k in ("b1", "b2", "b3", "weight_decay", "eps", "momentum")}
        return table[name](lr, **kwargs)

    def results_file_path(self) -> str:
        """``results/<dataset_name>/<model_name>``, created."""
        base = os.path.join("results", self.dataset_name or "dataset",
                            f"{self.model_name or 'model'}")
        os.makedirs(base, exist_ok=True)
        return base

    def save(self, path: str):
        """The whole config as JSON."""
        with open(path, "w") as f:
            json.dump(self._hyper_all, f, indent=2, default=str)
