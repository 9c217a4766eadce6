"""Checkpoints; counterpart of ``gcnn_keras_tpu/utils/checkpoint.py``
(``save_checkpoint``, ``load_checkpoint``).

The layout is the JAX package's, ``<directory>/step_<n>``; the file in it,
``checkpoint.pt``, is ``torch.save`` of the model's ``state_dict`` under
``"params"``, the optimizer's ``state_dict`` under ``"opt_state"`` and any
``extra`` (numbers, strings, lists and dicts of them). The JAX package
writes orbax, which the port cannot read or write.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn

FILE_NAME = "checkpoint.pt"


def save_checkpoint(directory: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0, **extra) -> str:
    """Save ``model``'s parameters (and ``optimizer``'s state, and
    ``extra``) as ``<directory>/step_<step>``; returns that path."""
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    payload = {"params": model.state_dict()}
    if optimizer is not None:
        payload["opt_state"] = optimizer.state_dict()
    if extra:
        payload["extra"] = extra
    torch.save(payload, os.path.join(path, FILE_NAME))
    return path


def load_checkpoint(directory: str, step: Optional[int] = None,
                    map_location=None) -> dict:
    """The checkpoint at ``step`` (the latest if None), its tensors on
    ``map_location`` (where they were saved if None): ``{"params":
    state_dict, "opt_state": ..., "extra": ...}``."""
    base = os.path.abspath(directory)
    if step is None:
        steps = [int(d.split("_")[1]) for d in os.listdir(base) if d.startswith("step_")]
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {base}")
        step = max(steps)
    return torch.load(os.path.join(base, f"step_{step}", FILE_NAME),
                      map_location=map_location, weights_only=True)
