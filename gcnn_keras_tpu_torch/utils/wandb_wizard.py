"""Weights & Biases logging; counterpart of
``gcnn_keras_tpu/utils/wandb_wizard.py``: a no-op where ``wandb`` is not
installed or the run was not started."""
from __future__ import annotations

from typing import Any, Dict, Optional

_run = None  # the wandb module while a run is active


def init_wandb(project: str, name: Optional[str] = None,
               config: Optional[Dict[str, Any]] = None, enabled: bool = True,
               **kwargs):
    """Start a run; returns it, or None without ``wandb`` or ``enabled``."""
    global _run
    _run = None
    if not enabled:
        return None
    try:
        import wandb
    except ImportError:
        return None
    run = wandb.init(project=project, name=name, config=config, **kwargs)
    _run = wandb
    return run


def log_wandb(metrics: Dict[str, Any], step: Optional[int] = None):
    if _run is not None:
        _run.log(metrics, step=step)


def finish_wandb():
    global _run
    if _run is not None:
        _run.finish()
    _run = None
