"""Callbacks of the epoch loop; counterpart of
``gcnn_keras_tpu/training/callbacks.py`` (``EarlyStopping`` with
restore-best-weights, ``TrainingTimer``)."""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch


class EarlyStopping:
    """Stops after ``patience`` epochs without a better ``monitor`` and,
    with ``restore_best_weights``, keeps a copy of the best epoch's
    parameters: the tensors of ``TrainState.params`` in their order (the
    JAX package keeps its params tree)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 10,
                 min_delta: float = 0.0, mode: str = "min",
                 restore_best_weights: bool = True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.sign = 1.0 if mode == "min" else -1.0
        self.restore_best_weights = restore_best_weights
        self.best: Optional[float] = None
        self.best_params: Optional[List[torch.Tensor]] = None
        self.wait = 0
        self.stopped_epoch: Optional[int] = None

    def update(self, epoch: int, metrics: dict, params: Sequence[torch.Tensor]) -> bool:
        """Returns True if training should stop."""
        value = self.sign * float(metrics[self.monitor])
        if self.best is None or value < self.best - self.min_delta:
            self.best = value
            self.wait = 0
            if self.restore_best_weights:
                self.best_params = [p.detach().clone() for p in params]
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                return True
        return False

    def restore(self, params: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        """Copy the best parameters into ``params`` in place."""
        if self.restore_best_weights and self.best_params is not None:
            with torch.no_grad():
                for p, best in zip(params, self.best_params):
                    p.copy_(best)
        return params


class TrainingTimer:
    """Wall-clock seconds per epoch."""

    def __init__(self):
        self.epoch_times: List[float] = []
        self._t0 = None

    def epoch_begin(self):
        self._t0 = time.perf_counter()

    def epoch_end(self):
        if self._t0 is not None:
            self.epoch_times.append(time.perf_counter() - self._t0)

    @property
    def mean_epoch_time(self) -> float:
        """The mean of ``epoch_times``, 0 before the first epoch ends."""
        return float(np.mean(self.epoch_times)) if self.epoch_times else 0.0
