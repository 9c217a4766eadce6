"""The epoch loop with validation, early stopping, wandb and timing;
counterpart of ``gcnn_keras_tpu/training/fit.py`` (``fit_model``), the
``model.fit(callbacks=[...])`` of the reference scripts.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..utils.wandb_wizard import log_wandb
from .callbacks import EarlyStopping, TrainingTimer


def fit_model(trainer, state, epoch_batches, eval_fn: Optional[Callable],
              epochs: int, *, steps_per_dispatch: int = 1,
              early_stopping: int = 0, monitor: str = "val_loss",
              min_delta: float = 0.0, verbose_every: int = 10,
              fold: int = 0, wandb_prefix: str = "",
              timer: Optional[TrainingTimer] = None):
    """Run ``epochs`` epochs of ``trainer.fit_epoch``, validating after each.

    - ``epoch_batches``: an iterable of batches, or a callable returning one
      (called anew each epoch, as a reshuffling loader).
    - ``eval_fn(params) -> {metric: float}``: validation metrics for the
      history (``params`` is ``state.params``); ``None`` validates nothing.
    - ``early_stopping``: patience in epochs, 0 for none. When it stops the
      run, the best epoch's parameters are copied back into the state, and
      only then (keras' ``restore_best_weights``).
    - ``steps_per_dispatch`` goes to ``fit_epoch`` unchanged.
    - Each epoch's metrics go to ``log_wandb``, a no-op unless
      ``init_wandb`` started a run.

    Returns ``(state, hist)``, ``hist[k]`` the per-epoch values of metric
    ``k`` (the training metrics, the validation metrics and
    ``epoch_time``, seconds).
    """
    stopper = EarlyStopping(monitor=monitor, patience=early_stopping,
                            min_delta=min_delta, restore_best_weights=True) \
        if early_stopping and early_stopping > 0 else None
    stopped = False
    timer = timer or TrainingTimer()
    hist: Dict[str, List[float]] = {"epoch_time": []}

    def record(metrics: Dict[str, float]):
        for k, v in metrics.items():
            hist.setdefault(k, []).append(float(v))

    for epoch in range(epochs):
        timer.epoch_begin()
        batches = epoch_batches() if callable(epoch_batches) else epoch_batches
        state, train_metrics = trainer.fit_epoch(
            state, batches, steps_per_dispatch=steps_per_dispatch)
        val_metrics = eval_fn(state.params) if eval_fn is not None else {}
        timer.epoch_end()
        record(train_metrics)
        record(val_metrics)
        hist["epoch_time"].append(timer.epoch_times[-1])
        metrics = {**train_metrics, **val_metrics}
        log_wandb({f"{wandb_prefix}{k}": float(v) for k, v in metrics.items()}, step=epoch)
        if verbose_every and (epoch % verbose_every == 0 or epoch == epochs - 1):
            parts = [f"{k}={float(v):.4f}" for k, v in metrics.items()]
            print(f"fold {fold} epoch {epoch}: " + " ".join(parts), flush=True)
        if stopper is not None and stopper.update(epoch, metrics, state.params):
            print(f"fold {fold}: early stopping at epoch {epoch} "
                  f"(best {monitor}={stopper.sign * stopper.best:.4f})", flush=True)
            stopped = True
            break

    if stopped:
        stopper.restore(state.params)
    return state, hist
