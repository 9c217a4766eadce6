"""Training loop on one device; counterpart of
``gcnn_keras_tpu/training/trainer.py`` (``Trainer``, ``TrainState``).

A ``Trainer`` owns the optimizer and runs ``step(state, batch)``: the loss,
its gradients along the parameters by ``torch.autograd.grad`` (the
counterpart of ``jax.value_and_grad`` over the params tree), then the
optimizer's update of the parameters in place. PyTorch runs eagerly, so
there is no jit, no donation and no scan of several steps in one dispatch.
The data-parallel step over a mesh is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Tuple

import torch
import torch.nn as nn

Tensor = torch.Tensor

_NOT_PORTED_MESH = (
    "Trainer(mesh=...): the data-parallel step is not ported yet (ROADMAP.md, "
    "'Parallel'); run one device without a mesh")


@dataclasses.dataclass
class TrainState:
    """The parameters a step differentiates and updates in place, the
    optimizer that holds their moments, and the number of steps taken."""
    params: List[nn.Parameter]
    optimizer: torch.optim.Optimizer
    step: int = 0


class Trainer:
    """``loss_fn(batch) -> (loss, metrics)`` closes over the model, whose
    modules hold the parameters (the JAX package's ``loss_fn`` takes them as
    its first argument). ``optimizer`` makes the optimizer from the
    parameters: ``functools.partial(torch.optim.Adam, lr=1e-3)`` is
    ``optax.adam(1e-3)``, whose ``b1``, ``b2`` and ``eps`` are PyTorch's
    defaults."""

    def __init__(self, loss_fn: Callable,
                 optimizer: Callable[[List[nn.Parameter]], torch.optim.Optimizer],
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(_NOT_PORTED_MESH)
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def init_state(self, params: Iterable[nn.Parameter]) -> TrainState:
        params = [p for p in params if p.requires_grad]
        return TrainState(params=params, optimizer=self.optimizer(params))

    def step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Tensor]]:
        """One step: the loss, its gradients, the optimizer's update."""
        loss, metrics = self.loss_fn(batch)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        for p, g in zip(state.params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.optimizer.step()
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        return dataclasses.replace(state, step=state.step + 1), metrics

    def step_fn(self) -> Callable:
        """:meth:`step`, under the JAX package's name for its jitted step."""
        return self.step

    def fit_epoch(self, state: TrainState, batches, steps_per_dispatch: int = 1
                  ) -> Tuple[TrainState, Dict[str, float]]:
        """One step per batch; returns the state and each metric's mean
        over the steps. ``steps_per_dispatch`` keeps the JAX package's
        signature (steps per compiled dispatch) and changes nothing here:
        eager PyTorch runs K steps a dispatch as K sequential steps."""
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch={steps_per_dispatch} < 1")
        agg: Dict[str, float] = {}
        count = 0
        for batch in batches:
            state, metrics = self.step(state, batch)
            count += 1
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + float(v)
        return state, {k: v / max(count, 1) for k, v in agg.items()}
