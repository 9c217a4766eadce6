"""The training loop; counterpart of
``gcnn_keras_tpu/training/trainer.py`` (``Trainer``, ``TrainState``).

A ``Trainer`` owns the optimizer and runs ``step(state, batch)``: the loss,
its gradients along the parameters by ``torch.autograd.grad`` (the
counterpart of ``jax.value_and_grad`` over the params tree), then the
optimizer's update of the parameters in place. PyTorch runs eagerly, so
there is no jit, no donation and no scan of several steps in one dispatch.

With a mesh (``parallel/mesh.py``) the step is the data-parallel one of
``parallel/data_parallel.py``: each rank passes its own sub-batch, the
gradients and metrics are averaged over the ranks, and ``init_state``
starts every replica from rank 0's parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

Tensor = torch.Tensor


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
    defaults. ``schedule(k)``, if given, is update k's learning rate (k
    counted from 0): the counterpart of an optax chain that holds a
    schedule, e.g. ``optax.adam(optax.linear_schedule(...))``. ``mesh``:
    train data-parallel over its ranks (the module docstring)."""

    def __init__(self, loss_fn: Callable,
                 optimizer: Callable[[List[nn.Parameter]], torch.optim.Optimizer],
                 mesh=None, schedule: Optional[Callable[[int], float]] = None):
        from ..parallel.data_parallel import device_train_step
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self.schedule = schedule
        self._step = device_train_step(loss_fn, mesh, schedule)

    def init_state(self, params: Iterable[nn.Parameter]) -> TrainState:
        params = [p for p in params if p.requires_grad]
        if self.mesh is not None:
            from ..parallel.collectives import broadcast_tensors_
            broadcast_tensors_(params, self.mesh)
        return TrainState(params=params, optimizer=self.optimizer(params))

    def step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Tensor]]:
        """One step: the loss, its gradients (averaged over the mesh's
        ranks), the optimizer's update."""
        return self._step(state, batch)

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
