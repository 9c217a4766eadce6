"""Data-parallel training and evaluation steps over a mesh of ranks;
counterpart of ``gcnn_keras_tpu/parallel/data_parallel.py``.

Each rank holds a full replica of the parameters and takes its own
sub-batch. A step is the loss, its gradients by ``torch.autograd.grad``,
one all-reduce of the flattened gradients divided by the ranks (JAX's
``pmean``), the optimizer's update, and the metrics and loss averaged over
the ranks. ``DistributedDataParallel`` is not used: its reducer hooks
fire on ``.backward()`` into ``.grad``, and a force loss takes
``torch.autograd.grad``, which it never sees. The replicas agree because
they start from rank 0's parameters (broadcast by ``Trainer.init_state``)
and apply the same averaged gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

import torch

from .collectives import all_gather, pmean_metrics, pmean_tensors
from .mesh import Mesh

Tensor = torch.Tensor


def device_train_step(loss_fn: Callable, mesh: Optional[Mesh] = None,
                      schedule: Optional[Callable[[int], float]] = None) -> Callable:
    """The one train-step body, shared by ``Trainer`` (with or without a
    mesh) and ``make_dp_train_step``: ``step(state, batch) -> (state,
    metrics)`` with ``state`` a ``TrainState`` and ``batch`` this rank's
    sub-batch. Without a mesh (or on one rank) nothing is reduced."""
    def step(state, batch):
        loss, metrics = loss_fn(batch)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(state.params, grads)]
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        if mesh is not None and mesh.size > 1:
            grads = pmean_tensors(grads, mesh)
            metrics = pmean_metrics(metrics, mesh)
        for p, g in zip(state.params, grads):
            p.grad = g
        if schedule is not None:
            lr = schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        state.optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), metrics
    return step


def make_dp_train_step(loss_fn: Callable, optimizer: Callable, mesh: Mesh,
                       schedule: Optional[Callable[[int], float]] = None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` on this rank's sub-batch;
    ``step.init_state(params)`` makes the state from rank 0's parameters
    (``Trainer(loss_fn, optimizer, mesh=mesh)``'s)."""
    from ..training.trainer import Trainer
    trainer = Trainer(loss_fn, optimizer, mesh=mesh, schedule=schedule)

    def step(state, batch):
        return trainer.step(state, batch)
    step.init_state = trainer.init_state
    return step


def dp_batch_iterator(batches: Iterable, mesh: Mesh):
    """This rank's batches of a stream of same-shape batches: of each
    group of consecutive batches, one for each of the ranks that share the
    stream (``mesh.size // mesh.n_hosts``: every rank of one run, one rank
    a host where a launcher started the hosts), the one of this rank, on
    its device. Incomplete trailing groups are dropped, as in JAX."""
    n = max(mesh.size // mesh.n_hosts, 1)
    local = mesh.rank % n
    group = 0
    mine = None
    for b in batches:
        if group == local:
            mine = b
        group += 1
        if group == n:
            yield mine.to(mesh.device)
            group, mine = 0, None


def make_dp_eval_step(apply_fn: Callable, mesh: Mesh) -> Callable:
    """``fn(batch) -> {key: (D, ...)}``: ``apply_fn`` on this rank's
    sub-batch, each output gathered from every rank in rank order (the
    sub-batches share their shapes)."""
    def fn(batch) -> Dict[str, Tensor]:
        out = apply_fn(batch)
        return {k: all_gather(v.detach()[None], mesh) for k, v in out.items()}
    return fn
