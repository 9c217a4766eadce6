"""The energy+force loss gradient taken reverse over forward; counterpart of
``gcnn_keras_tpu/training/fast_force_step.py``
(``energy_force_value_and_grad``, ``make_force_train_step``).

The plain step (``Trainer`` over ``EnergyForceModel.apply(batch,
create_graph=True)``) differentiates ``loss(energy, force)`` along the
parameters, where ``force = -dE/dx`` itself comes from a reverse pass: the
force-loss gradient is reverse over reverse, and the second pass walks the
whole graph of the first. This module takes the same gradient reverse over
forward. For any force loss ``L_f(f)`` with ``f(theta) = s dE/dx``:

    dL_f/dtheta = (dL_f/df)^T df/dtheta
                = d/dtheta [ v^T f(theta) ]      with v = stopgrad(dL_f/df)
                = s d/dtheta [ jvp_x(E; v) ]

one elementwise pass for ``v``, the energy's forward-mode tangent along
``v`` (a scalar), and one reverse pass over that forward computation. No
approximation: ``v`` carries all of ``L_f``'s dependence on ``f``, so
holding it constant is the chain rule. The energy loss (and an auxiliary
loss) rides the same surrogate's primal.

The tangent runs under ``torch.autograd.forward_ad``; every kernel Function
on a potential's path has a ``jvp`` that runs a kernel on the tangent, so
forward mode stays on the kernels. The reverse pass over the surrogate runs
after the dual level has closed: inside it, the reverse pass would itself
be differentiated in forward mode, which some built-in backward formulas
(``silu_backward``) do not support. The reverse-only kernel routes raise
(SchNet ``accurate_cfconv``, ``fused_chain``, ``fused_aggregate="vjp"``),
as ``jax.jvp`` refuses the JAX package's ``custom_vjp`` routes.

PyTorch runs eagerly: ``donate`` is accepted and changes nothing. No entry
point of the package calls this module, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn as nn

from ..batch import GraphBatch
from .losses import force_loss, masked_graph_mae, masked_graph_mse
from .trainer import TrainState

Tensor = torch.Tensor


def _trailing_ones(mask: Tensor, like: Tensor) -> Tensor:
    """``mask`` in ``like``'s dtype, with ones appended to its shape up to
    ``like``'s rank."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim())).to(like.dtype)


def energy_force_value_and_grad(
        energy_model: nn.Module,
        energy_weight: float = 1.0,
        force_weight: float = 50.0,
        energy_loss_kind: str = "mae",
        force_loss_kind: str = "mae",
        energy_output_key: str = "output",
        coordinates_key: str = "node_coordinates",
        energy_target_key: str = "energy",
        force_target_key: str = "force",
        is_physical_force: bool = True,
        aux_loss_fn: Optional[Callable] = None,
        **apply_kwargs,
) -> Callable[..., Tuple[Tuple[Tensor, Dict[str, Tensor]], List[Tensor]]]:
    """Build ``vag(batch, params=None) -> ((loss, metrics), grads)``.

    The loss is ``energy_weight * E_loss + force_weight * F_loss`` (each
    ``"mae"`` or ``"mse"``), plus ``aux_loss_fn(energy_per_graph, batch)``
    when given; ``metrics`` holds ``energy_loss``, ``force_loss`` (weighted)
    and ``aux_loss``. ``grads`` are the loss's gradients along ``params``,
    in their order: by default the trainable parameters of
    ``energy_model``, in the order ``Trainer.init_state`` takes them (the
    JAX ``vag`` takes the params tree first; this one closes over the
    modules, as a ``Trainer``'s ``loss_fn`` does). A parameter the loss
    does not reach gets zeros. ``apply_kwargs`` go to the energy model.
    """
    sign = -1.0 if is_physical_force else 1.0
    e_loss_fn = masked_graph_mae if energy_loss_kind == "mae" else masked_graph_mse

    def vag(batch: GraphBatch, params: Optional[Iterable[nn.Parameter]] = None):
        params = [p for p in (energy_model.parameters() if params is None else params)
                  if p.requires_grad]
        coords = batch.nodes[coordinates_key].detach()
        gmask = batch.globals["graph_mask"]
        nmask = batch.node_mask
        f_true = batch.nodes[force_target_key]
        e_true = batch.globals[energy_target_key]

        def energies(c: Tensor) -> Tensor:
            out = energy_model(batch.replace_nodes(**{coordinates_key: c}), **apply_kwargs)
            e = out[energy_output_key]
            return e * _trailing_ones(gmask, e)

        with torch.enable_grad():
            # pass 1: the forces (the one reverse pass along the coordinates)
            c = coords.clone().requires_grad_(True)
            e_graph = energies(c)
            (de_dr,) = torch.autograd.grad(e_graph.sum(), c, allow_unused=True)
            if de_dr is None:
                de_dr = torch.zeros_like(coords)
            nm = _trailing_ones(nmask, de_dr)
            force = (sign * de_dr * nm).requires_grad_(True)

            # v = dL_f/df, an elementwise reverse pass that never touches the model
            f_loss = force_weight * force_loss(force, f_true, nmask, kind=force_loss_kind)
            (v_f,) = torch.autograd.grad(f_loss, force)
            v = (sign * v_f * nm).detach()

            e_graph = e_graph.detach()
            e_loss = e_loss_fn(e_graph, e_true, gmask)
            loss = energy_weight * e_loss + f_loss.detach()
            metrics = {"energy_loss": e_loss, "force_loss": f_loss.detach()}

            # the surrogate's forward, with the energy's tangent along v
            with fwAD.dual_level():
                e_dual = energies(fwAD.make_dual(coords, v))
                e_g, de = fwAD.unpack_dual(e_dual)
            # its reverse pass, after the dual level has closed
            surrogate = energy_weight * e_loss_fn(e_g, e_true, gmask)
            if de is not None:
                surrogate = surrogate + de.sum()
            if aux_loss_fn is not None:
                surrogate = surrogate + aux_loss_fn(e_g, batch)
            grads = torch.autograd.grad(surrogate, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if aux_loss_fn is not None:
            metrics["aux_loss"] = aux_loss_fn(e_graph, batch).detach()
            loss = loss + metrics["aux_loss"]
        return (loss, metrics), grads

    return vag


def make_force_train_step(energy_model: nn.Module,
                          optimizer: Callable[[List[nn.Parameter]], torch.optim.Optimizer],
                          donate: bool = True, **vag_kwargs) -> Callable:
    """``step(state, batch) -> (state, loss, metrics)`` on a
    :class:`TrainState`: the reverse-over-forward gradient along
    ``state.params``, then the optimizer's update in place.

    ``optimizer`` makes the optimizer from the parameters, as ``Trainer``
    takes it (``functools.partial(torch.optim.Adam, lr=1e-3)`` is
    ``optax.adam(1e-3)``); ``step.init_state(params)`` builds the state
    (the counterpart of ``optimizer.init(params)``), by default over
    ``energy_model``'s trainable parameters. ``donate`` keeps the JAX
    signature (buffer donation to the jitted step) and changes nothing.
    ``vag_kwargs`` go to :func:`energy_force_value_and_grad`."""
    vag = energy_force_value_and_grad(energy_model, **vag_kwargs)

    def step(state: TrainState, batch: GraphBatch):
        (loss, metrics), grads = vag(batch, state.params)
        for p, g in zip(state.params, grads):
            p.grad = g
        state.optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), loss, metrics

    def init_state(params: Optional[Iterable[nn.Parameter]] = None) -> TrainState:
        params = [p for p in (energy_model.parameters() if params is None else params)
                  if p.requires_grad]
        return TrainState(params=params, optimizer=optimizer(params))

    step.init_state = init_state
    return step
