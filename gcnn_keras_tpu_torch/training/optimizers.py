"""Optimizers with optax's update rules, for ``training/hyper.py``
``make_optimizer``; counterpart of the optax aliases that the JAX
package's ``make_optimizer`` takes and of its own ``_adan``.

Each factory has its optax namesake's name, keywords and defaults, and
returns a function of the parameters that builds the optimizer. PyTorch's
own classes differ from optax's rules where it matters here:
``torch.optim.AdamW`` decays by 1e-2 where ``optax.adamw`` decays by 1e-4;
``optax.rmsprop`` decays by 0.9 and puts ``eps`` inside the root,
``torch.optim.RMSprop`` decays by 0.99 and puts it outside; ``optax.nadam``
is Adam with a Nesterov step, which ``torch.optim.NAdam``'s momentum
schedule cannot be set to; and none of them calls a schedule with the
update count. So each rule is written here once.

The learning rate is a number or a schedule. An optax rule calls the
schedule with the count of updates made before this one (0 first);
``Adan``, as the JAX package's, calls it with the count including this one
(1 first).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch

LearningRate = Union[float, Callable[[int], float]]


class _Rule(torch.optim.Optimizer):
    """One update rule applied to every parameter at every step, one
    without a gradient taking zeros (as ``jax.grad`` gives them to optax);
    each parameter's state holds its update count, ``"step"``."""

    def __init__(self, params, lr: LearningRate, **defaults):
        self.schedule = lr if callable(lr) else None
        super().__init__(params, dict(lr=None if callable(lr) else lr, **defaults))

    def _lr(self, group, count: int) -> float:
        return self.schedule(count) if self.schedule is not None else group["lr"]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    self._init_state(st, p)
                st["step"] += 1
                self._update(p, g, st, group, st["step"])
        return loss

    def _init_state(self, st, p):
        raise NotImplementedError

    def _update(self, p, g, st, group, count: int):
        raise NotImplementedError


class OptaxAdam(_Rule):
    """``optax.adam``, ``optax.adamw`` (``weight_decay``, added to the
    scaled step before the learning rate, over every parameter) and
    ``optax.nadam`` (``nesterov``)."""

    def __init__(self, params, lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, nesterov: bool = False):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                         nesterov=nesterov)

    def _init_state(self, st, p):
        st["mu"] = torch.zeros_like(p)
        st["nu"] = torch.zeros_like(p)

    def _update(self, p, g, st, group, count):
        b1, b2 = group["b1"], group["b2"]
        mu = st["mu"].mul_(b1).add_(g, alpha=1 - b1)
        nu = st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
        if group["nesterov"]:
            mu_hat = b1 * (mu / (1 - b1 ** (count + 1))) + (1 - b1) * (g / (1 - b1 ** count))
        else:
            mu_hat = mu / (1 - b1 ** count)
        u = mu_hat / (torch.sqrt(nu / (1 - b2 ** count)) + group["eps"])
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        p.add_(-self._lr(group, count - 1) * u)


class OptaxSGD(_Rule):
    """``optax.sgd``: the gradient, or with ``momentum`` its trace ``t = g
    + momentum t`` (``nesterov``: ``g + momentum t``), times the rate."""

    def __init__(self, params, lr: LearningRate, momentum: Optional[float] = None,
                 nesterov: bool = False):
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov)

    def _init_state(self, st, p):
        if self.defaults["momentum"] is not None:
            st["trace"] = torch.zeros_like(p)

    def _update(self, p, g, st, group, count):
        m = group["momentum"]
        if m is not None:
            t = st["trace"].mul_(m).add_(g)
            g = g + m * t if group["nesterov"] else t
        p.add_(-self._lr(group, count - 1) * g)


class OptaxRMSprop(_Rule):
    """``optax.rmsprop``: ``nu = decay nu + (1 - decay) g^2``, the step
    ``g / sqrt(nu + eps)`` times the rate, then with ``momentum`` its
    trace."""

    def __init__(self, params, lr: LearningRate, decay: float = 0.9, eps: float = 1e-8,
                 momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, lr, decay=decay, eps=eps, momentum=momentum,
                         nesterov=nesterov)

    def _init_state(self, st, p):
        st["nu"] = torch.zeros_like(p)
        if self.defaults["momentum"] is not None:
            st["trace"] = torch.zeros_like(p)

    def _update(self, p, g, st, group, count):
        decay = group["decay"]
        nu = st["nu"].mul_(decay).addcmul_(g, g, value=1 - decay)
        u = -self._lr(group, count - 1) * (g * torch.rsqrt(nu + group["eps"]))
        m = group["momentum"]
        if m is not None:
            t = st["trace"].mul_(m).add_(u)
            u = u + m * t if group["nesterov"] else t
        p.add_(u)


class Adan(_Rule):
    """Adan (Xie et al. 2022) as the JAX package's ``_adan`` writes it:
    moments of the gradient (``m``), of its difference from the last one
    (``v``; 0 at the first update) and of ``(g + b2 diff)^2`` (``n``), each
    bias-corrected; the step ``(m/bc1 + b2 v/bc2) / (sqrt(n/bc3) + eps)``,
    and ``weight_decay`` times the parameter added to it (decoupled),
    times the rate."""

    def __init__(self, params, lr: LearningRate, b1: float = 0.98, b2: float = 0.92,
                 b3: float = 0.99, eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, lr, b1=b1, b2=b2, b3=b3, eps=eps, weight_decay=weight_decay)

    def _init_state(self, st, p):
        for k in ("m", "v", "n", "prev_g"):
            st[k] = torch.zeros_like(p)

    def _update(self, p, g, st, group, count):
        b1, b2, b3 = group["b1"], group["b2"], group["b3"]
        diff = torch.zeros_like(g) if count == 1 else g - st["prev_g"]
        m = st["m"].mul_(b1).add_(g, alpha=1 - b1)
        v = st["v"].mul_(b2).add_(diff, alpha=1 - b2)
        gd = g + b2 * diff
        n = st["n"].mul_(b3).addcmul_(gd, gd, value=1 - b3)
        lr = self._lr(group, count)
        step = (m / (1 - b1 ** count) + b2 * v / (1 - b2 ** count)) / (
            torch.sqrt(n / (1 - b3 ** count)) + group["eps"])
        u = -lr * step
        if group["weight_decay"]:
            u = u - lr * group["weight_decay"] * p
        p.add_(u)
        st["prev_g"].copy_(g)


def _factory(cls, learning_rate: LearningRate, **kwargs):
    return functools.partial(cls, lr=learning_rate, **kwargs)


def adam(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    return _factory(OptaxAdam, learning_rate, b1=b1, b2=b2, eps=eps)


def adamw(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    return _factory(OptaxAdam, learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def nadam(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    return _factory(OptaxAdam, learning_rate, b1=b1, b2=b2, eps=eps, nesterov=True)


def sgd(learning_rate: LearningRate, momentum: Optional[float] = None, nesterov: bool = False):
    return _factory(OptaxSGD, learning_rate, momentum=momentum, nesterov=nesterov)


def rmsprop(learning_rate: LearningRate, decay: float = 0.9, eps: float = 1e-8,
            momentum: Optional[float] = None, nesterov: bool = False):
    return _factory(OptaxRMSprop, learning_rate, decay=decay, eps=eps, momentum=momentum,
                    nesterov=nesterov)


def adan(learning_rate: LearningRate, b1: float = 0.98, b2: float = 0.92, b3: float = 0.99,
         eps: float = 1e-8, weight_decay: float = 0.0):
    return _factory(Adan, learning_rate, b1=b1, b2=b2, b3=b3, eps=eps,
                    weight_decay=weight_decay)
