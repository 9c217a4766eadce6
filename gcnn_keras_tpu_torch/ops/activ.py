"""Custom activations; counterpart of ``gcnn_keras_tpu/ops/activ.py``.

Each entry computes what its JAX counterpart computes. ``softplus`` is
``logaddexp(x, 0)`` as in ``jax.nn.softplus``: ``F.softplus`` turns into the
identity above its ``threshold`` and would not match. Its derivative is
``sigmoid(x)`` (``_Softplus``), so that every derivative stays finite:
``torch.logaddexp``'s own second derivative is ``inf / inf`` (NaN) once
``exp(x)`` overflows (x above about 88), where a force loss through a
readout of many atoms puts it.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

_LOG2 = math.log(2.0)


class _Softplus(torch.autograd.Function):
    """``logaddexp(x, 0)`` with ``sigmoid(x)`` as its derivative, in reverse
    and forward mode; ``torch.sigmoid``'s own derivatives are finite."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.sigmoid(x)

    @staticmethod
    def jvp(ctx, t):
        (x,) = ctx.saved_tensors
        return t * torch.sigmoid(x)


def softplus(x):
    return _Softplus.apply(x)


def shifted_softplus(x):
    """softplus(x) - log(2); zero at x=0 (SchNet's ssp)."""
    return softplus(x) - _LOG2


def softplus2(x):
    """log(exp(x)+1) - log(2), MEGNet's variant; the same function here."""
    return softplus(x) - _LOG2


def leaky_softplus(x, alpha: float = 0.05):
    return alpha * x + (1.0 - alpha) * softplus(x)


def leaky_relu(x, alpha: float = 0.05):
    return F.leaky_relu(x, negative_slope=alpha)


def swish(x):
    return F.silu(x)


def mish(x):
    return x * torch.tanh(softplus(x))


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": gelu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": softplus,
    "swish": swish,
    "silu": swish,
    "mish": mish,
    "shifted_softplus": shifted_softplus,
    "softplus2": softplus2,
    "leaky_softplus": leaky_softplus,
    "leaky_relu": leaky_relu,
    # reference-style registry names ("kgcnn>..."), kept for config parity
    "kgcnn>shifted_softplus": shifted_softplus,
    "kgcnn>softplus2": softplus2,
    "kgcnn>leaky_softplus": leaky_softplus,
    "kgcnn>leaky_relu": leaky_relu,
    "kgcnn>swish": swish,
}


def get_activation(name_or_fn):
    """Resolve an activation by name or pass a callable through."""
    if callable(name_or_fn):
        return name_or_fn
    if isinstance(name_or_fn, dict):  # serialized {"class_name": ..., "config": {...}}
        cfg = name_or_fn.get("config", {})
        name = name_or_fn.get("class_name", "linear")
        base = _ACTIVATIONS[name.replace("function:", "")]
        if cfg:
            return functools.partial(base, **{k: v for k, v in cfg.items() if k != "name"})
        return base
    try:
        return _ACTIVATIONS[name_or_fn]
    except KeyError:
        raise ValueError(f"Unknown activation {name_or_fn!r}") from None
