"""Normalization over flat graph batches; counterpart of
``gcnn_keras_tpu/layers/norm.py``.

Layer normalization is per row, so padding rows need no mask. The
statistics are flax's ``LayerNorm``'s: the mean and ``E[x^2] - E[x]^2``
(clamped at 0) over the last axis, so that a ``(N, 3, F)`` input is
normalized over F for each of its three components.

Batch normalization (``GraphBatchNorm``) takes its statistics over the
valid rows only, by the mask, and keeps running averages of them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

Tensor = torch.Tensor


class GraphLayerNorm(nn.Module):
    """LayerNorm over the last axis with keras' epsilon (1e-3), a learned
    ``scale`` (ones) and ``bias`` (zeros) of ``features`` entries."""

    def __init__(self, features: int, epsilon: float = 1e-3, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.register_parameter(
            "scale", nn.Parameter(torch.ones(features)) if use_scale else None)
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(features)) if use_bias else None)

    def forward(self, x: Tensor) -> Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.epsilon)
        if self.scale is not None:
            mul = mul * self.scale
        y = (x - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y


class LayerNorm(GraphLayerNorm):
    """flax's ``nn.LayerNorm`` where a model names it as a module of its own
    (MAT's ``ln1_i``, ``ln2_i``, ``ln_out``): the statistics of
    ``GraphLayerNorm``, whose ``scale`` and ``bias`` are here bare leaves of
    the module's flax path (``GraphLayerNorm`` wraps a ``LayerNorm_0``)."""


class GraphBatchNorm(nn.Module):
    """BatchNorm across the valid rows of a flat batch over the last axis:
    a learned ``scale`` (ones) and ``bias`` (zeros) of ``features``
    entries, and the running ``mean`` (zeros) and ``var`` (ones) as
    buffers, the flax ``batch_stats`` collection.

    As the JAX layer, it keys on the call's ``train`` argument, not on
    ``nn.Module.training``: ``train=False`` (the default, and what every
    caller of the JAX package passes) normalizes by the running averages;
    ``train=True`` normalizes by the masked batch statistics (the mean and
    the biased variance over the rows where ``mask`` is set, the count
    clamped at 1) and moves the running averages towards them by
    ``1 - momentum``, as the JAX layer does under ``apply(...,
    mutable=["batch_stats"])``.
    """

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: Tensor, mask: Optional[Tensor] = None,
                train: bool = False) -> Tensor:
        if train:
            if mask is None:
                raise ValueError("GraphBatchNorm(train=True) needs the valid-row mask")
            m = mask.to(x.dtype).reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
            cnt = m.sum().clamp_min(1.0)
            axes = tuple(range(x.dim() - 1))
            mean = (x * m).sum(axes) / cnt
            var = (m * (x - mean) ** 2).sum(axes) / cnt
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean.detach())
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var.detach())
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias
