"""Normalization over flat graph batches; counterpart of
``gcnn_keras_tpu/layers/norm.py`` (``GraphLayerNorm`` so far).

Layer normalization is per row, so padding rows need no mask. The
statistics are flax's ``LayerNorm``'s: the mean and ``E[x^2] - E[x]^2``
(clamped at 0) over the last axis, so that a ``(N, 3, F)`` input is
normalized over F for each of its three components.
"""
from __future__ import annotations

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
