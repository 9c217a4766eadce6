"""Dense and MLP modules; counterpart of ``gcnn_keras_tpu/layers/mlp.py``.

Weights start as the JAX package's do: glorot-uniform kernels and zero
biases, drawn from an explicit ``torch.Generator`` on the CPU so that one
seed gives the same weights whatever the device. ``weight`` is stored
``(out, in)`` as in ``nn.Linear``; the flax kernel is ``(in, out)``.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.activ import get_activation

Tensor = torch.Tensor


def _as_list(v, depth: int):
    if isinstance(v, (list, tuple)):
        if len(v) != depth:
            raise ValueError(f"list length {len(v)} != depth {depth}")
        return list(v)
    return [v] * depth


def glorot_uniform_(w: Tensor, generator: Optional[torch.Generator]) -> Tensor:
    fan_out, fan_in = w.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(w, -limit, limit, generator=generator)


class Dense(nn.Module):
    """Linear layer with a named activation."""

    def __init__(self, in_features: int, units: int, activation: Any = "linear",
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(glorot_uniform_(
            torch.empty(units, in_features), generator))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(units)) if use_bias else None)
        self._act = get_activation(activation)

    def forward(self, x: Tensor) -> Tensor:
        return self._act(F.linear(x, self.weight, self.bias))


class MLP(nn.Module):
    """Stack of Dense layers ``dense_0 ... dense_{k-1}`` with per-layer
    unit / activation / bias lists. Normalization layers are not ported."""

    def __init__(self, in_features: int, units: Union[int, Sequence[int]],
                 activation: Any = "linear", use_bias: Any = True,
                 last_linear: bool = False, use_normalization: Any = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        units = list(units) if isinstance(units, (list, tuple)) else [units]
        depth = len(units)
        if any(_as_list(use_normalization, depth)):
            raise NotImplementedError(
                "MLP(use_normalization=...) is not ported yet")
        acts = _as_list(activation, depth)
        biases = _as_list(use_bias, depth)
        fan_in = in_features
        for i, (u, a, b) in enumerate(zip(units, acts, biases)):
            if last_linear and i == depth - 1:
                a = "linear"
            self.add_module(f"dense_{i}", Dense(fan_in, u, activation=a,
                                                use_bias=b, generator=generator))
            fan_in = u
        self.out_features = fan_in

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.children():
            x = layer(x)
        return x
