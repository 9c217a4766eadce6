"""Dense, MLP and per-relation MLP modules; counterpart of
``gcnn_keras_tpu/layers/mlp.py``.

Weights start as the JAX package's do: glorot-uniform kernels and zero
biases, drawn from an explicit ``torch.Generator`` on the CPU so that one
seed gives the same weights whatever the device. ``Dense.weight`` is stored
``(out, in)`` as in ``nn.Linear``; the flax kernel is ``(in, out)``.
``RelationalDense`` keeps the flax layout, ``kernel`` (R, in, out) and
``bias`` (R, out).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.activ import get_activation
from .norm import GraphBatchNorm, GraphLayerNorm

Tensor = torch.Tensor

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


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


def lecun_normal_(w: Tensor, fan_in: int, generator: Optional[torch.Generator]) -> Tensor:
    """flax's ``lecun_normal``: a normal truncated at two deviations, scaled
    to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def compute_dtype(dtype: Any) -> Optional[torch.dtype]:
    """A model's ``dtype`` option as a torch dtype: None for float32 (the
    parameters' own), ``torch.bfloat16`` for ``"bfloat16``."""
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}: float32 or bfloat16")
    return _DTYPES[dtype]


class Dense(nn.Module):
    """Linear layer with a named activation. ``dtype`` (``"bfloat16"``)
    computes in that type over float32 parameters, as flax's
    ``Dense(dtype=..., param_dtype=float32)``: input, weight and bias are
    cast, the product, bias and activation run in it, and the output is in
    it. None computes in the parameters' float32."""

    def __init__(self, in_features: int, units: int, activation: Any = "linear",
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None, dtype: Any = None):
        super().__init__()
        self.weight = nn.Parameter(glorot_uniform_(
            torch.empty(units, in_features), generator))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(units)) if use_bias else None)
        self._act = get_activation(activation)
        self.dtype = compute_dtype(dtype)

    def forward(self, x: Tensor) -> Tensor:
        w, b = self.weight, self.bias
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        return self._act(F.linear(x, w, b))


class MLP(nn.Module):
    """Stack of Dense layers ``dense_0 ... dense_{k-1}`` with per-layer
    unit / activation / bias lists.

    With ``use_normalization`` (per layer, or one value for all), a layer
    runs dense -> ``norm_i`` -> activation, in the reference's order:
    ``normalization_technique`` ``"graph_batch"`` or ``"batch"`` is a
    ``GraphBatchNorm`` over the rows of ``mask`` (``train`` as that layer
    takes it), anything else a ``GraphLayerNorm``."""

    def __init__(self, in_features: int, units: Union[int, Sequence[int]],
                 activation: Any = "linear", use_bias: Any = True,
                 last_linear: bool = False, use_normalization: Any = False,
                 normalization_technique: str = "graph_batch",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        units = list(units) if isinstance(units, (list, tuple)) else [units]
        depth = len(units)
        acts = _as_list(activation, depth)
        biases = _as_list(use_bias, depth)
        self._acts = []
        fan_in = in_features
        for i, (u, a, b, nrm) in enumerate(zip(units, acts, biases,
                                               _as_list(use_normalization, depth))):
            if last_linear and i == depth - 1:
                a = "linear"
            if not nrm:
                self.add_module(f"dense_{i}", Dense(fan_in, u, activation=a,
                                                    use_bias=b, generator=generator))
                self._acts.append(None)
            else:
                self.add_module(f"dense_{i}", Dense(fan_in, u, use_bias=b,
                                                    generator=generator))
                self.add_module(f"norm_{i}", GraphBatchNorm(u) if normalization_technique
                                in ("graph_batch", "batch") else GraphLayerNorm(u))
                self._acts.append(get_activation(a))
            fan_in = u
        self.out_features = fan_in

    def forward(self, x: Tensor, mask: Optional[Tensor] = None,
                train: bool = False) -> Tensor:
        for i, act in enumerate(self._acts):
            x = getattr(self, f"dense_{i}")(x)
            if act is not None:
                norm = getattr(self, f"norm_{i}")
                x = act(norm(x, mask, train) if isinstance(norm, GraphBatchNorm)
                        else norm(x))
        return x


class RelationalDense(nn.Module):
    """Per-relation dense layer: one weight set per relation (element type),
    chosen per row by ``relations``. A relation outside
    ``[0, num_relations)`` selects no weights (the one-hot row of the JAX
    package is zero), so its row is the activation of 0.

    The kernel starts as flax's ``glorot_uniform(in_axis=-2, out_axis=-1)``
    draws it for a (R, in, out) shape, whose fans count the relation axis:
    limit ``sqrt(6 / (R * (in + out)))``.

    Up to ``dense_relation_threshold`` relations, ``x @ W_r`` is one matmul
    over all of them, then each row picks its own; above it, as in the JAX
    package, only the relations the rows hold are multiplied, one matmul
    each over their rows.
    """

    def __init__(self, in_features: int, units: int, num_relations: int,
                 activation: Any = "linear", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dense_relation_threshold: int = 16):
        super().__init__()
        self.num_relations = num_relations
        self.dense_relation_threshold = dense_relation_threshold
        limit = math.sqrt(6.0 / (num_relations * (in_features + units)))
        self.kernel = nn.Parameter(nn.init.uniform_(
            torch.empty(num_relations, in_features, units), -limit, limit,
            generator=generator))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(num_relations, units))
            if use_bias else None)
        self._act = get_activation(activation)

    def forward(self, x: Tensor, relations: Tensor) -> Tensor:
        n, (r, fi, fo) = x.shape[0], self.kernel.shape
        rel = relations.long()
        valid = (rel >= 0) & (rel < r)
        if r > self.dense_relation_threshold:
            # rows of an invalid relation stay 0
            y = x.new_zeros(n, fo)
            for rid in torch.unique(rel[valid]).tolist():
                rows = (rel == rid).nonzero()[:, 0]
                y_r = x[rows] @ self.kernel[rid]
                if self.bias is not None:
                    y_r = y_r + self.bias[rid]
                y = y.index_copy(0, rows, y_r)
            return self._act(y)
        rel = rel.clamp(0, r - 1)
        # x @ W_r for every r as one matmul, then each row's own relation
        y_all = (x @ self.kernel.permute(1, 0, 2).reshape(fi, r * fo)).reshape(n, r, fo)
        y = y_all.gather(1, rel[:, None, None].expand(n, 1, fo))[:, 0]
        if self.bias is not None:
            y = y + self.bias[rel]
        return self._act(y * valid.to(x.dtype)[:, None])


class RelationalMLP(nn.Module):
    """Stack of RelationalDense layers ``rel_dense_0 ...``: the per-element
    atomic networks of HDNNP."""

    def __init__(self, in_features: int, units: Union[int, Sequence[int]],
                 num_relations: int, activation: Any = "linear",
                 use_bias: Any = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        units = list(units) if isinstance(units, (list, tuple)) else [units]
        depth = len(units)
        fan_in = in_features
        for i, (u, a, b) in enumerate(zip(units, _as_list(activation, depth),
                                          _as_list(use_bias, depth))):
            self.add_module(f"rel_dense_{i}", RelationalDense(
                fan_in, u, num_relations, activation=a, use_bias=b,
                generator=generator))
            fan_in = u
        self.out_features = fan_in

    def forward(self, x: Tensor, relations: Tensor) -> Tensor:
        for layer in self.children():
            x = layer(x, relations)
        return x
