"""PAiNN equivariant message and update blocks; counterpart of
``gcnn_keras_tpu/layers/conv/painn.py``.

Scalar features ``s (N, F)`` and equivariant features ``v (N, 3, F)``; the
Dense maps act on the last axis, so the three spatial components share one
F x F weight. Every sum onto nodes is the sorted segment-sum: the scalar
messages ``(E, F)`` and the equivariant ones ``(E, 3, F)``, flattened to
``(E, 3 F)``. The sender gathers have it as their transpose, so the force
pass and the force loss's second reverse pass stay on the kernel.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn as nn

from ...batch import GraphBatch
from ..aggr import gather_sender_nodes, pool_edges_to_nodes
from ..mlp import Dense

Tensor = torch.Tensor


class PAiNNconv(nn.Module):
    """Message block: ``phi = Dense(3U)(Dense(U, act)(s))`` gathered from
    the senders, times the radial filter ``w = Dense(3U)(rbf)`` (times the
    cutoff envelope when ``cutoff`` is set), split into three U-wide parts:
    the scalar message, the gate of the senders' v, and the gate of the
    edge direction."""

    def __init__(self, in_features: int, rbf_features: int, units: int = 128,
                 activation: Any = "swish", use_bias: bool = True,
                 conv_pool: str = "sum", cutoff: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_pool = conv_pool
        self.cutoff = cutoff
        self.dense_1 = Dense(in_features, units, activation=activation,
                             use_bias=use_bias, generator=generator)
        self.phi = Dense(units, 3 * units, use_bias=use_bias, generator=generator)
        self.w = Dense(rbf_features, 3 * units, use_bias=use_bias, generator=generator)

    def forward(self, batch: GraphBatch, s: Tensor, v: Tensor, rbf: Tensor,
                envelope: Optional[Tensor], dir_ij: Tensor) -> Tuple[Tensor, Tensor]:
        """Returns ``(ds (N, U), dv (N, 3, U))``."""
        phi_j = gather_sender_nodes(batch, self.phi(self.dense_1(s)))  # (E, 3U)
        w = self.w(rbf)
        if self.cutoff is not None and envelope is not None:
            w = w * envelope
        sw1, sw2, sw3 = torch.chunk(phi_j * w, 3, dim=-1)
        ds = pool_edges_to_nodes(batch, sw1, mode=self.conv_pool)
        vj = gather_sender_nodes(batch, v)  # (E, 3, F)
        dv_e = sw2[:, None, :] * vj + sw3[:, None, :] * dir_ij[:, :, None]
        dv = pool_edges_to_nodes(batch, dv_e, mode=self.conv_pool)
        return ds, dv


class PAiNNUpdate(nn.Module):
    """Update block: ``v_u = lin_u(v)``, ``v_v = lin_v(v)`` (no bias), the
    gates ``a = a(dense_1([s, |v_v|]))`` split in three: ``dv = a_vv v_u``,
    ``ds = <v_u, v_v> a_sv + a_ss``. ``|v_v|`` is ``sqrt(max(sum v_v^2,
    1e-12))``, whose gradient is 0 below the guard: a node whose
    equivariant features cancel (a symmetric molecule's centre) keeps
    finite forces."""

    def __init__(self, in_features: int, units: int = 128, activation: Any = "swish",
                 use_bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_v = Dense(units, units, use_bias=False, generator=generator)
        self.lin_u = Dense(units, units, use_bias=False, generator=generator)
        self.dense_1 = Dense(in_features + units, units, activation=activation,
                             use_bias=use_bias, generator=generator)
        self.a = Dense(units, 3 * units, use_bias=use_bias, generator=generator)

    def forward(self, batch: GraphBatch, s: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        v_v = self.lin_v(v)
        v_u = self.lin_u(v)
        v_prod = torch.sum(v_u * v_v, dim=1)  # (N, U)
        v_norm = torch.sqrt(torch.sum(v_v * v_v, dim=1).clamp_min(1e-12))
        a = self.a(self.dense_1(torch.cat([s, v_norm], dim=-1)))
        a_vv, a_sv, a_ss = torch.chunk(a, 3, dim=-1)
        return v_prod * a_sv + a_ss, a_vv[:, None, :] * v_u


def equivariant_initialize(s: Tensor, dim: int = 3, method: str = "zeros",
                           value: float = 1.0) -> Tensor:
    """The initial equivariant features ``(N, dim, F)`` of scalars ``s (N,
    F)``: zeros (of s's float type), or ``value`` everywhere (float32)."""
    n, f = s.shape[0], s.shape[-1]
    if method == "zeros":
        dtype = s.dtype if s.is_floating_point() else torch.float32
        return torch.zeros((n, dim, f), dtype=dtype, device=s.device)
    if method == "ones":
        return torch.full((n, dim, f), value, dtype=torch.float32, device=s.device)
    raise ValueError(f"unknown equivariant init {method}")
