"""Weighted ACSF (wACSF): element-weighted symmetry functions without
per-pair parameter tables (Gastegger et al. 2017); counterpart of
``gcnn_keras_tpu/layers/conv/wacsf.py``.

The weight is g(Z_j) = Z_j (radial) and h(Z_j, Z_k) = Z_j Z_k (angular); the
parameters are those of the CENTRAL atom's element; the sums are plain and
the angular ``2^(1-zeta)`` scale comes after the sum. Neither layer has
weights. Both sums are sorted (the radial one by receiver, the angular one
by angle centre, the order the batcher gives the angles), so each runs on
the sorted segment-sum kernel, whose backward, a gather, carries the forces.

The default tables are the unoptimized defaults of the reference (22 radial
and 10 angular sets, the same for every element) with the published
optimized rows for H/C/N/O/F (``wacsf_params.py``).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from ...batch import GraphBatch, refuse_partitioned
from ...ops.segment import segment_sum

Tensor = torch.Tensor

_N_ELEM = 118


def default_radial_eta_mu() -> np.ndarray:
    """(118, 22, 2) (eta, mu) table: the generic grid for every element,
    with the published optimized rows for H/C/N/O/F."""
    from .wacsf_params import RADIAL_OPT
    mus = np.linspace(7.5, 0.5, 22)
    table = np.stack([np.full(22, 4.5), mus], axis=-1)
    out = np.broadcast_to(table, (_N_ELEM, 22, 2)).copy()
    for z, rows in RADIAL_OPT.items():
        out[z] = np.array(rows)[:, :2]
    return out


def default_angular_params() -> np.ndarray:
    """(118, 10, 4) (eta, mu, lambda, zeta) table with the published
    optimized rows for H/C/N/O/F."""
    from .wacsf_params import ANGULAR_OPT
    etas = [0.0330612, 0.0330612, 0.0498615, 0.0498615, 0.0836777,
            0.0836777, 0.1685744, 0.1685744, 0.5, 0.5]
    lambdas = [-1.0, 1.0] * 5
    table = np.stack([np.array(etas), np.zeros(10), np.array(lambdas),
                      np.ones(10)], axis=-1)
    out = np.broadcast_to(table, (_N_ELEM, 10, 4)).copy()
    for z, rows in ANGULAR_OPT.items():
        out[z] = np.array(rows)[:, :4]
    return out


def _fc(r: Tensor, cutoff: float) -> Tensor:
    return 0.5 * (torch.cos(r.clamp(-cutoff, cutoff) * (math.pi / cutoff)) + 1.0)


def _dist(v: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-12))


def _inputs(batch: GraphBatch, z: Optional[Tensor], positions: Optional[Tensor]):
    z = z if z is not None else batch.nodes["node_number"].to(torch.int32)
    pos = positions if positions is not None else batch.nodes["node_coordinates"]
    return z.long(), pos


class _Table(nn.Module):
    def __init__(self, table: np.ndarray):
        super().__init__()
        # a constant of the layer: it moves with the module, is not saved
        self.register_buffer("table", torch.tensor(np.asarray(table, np.float32)),
                             persistent=False)
        self.out_features = self.table.shape[1]

    def rows(self, z: Tensor) -> Tensor:
        """The table rows of atomic numbers ``z`` (clipped to the table)."""
        return self.table[z.clamp(0, _N_ELEM - 1)]


class wACSFRad(_Table):
    """W_i = sum_j Z_j exp(-eta (r_ij - mu)^2) f_c(r_ij). Output (N, m)."""

    def __init__(self, eta_mu: Any = None, cutoff: float = 8.0):
        table = np.asarray(eta_mu, np.float32) if eta_mu is not None \
            else default_radial_eta_mu()
        super().__init__(table[..., :2])
        self.cutoff = float(cutoff)

    def forward(self, batch: GraphBatch, z: Optional[Tensor] = None,
                positions: Optional[Tensor] = None,
                external_weights: Optional[Tensor] = None) -> Tensor:
        refuse_partitioned(batch, "wACSFRad")
        z, pos = _inputs(batch, z, positions)
        recv, send = batch.receivers.long(), batch.senders.long()
        rij = _dist(pos[recv] - pos[send])  # (E, 1)
        params = self.rows(z[recv])  # the central atom's (E, m, 2)
        gij = torch.exp(-params[..., 0] * (rij - params[..., 1]) ** 2)
        w = external_weights if external_weights is not None \
            else z[send].to(gij.dtype)[:, None]
        rep = gij * _fc(rij, self.cutoff) * w
        rep = rep * batch.edge_mask[:, None].to(rep.dtype)
        return segment_sum(rep, batch.receivers, batch.n_node, indices_are_sorted=True)


class wACSFAng(_Table):
    """W_i = 2^(1-zeta) sum_jk Z_j Z_k (1 + lambda cos)^zeta
    exp(-eta((r_ij-mu)^2 + (r_ik-mu)^2 + (r_jk-mu)^2)) f_ij f_ik f_jk.
    Output (N, m)."""

    def __init__(self, eta_mu_lambda_zeta: Any = None, cutoff: float = 8.0):
        table = np.asarray(eta_mu_lambda_zeta, np.float32) \
            if eta_mu_lambda_zeta is not None else default_angular_params()
        super().__init__(table[..., :4])
        self.cutoff = float(cutoff)

    def forward(self, batch: GraphBatch, z: Optional[Tensor] = None,
                positions: Optional[Tensor] = None,
                external_weights: Optional[Tensor] = None) -> Tensor:
        refuse_partitioned(batch, "wACSFAng")
        if batch.angles is None:
            raise ValueError("wACSFAng needs angle triples in the batch")
        z, pos = _inputs(batch, z, positions)
        i, j, k = batch.angles.long().unbind(1)
        params = self.rows(z[i])  # (A, m, 4)
        eta, mu, lamda, zeta = params.unbind(-1)
        vij, vik, vjk = pos[j] - pos[i], pos[k] - pos[i], pos[k] - pos[j]
        rij, rik, rjk = _dist(vij), _dist(vik), _dist(vjk)
        g = torch.exp(-eta * ((rij - mu) ** 2 + (rik - mu) ** 2 + (rjk - mu) ** 2))
        cos_theta = (vij * vik).sum(-1, keepdim=True) / rij / rik
        # torch.maximum, not clamp: at a tie it splits the gradient as jnp.maximum
        base = torch.maximum(cos_theta * lamda + 1.0, torch.full_like(lamda, 1e-30))
        w = external_weights if external_weights is not None \
            else (z[j] * z[k]).to(g.dtype)[:, None]
        rep = torch.pow(base, zeta) * g * _fc(rij, self.cutoff) * _fc(rik, self.cutoff) \
            * _fc(rjk, self.cutoff) * w
        rep = rep * batch.angle_mask[:, None].to(rep.dtype)
        # angles are sorted by centre at batch build
        pooled = segment_sum(rep, batch.angles[:, 0].contiguous(), batch.n_node,
                             indices_are_sorted=True)
        # the 2^(1-zeta) scale of the centre's own table, after the sum
        return torch.pow(2.0, 1.0 - self.rows(z)[..., 3]) * pooled
