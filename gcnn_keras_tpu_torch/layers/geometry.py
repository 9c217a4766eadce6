"""Geometric edge features; counterpart of ``gcnn_keras_tpu/layers/geometry.py``
(edge vectors, distances and directions, the Gauss and Bessel radial bases
and the cutoff envelopes so far)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..batch import GraphBatch
from ..ops.cuda.fused_aggregate import gather_with_sorted_transpose

Tensor = torch.Tensor


def edge_vectors(batch: GraphBatch, positions: Optional[Tensor] = None,
                 key: str = "node_coordinates") -> Tensor:
    """Displacement per edge ``x_recv - x_send``, ``(E, 3)``.

    Both position gathers have the sorted segment-sum as their transpose
    (the d_pos scatter of every force pass). Periodic batches, which carry
    ``edges['range_image']`` and ``globals['graph_lattice']``, shift the
    SENDER by its lattice image: ``d = x_i - (x_j + s @ L)``.
    """
    pos = positions if positions is not None else batch.nodes[key]
    perm = batch.edges.get("sender_perm")
    if perm is None:
        # no perm: the edges are in no known order, so neither transpose
        # may be a sorted sum
        pos_j = pos.index_select(0, batch.senders)
        pos_i = pos.index_select(0, batch.receivers)
    else:
        pos_j = gather_with_sorted_transpose(pos, batch.senders, perm)
        pos_i = gather_with_sorted_transpose(pos, batch.receivers)
    vec = pos_i - pos_j
    if "range_image" in batch.edges and "graph_lattice" in batch.globals:
        image = batch.edges["range_image"].to(pos.dtype)  # (E, 3)
        lattice = batch.globals["graph_lattice"].to(pos.dtype)  # (G, 3, 3) rows
        lat_e = lattice[batch.edge_graph_id]  # (E, 3, 3)
        vec = vec - torch.einsum("ei,eij->ej", image, lat_e)
    return vec


def edge_distances(batch: GraphBatch, positions: Optional[Tensor] = None,
                   eps: float = 1e-12) -> Tensor:
    """Euclidean edge length ``(E, 1)``, with a masked sqrt so padding edges
    (zero vectors) get distance sqrt(eps) and finite gradients."""
    vec = edge_vectors(batch, positions)
    d2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    d = torch.sqrt(d2.clamp_min(eps))
    return torch.where(d2 > eps, d, torch.full_like(d, eps ** 0.5))


def edge_directions(batch: GraphBatch, positions: Optional[Tensor] = None,
                    eps: float = 1e-12) -> Tuple[Tensor, Tensor]:
    """Unit edge direction ``(E, 3)`` and distance ``(E, 1)``; a padding
    edge (zero vector) gets direction 0 and distance 0."""
    vec = edge_vectors(batch, positions)
    d2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    d = torch.sqrt(d2.clamp_min(eps))
    return vec / d, torch.where(d2 > eps, d, torch.zeros_like(d))


def gauss_basis(distance: Tensor, bins: int = 20, distance_max: float = 4.0,
                offset: float = 0.0, sigma: float = 0.4) -> Tensor:
    """Gaussian radial basis ``(E, 1) -> (E, bins)``: centres
    ``arange(bins)/bins * distance_max`` (endpoint excluded), input shifted
    by ``offset``, gamma = 1/(2 sigma^2)."""
    gamma = -0.5 / (sigma * sigma)
    centers = (torch.arange(bins, dtype=distance.dtype, device=distance.device)
               / float(bins) * distance_max)
    diff = (distance - offset) - centers[None, :]
    return torch.exp(gamma * diff * diff)


def bessel_basis(distance: Tensor, num_radial: int = 20, cutoff: float = 5.0,
                 envelope: bool = False, exponent: int = 5) -> Tensor:
    """DimeNet's Bessel basis ``sqrt(2/c) sin(n pi d / c) / d``, ``(E, 1) ->
    (E, num_radial)``, optionally times the polynomial envelope of d / c."""
    d = distance.clamp_min(1e-8)
    n = torch.arange(1, num_radial + 1, dtype=distance.dtype, device=distance.device)
    rbf = math.sqrt(2.0 / cutoff) * torch.sin(n[None, :] * (math.pi / cutoff) * d) / d
    if envelope:
        rbf = rbf * polynomial_envelope(distance / cutoff, exponent)
    return rbf


def bessel_basis_kgcnn(distance: Tensor, num_radial: int = 20,
                       cutoff: float = 5.0, envelope_exponent: int = 5) -> Tensor:
    """kgcnn's Bessel basis, ``env(u) sin(n pi u)`` with ``u = d / c`` and
    ``env(u) = polynomial_envelope(u, p + 1) / u``: the 1/d rides in the
    envelope and there is no sqrt(2/c). The frequencies ``n pi`` are a
    closed form (kgcnn trains them; its initial values are these)."""
    u = distance / cutoff
    n = torch.arange(1, num_radial + 1, dtype=distance.dtype,
                     device=distance.device) * math.pi
    env = polynomial_envelope(u, envelope_exponent + 1) / u.clamp_min(1e-8)
    return env * torch.sin(n[None, :] * u)


def polynomial_envelope(u: Tensor, p: int = 5) -> Tensor:
    """DimeNet's C^p envelope on u in [0, 1): ``1 - (p+1)(p+2)/2 u^p +
    p(p+2) u^(p+1) - p(p+1)/2 u^(p+2)``; 0 from u = 1 on."""
    a = -(p + 1) * (p + 2) / 2.0
    b = float(p * (p + 2))
    c = -p * (p + 1) / 2.0
    env = 1.0 + a * u ** p + b * u ** (p + 1) + c * u ** (p + 2)
    return torch.where(u < 1.0, env, torch.zeros_like(env))


def cosine_cutoff_envelope(distance: Tensor, cutoff: float) -> Tensor:
    """Behler's cutoff ``0.5 (cos(pi r / r_c) + 1)`` below ``r_c``, else 0."""
    fc = 0.5 * (torch.cos(math.pi * distance / cutoff) + 1.0)
    return torch.where(distance < cutoff, fc, torch.zeros_like(fc))


def cosine_cutoff(values: Tensor, distance: Tensor, cutoff: float) -> Tensor:
    """``values`` times the cosine cutoff of ``distance``."""
    return values * cosine_cutoff_envelope(distance, cutoff)
