"""Geometric edge features; counterpart of ``gcnn_keras_tpu/layers/geometry.py``:
edge vectors, distances and directions, the Gauss, Bessel and Fourier
radial bases, the cutoff envelopes, the fractional and cartesian
coordinates of a periodic batch and the geometry of angle triples."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..batch import GraphBatch, sender_node_table
from ..ops.cuda.fused_aggregate import gather_with_sorted_transpose

Tensor = torch.Tensor


def edge_vectors(batch: GraphBatch, positions: Optional[Tensor] = None,
                 key: str = "node_coordinates") -> Tensor:
    """Displacement per edge ``x_recv - x_send``, ``(E, 3)``.

    Both position gathers have the sorted segment-sum as their transpose
    (the d_pos scatter of every force pass). Periodic batches, which carry
    ``edges['range_image']`` and ``globals['graph_lattice']``, shift the
    SENDER by its lattice image: ``d = x_i - (x_j + s @ L)``. On a shard of
    an edge-partitioned graph the senders' positions come from the
    halo-exchanged table (``batch.sender_node_table``).
    """
    pos = positions if positions is not None else batch.nodes[key]
    perm = batch.edges.get("sender_perm")
    if batch.part_axis is not None:
        # a shard's receivers are sorted, its senders index the table
        pos_j = sender_node_table(batch, pos).index_select(0, batch.senders)
        pos_i = gather_with_sorted_transpose(pos, batch.receivers)
    elif perm is None:
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


def fourier_basis(distance: Tensor, bins: int = 20, distance_max: float = 4.0) -> Tensor:
    """Positional-encoding basis ``(E, 1) -> (E, bins)``: column ``k`` is
    ``sin`` (even ``k``) or ``cos`` (odd ``k``) of ``d pi (k // 2 + 1) /
    distance_max``."""
    k = torch.arange(bins, dtype=distance.dtype, device=distance.device)
    arg = distance * (math.pi / distance_max * (torch.div(k, 2, rounding_mode="floor") + 1))[None, :]
    return torch.where((k % 2 == 0)[None, :], torch.sin(arg), torch.cos(arg))


def frac_to_real_coordinates(batch: GraphBatch, frac: Optional[Tensor] = None,
                             lattice_key: str = "graph_lattice") -> Tensor:
    """Fractional -> cartesian coordinates of each node by its graph's
    lattice (rows are the lattice vectors); ``frac`` defaults to the
    batch's ``node_coordinates``."""
    f = frac if frac is not None else batch.nodes["node_coordinates"]
    lat = batch.globals[lattice_key].to(f.dtype)[batch.graph_id]  # (N, 3, 3)
    return torch.einsum("ni,nij->nj", f, lat)


def real_to_frac_coordinates(batch: GraphBatch, cart: Optional[Tensor] = None,
                             lattice_key: str = "graph_lattice") -> Tensor:
    """Cartesian -> fractional coordinates, the inverse of
    ``frac_to_real_coordinates``; every graph's lattice, the padding
    graph's too, must be invertible."""
    x = cart if cart is not None else batch.nodes["node_coordinates"]
    inv = torch.linalg.inv(batch.globals[lattice_key].to(x.dtype))[batch.graph_id]
    return torch.einsum("ni,nij->nj", x, inv)


def displacement_vectors_unit_cell(batch: GraphBatch,
                                   positions: Optional[Tensor] = None) -> Tensor:
    """``edge_vectors`` under kgcnn's name: with ``range_image`` and
    ``graph_lattice`` in the batch, the sender shifted by its image."""
    return edge_vectors(batch, positions)


def angle_triples(batch: GraphBatch, positions: Optional[Tensor] = None,
                  key: str = "node_coordinates", eps: float = 1e-12
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """The geometry of each angle triple ``(i, j, k)`` of ``batch.angles``
    with centre ``i``: ``(cos_theta, r_ij, r_ik)``, each ``(A, 1)``; a
    zero-length leg gives 0 for its distance and for the cosine."""
    if batch.angles is None:
        raise ValueError("angle_triples: the batch has no angle triples")
    pos = positions if positions is not None else batch.nodes[key]
    i, j, k = batch.angles[:, 0], batch.angles[:, 1], batch.angles[:, 2]
    vij = pos[j] - pos[i]
    vik = pos[k] - pos[i]
    r2ij = torch.sum(vij * vij, dim=-1, keepdim=True)
    r2ik = torch.sum(vik * vik, dim=-1, keepdim=True)
    rij = torch.sqrt(r2ij.clamp_min(eps))
    rik = torch.sqrt(r2ik.clamp_min(eps))
    cos = (torch.sum(vij * vik, dim=-1, keepdim=True) / (rij * rik)).clamp(-1.0, 1.0)
    zero = torch.zeros_like(cos)
    return (torch.where((r2ij > eps) & (r2ik > eps), cos, zero),
            torch.where(r2ij > eps, rij, zero), torch.where(r2ik > eps, rik, zero))
