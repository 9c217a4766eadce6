"""Geometric edge features; counterpart of ``gcnn_keras_tpu/layers/geometry.py``
(``edge_vectors``, ``edge_distances`` and ``gauss_basis`` so far)."""
from __future__ import annotations

from typing import Optional

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
