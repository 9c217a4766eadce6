"""4th-generation HDNNP electrostatics: charge equilibration (Qeq/CENT),
the screened-Coulomb energy of Gaussian charges and the QM/MM coupling;
counterpart of ``gcnn_keras_tpu/layers/conv/hdnnp_electro.py``.

The Qeq system of each molecule is padded to ``M = batch.max_nodes`` atoms:
padding atoms get identity rows, and the total-charge constraint is
eliminated by a Schur complement (``qeq_solver.py``). The dense solve builds
the ``(G, M, M)`` matrices; the iterative one (matrix-free CG) only their
per-atom tables. The row-sharded solver of the JAX package is not ported
yet.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...batch import (GraphBatch, flat_to_padded, graph_psum, padded_to_flat,
                      refuse_partitioned)
from ...ops.segment import segment_sum
from ..aggr import gather_receiver_nodes, gather_sender_nodes
from .qeq_solver import solve_qeq_dense_cholesky, solve_qeq_iterative_batch

Tensor = torch.Tensor

_MAX_Z = 97


class LinearSolve(torch.autograd.Function):
    """``x = a^-1 b`` by ``torch.linalg.solve``, with its derivatives
    written out: the backward ``gb = a^-T g``, ``ga = -gb x^T``, the
    ``jvp`` ``a^-1 (db - da x)``, each through this Function again, so
    derivatives of any order hold. PyTorch's own reverse pass over
    ``torch.linalg.solve``'s forward-mode tangent is wrong along ``a``
    (torch 2.13 on the CPU: the reverse-over-forward force step's gradients
    of trainable Qeq tables came out 2-22% of a tensor's largest entry
    off)."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor) -> Tensor:
        x = torch.linalg.solve(a, b)
        ctx.save_for_backward(a, x)
        ctx.save_for_forward(a, x)
        # an input without a tangent reaches jvp as None, not as zeros (and
        # an output without a cotangent the backward)
        ctx.set_materialize_grads(False)
        return x

    @staticmethod
    def backward(ctx, g: Tensor):
        if g is None:  # materialize_grads is off
            return None, None
        a, x = ctx.saved_tensors
        gb = LinearSolve.apply(a.transpose(-1, -2), g)
        return (-(gb @ x.transpose(-1, -2)) if ctx.needs_input_grad[0] else None), gb

    @staticmethod
    def jvp(ctx, da: Tensor, db: Tensor) -> Tensor:
        a, x = ctx.saved_tensors
        rhs = db if da is None else (-(da @ x) if db is None else db - da @ x)
        return LinearSolve.apply(a, rhs)

# Covalent radii (pm) of the CENTCharge table, scaled pm -> Bohr by
# 0.0188973 for the Qeq solve; a copy of the JAX package's table.
_COVALENT_RADII_PM = np.array([
    0.0, 31, 28,
    128, 96, 84, 73, 71, 66, 57, 58,
    166, 141, 121, 111, 107, 105, 102, 106,
    203, 176, 170, 160, 153, 139, 139, 132, 126, 124, 132, 122, 122, 120, 119,
    120, 120, 116,
    220, 195, 190, 175, 164, 154, 147, 146, 142, 139, 145, 144, 142, 139, 139,
    138, 139, 140,
    244, 215, 207, 204, 203, 201, 199, 198, 198, 196, 194, 192, 192, 189, 190,
    187, 175, 187, 170, 162, 151, 144,
    141, 136, 136, 132, 145, 146, 148, 140, 150, 150,
    260, 221, 215, 206, 200, 196, 190, 187, 180, 169
])
CENT_RADII = (0.0188973 * _COVALENT_RADII_PM).astype(np.float32)
GAUSS_RADII = (0.01 * _COVALENT_RADII_PM).astype(np.float32)

# Chemical hardness (eV), scaled as in the reference.
CENT_HARDNESS = (0.037 / 0.529177 * np.array([
    0.0, 6.2, 8.8,
    2.2, 4.6, 3.8, 4.7, 7.1, 5.6, 6.1, 9.1,
    2.1, 4.0, 2.6, 3.3, 4.7, 3.8, 4.5, 7.7,
    2.3, 3.2, 3.2, 2.9, 3.2, 3.4, 4.0, 3.6, 3.3, 3.3, 3.8, 5.8, 3.0, 3.3, 4.5,
    3.9, 4.2, 7.7,
    1.9, 3.1, 3.1, 2.9, 3.3, 3.5, 3.7, 3.7, 3.9, 4.1, 3.6, 5.4, 3.1, 3.1, 4.0,
    3.6, 3.8, 6.8,
    1.8, 2.7, 2.4, 2.3, 2.5, 2.7, 2.5, 3.0, 3.0, 3.2, 3.2, 3.3, 3.3, 3.3, 3.1,
    3.5, 3.2, 3.8, 3.1, 3.6, 3.7, 3.7,
    3.8, 3.5, 3.6, 5.8, 3.1, 3.4, 3.3, 3.6, 3.6, 6.1,
    1.8, 3.0, 2.8, 2.8, 3.1, 3.0, 3.1, 3.5, 3.3, 3.3
])).astype(np.float32)


def _element_table(module: nn.Module, name: str, table: np.ndarray,
                   as_param: bool, use_physical_params: bool,
                   generator: Optional[torch.Generator]) -> None:
    """Register the (97,) per-element table ``name``: a parameter (the
    physical values when ``use_physical_params``, else glorot-uniform over
    the 1-D shape, whose fans are both 97) or a constant buffer."""
    values = torch.from_numpy(np.array(table, dtype=np.float32))
    if not as_param:
        module.register_buffer(name, values, persistent=False)
        return
    if not use_physical_params:
        limit = math.sqrt(6.0 / (2 * len(table)))
        values = nn.init.uniform_(torch.empty(len(table)), -limit, limit,
                                  generator=generator)
    module.register_parameter(name, nn.Parameter(values))


def _atomic_numbers(batch: GraphBatch) -> Tensor:
    return batch.nodes["node_number"].long().clamp(0, _MAX_Z - 1)


class CENTCharge(nn.Module):
    """Charge equilibration: the Qeq linear system of each molecule.

    ``forward(batch, chi, positions=None)`` takes flat electronegativities
    ``chi (N,)`` and uses ``node_number``, ``node_coordinates`` and
    ``globals['total_charge']``; it returns flat charges ``(N,)``.

    ``solver``: ``"dense"``; ``"iterative"``, the matrix-free CG of
    ``qeq_solver.py`` to the relative residual ``cg_tol``; or ``"auto"``,
    iterative from ``iterative_threshold`` atoms per molecule up, dense
    below. Any other value raises ``ValueError``.
    ``dense_impl``: ``"cholesky"`` (Schur-eliminated constraint, the SPD
    solve) or ``"lu"`` (the bordered ``(G, M+1, M+1)`` system through
    ``torch.linalg.solve``, in :class:`LinearSolve`); anything else raises
    ``ValueError``.
    """

    def __init__(self, param_trainable: bool = False, use_physical_params: bool = True,
                 solver: str = "auto", dense_impl: str = "cholesky",
                 iterative_threshold: int = 4096, cg_tol: float = 1e-6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dense_impl not in ("cholesky", "lu"):
            raise ValueError(f"dense_impl={dense_impl!r}: use 'cholesky' or 'lu'")
        if solver not in ("auto", "dense", "iterative"):
            raise ValueError(f"solver={solver!r}: use 'auto', 'dense' or 'iterative'")
        self.solver, self.dense_impl = solver, dense_impl
        self.iterative_threshold, self.cg_tol = iterative_threshold, cg_tol
        as_param = param_trainable or not use_physical_params
        _element_table(self, "hardness_j", CENT_HARDNESS, as_param,
                       use_physical_params, generator)
        _element_table(self, "sigma", CENT_RADII, as_param,
                       use_physical_params, generator)

    def tables(self, batch: GraphBatch, chi: Tensor,
               positions: Optional[Tensor] = None):
        """The padded per-atom tables both solvers read: ``(pos (G, M, 3),
        chi (G, M), sigma (G, M), diag (G, M), mask (G, M), qtot (G,))``.
        ``chi`` is zero and ``diag`` (hardness + 1/(sigma sqrt(pi))) is 1 on
        padding rows."""
        G = batch.n_graphs
        z = _atomic_numbers(batch)
        pos = positions if positions is not None else batch.nodes["node_coordinates"]
        qtot = batch.globals.get("total_charge")
        if qtot is None:
            qtot = pos.new_zeros(G)
        qtot = qtot.reshape(G, -1)[:, 0].to(pos.dtype)
        chi_flat = chi.reshape(chi.shape[0], -1)[:, 0]

        mask = flat_to_padded(batch.node_mask.to(pos.dtype), batch)     # (G, M)
        tab = flat_to_padded(torch.cat(
            [pos, chi_flat[:, None], self.sigma[z][:, None],
             self.hardness_j[z][:, None]], dim=1), batch)                # (G, M, 6)
        x_pad, chi_pad, sig, hard = tab[..., :3], tab[..., 3], tab[..., 4], tab[..., 5]
        # the physical diagonal for real atoms, 1 for padding rows
        diag = torch.where(mask.bool(), hard + 1.0 / (sig * math.sqrt(math.pi) + 1e-12),
                           torch.ones_like(hard))
        return x_pad, chi_pad * mask, sig, diag, mask, qtot

    def assemble(self, batch: GraphBatch, chi: Tensor,
                 positions: Optional[Tensor] = None):
        """The padded dense Qeq system: ``(a_core (G, M, M), mask (G, M),
        b (G, M), qtot (G,), corner (G,))``."""
        x_pad, b, sig, diag, mask, qtot = self.tables(batch, chi, positions)
        M = mask.shape[1]
        mb = mask.bool()
        diff = x_pad[:, :, None, :] - x_pad[:, None, :, :]
        dist = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 1e-12))
        gamma = torch.sqrt(sig[:, :, None] ** 2 + sig[:, None, :] ** 2 + 1e-12)
        off = torch.erf(dist / (gamma * math.sqrt(2.0))) / dist
        eye = torch.eye(M, dtype=torch.bool, device=x_pad.device)
        pair = mb[:, :, None] & mb[:, None, :] & ~eye
        a_core = torch.where(pair, off, torch.zeros_like(off)) + diag[:, :, None] * eye
        # the bordered corner: 0, or 1 for an empty graph (nonsingular)
        corner = torch.where(mask.sum(dim=1) > 0, torch.zeros_like(qtot),
                             torch.ones_like(qtot))
        return a_core, mask, b, qtot, corner

    def forward(self, batch: GraphBatch, chi: Tensor,
                positions: Optional[Tensor] = None) -> Tensor:
        refuse_partitioned(batch, "CENTCharge")
        if self.solver == "iterative" or (
                self.solver == "auto" and max(batch.max_nodes, 1) >= self.iterative_threshold):
            x_pad, b, sig, diag, mask, qtot = self.tables(batch, chi, positions)
            q_pad = solve_qeq_iterative_batch(x_pad, sig, diag, b, qtot, mask.bool(),
                                              tol=self.cg_tol)
        elif self.dense_impl == "cholesky":
            q_pad = solve_qeq_dense_cholesky(*self.assemble(batch, chi, positions))
        else:
            a_core, mask, b, qtot, corner = self.assemble(batch, chi, positions)
            G, M = mask.shape
            a = a_core.new_zeros(G, M + 1, M + 1)
            a[:, :M, :M] = a_core
            a[:, :M, M] = mask
            a[:, M, :M] = mask
            a[:, M, M] = corner
            rhs = torch.cat([b, qtot[:, None]], dim=1)                 # (G, M+1)
            q_pad = LinearSolve.apply(a, rhs[..., None])[..., 0][:, :M]
        q = padded_to_flat(q_pad, batch)
        return q * batch.node_mask.to(q.dtype)


class ElectrostaticEnergyGaussCharge(nn.Module):
    """Screened-Coulomb energy of Gaussian charges over the edge list plus
    their self energy. ``forward(batch, q, positions=None)`` returns the
    per-graph energy ``(G, 1)``.

    ``sigma_table``: the per-element radii; the standalone default is the
    Angstrom table ``GAUSS_RADII``. :class:`CENTChargePlusElectrostaticEnergy`
    passes the Bohr table ``CENT_RADII``, as the reference's fused layer
    resolves it through its base classes.
    """

    def __init__(self, multiplicity: float = 2.0, param_trainable: bool = False,
                 use_physical_params: bool = True, sigma_table: Any = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.multiplicity = multiplicity
        table = np.asarray(GAUSS_RADII if sigma_table is None else sigma_table)
        _element_table(self, "sigma", table, param_trainable or not use_physical_params,
                       use_physical_params, generator)

    def forward(self, batch: GraphBatch, q: Tensor,
                positions: Optional[Tensor] = None) -> Tensor:
        z = _atomic_numbers(batch)
        pos = positions if positions is not None else batch.nodes["node_coordinates"]
        qf = q.reshape(q.shape[0], -1)[:, 0]
        sigma_n = self.sigma[z]
        # one [pos | sigma | q] table, so each edge side is one row gather
        # whose transpose runs on the sorted segment-sum
        node_tab = torch.cat([pos, sigma_n[:, None], qf[:, None]], dim=1)   # (N, 5)
        er = gather_receiver_nodes(batch, node_tab)
        es = gather_sender_nodes(batch, node_tab)
        vec = er[:, :3] - es[:, :3]
        rij = torch.sqrt(torch.clamp_min(torch.sum(vec * vec, dim=-1), 1e-12))
        gamma = torch.sqrt(er[:, 3] ** 2 + es[:, 3] ** 2 + 1e-12)
        pair = er[:, 4] * es[:, 4] * torch.erf(rij / (gamma * math.sqrt(2.0))) / rij
        pair = pair * batch.edge_mask.to(pair.dtype)
        # unsorted, as the JAX package calls it
        e_pair = segment_sum(pair, batch.edge_graph_id, batch.n_graphs)
        if self.multiplicity:
            e_pair = e_pair / self.multiplicity

        self_e = torch.where(sigma_n > 0, qf ** 2 / torch.clamp_min(sigma_n, 1e-12),
                             torch.zeros_like(qf)) / (2.0 * math.sqrt(math.pi))
        self_e = self_e * batch.node_mask.to(self_e.dtype)
        e_self = segment_sum(self_e, batch.graph_id, batch.n_graphs,
                             indices_are_sorted=True)
        return graph_psum(batch, e_pair + e_self)[:, None]


def electrostatic_qmmm_energy(batch: GraphBatch, q: Tensor, esp: Tensor) -> Tensor:
    """``E = sum_i q_i Phi_i`` per graph. Returns ``(G, 1)``."""
    qf = q.reshape(q.shape[0], -1)[:, 0]
    ef = esp.reshape(esp.shape[0], -1)[:, 0]
    contrib = qf * ef * batch.node_mask.to(qf.dtype)
    return graph_psum(batch, segment_sum(contrib, batch.graph_id, batch.n_graphs,
                                         indices_are_sorted=True))[:, None]


def electrostatic_qmmm_force(q: Tensor, esp_grad: Tensor) -> Tensor:
    """``F_i = -q_i dPhi_i/dr_i``. Returns ``(N, 3)``."""
    qf = q.reshape(q.shape[0], -1)[:, 0]
    return -qf[:, None] * esp_grad


class CENTChargePlusElectrostaticEnergy(nn.Module):
    """The Qeq solve (``cent_charge``) followed by the electrostatic energy
    (``electrostatic_energy``, with the Bohr radii ``CENT_RADII``).
    ``forward`` returns ``(charges (N,), energy (G, 1))``."""

    def __init__(self, multiplicity: float = 2.0, param_trainable: bool = False,
                 use_physical_params: bool = True, solver: str = "auto",
                 dense_impl: str = "cholesky", cg_tol: float = 1e-6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cent_charge = CENTCharge(
            param_trainable=param_trainable, use_physical_params=use_physical_params,
            solver=solver, dense_impl=dense_impl, cg_tol=cg_tol, generator=generator)
        self.electrostatic_energy = ElectrostaticEnergyGaussCharge(
            multiplicity=multiplicity, param_trainable=param_trainable,
            use_physical_params=use_physical_params, sigma_table=CENT_RADII,
            generator=generator)

    def forward(self, batch: GraphBatch, chi: Tensor,
                positions: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        q = self.cent_charge(batch, chi, positions)
        return q, self.electrostatic_energy(batch, q, positions)
