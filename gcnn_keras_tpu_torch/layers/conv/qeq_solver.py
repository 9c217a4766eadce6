"""The dense constrained Qeq solve; counterpart of
``gcnn_keras_tpu/layers/conv/qeq_solver.py`` (``solve_qeq_dense_cholesky``).

The iterative (matrix-free CG) and row-sharded solvers of that file are not
ported yet.
"""
from __future__ import annotations

import torch

from ...ops.cuda.spd_solve import SPDSolve, fits_shared_memory

Tensor = torch.Tensor


def solve_qeq_dense_cholesky(a_core: Tensor, border: Tensor, b: Tensor,
                             qtot: Tensor, corner: Tensor) -> Tensor:
    """Constrained Qeq solve with the total-charge constraint eliminated by
    a Schur complement.

    ``a_core (G, M, M)`` is SPD per molecule (erf-screened Coulomb plus a
    positive hardness diagonal, identity on padding rows). One solve with
    two right-hand sides gives ``A y1 = b`` and ``A y2 = border``; then
    ``lambda = (border.y1 - qtot) / (border.y2 - corner)`` and
    ``q = y1 - lambda y2``, the solution of the bordered system
    ``[[A, border], [border^T, corner]]``.

    Args: ``border (G, M)`` the node mask, ``b (G, M)`` the right-hand side,
    ``qtot (G,)`` the total charges, ``corner (G,)`` 0, or 1 for an empty
    graph. Returns ``q (G, M)``.

    The solve is the SPD kernel (:class:`SPDSolve`) whenever its block fits
    the kernel's shared memory; beyond that, a Cholesky factor and
    ``cholesky_solve``, as the JAX package solves off the TPU.
    """
    rhs = torch.stack([b, border], dim=-1)                 # (G, M, 2)
    m = b.shape[1]
    if fits_shared_memory(m, 2):
        ys = SPDSolve.apply(a_core, rhs)
    else:
        ys = torch.cholesky_solve(rhs, torch.linalg.cholesky(a_core))
    y1, y2 = ys[..., 0], ys[..., 1]
    num = torch.sum(border * y1, dim=-1) - qtot
    den = torch.sum(border * y2, dim=-1) - corner
    lam = num / torch.where(den == 0.0, torch.ones_like(den), den)
    return y1 - lam[:, None] * y2
