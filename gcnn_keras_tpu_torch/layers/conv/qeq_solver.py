"""The constrained Qeq solves; counterpart of
``gcnn_keras_tpu/layers/conv/qeq_solver.py`` (``solve_qeq_dense_cholesky``,
``_erf_kernel_matvec``, ``solve_qeq_iterative``,
``solve_qeq_iterative_batch``).

Both eliminate the total-charge constraint by a Schur complement: with
``A x1 = chi`` and ``A x2 = 1`` (``A`` SPD: erf-screened Coulomb plus a
positive hardness diagonal), ``lambda = (1.x1 - qtot) / 1.x2`` and
``q = x1 - lambda x2``, the solution of the bordered system.

The dense solve builds ``A`` as a padded ``(G, M, M)`` batch. The iterative
one never does: Jacobi-preconditioned conjugate gradients on the erf-kernel
matvec, computed in row blocks of ``block`` rows, so it holds O(M * block)
values at a time (its derivatives, like the JAX package's ``lax.map``
under autodiff, keep each block's intermediates).

``solve_qeq_batch_sharded`` shares the G dense solves of a batch over the
ranks of a mesh, with no collective in the solve. The row-sharded CG
solvers of the JAX module (the partitioned HDNNP4th's) are not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ...ops.cuda.spd_solve import SPDSolve, fits_shared_memory

Tensor = torch.Tensor

# CG calls (each solving the 2 G systems of one batch, or their adjoints)
# and the rounds they took, summed
solves = 0
rounds = 0


def solve_qeq_batch_sharded(a: Tensor, rhs: Tensor, mesh) -> Tensor:
    """The batched dense solve ``a (G, K, K) @ x = rhs (G, K)`` with the G
    systems shared over the mesh's ranks: each rank LU-solves its
    contiguous G / D, as the JAX function's ``jnp.linalg.solve``, and the
    solutions are gathered in order on every rank, differentiably. G must
    divide by the mesh size (pad with identity systems)."""
    from ...parallel.collectives import all_gather
    g, d = a.shape[0], mesh.size
    if g % d:
        raise ValueError(f"{g} systems do not divide over {d} ranks; pad with identity systems")
    lo, hi = mesh.rank * (g // d), (mesh.rank + 1) * (g // d)
    x = torch.linalg.solve(a[lo:hi], rhs[lo:hi, :, None])
    return all_gather(x[..., 0], mesh)


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


def _row_blocks(pos: Tensor, sigma: Tensor, mask: Tensor, block: int):
    """The erf-kernel matrix's geometry ``block`` rows at a time: ``(pad,
    mask_p, blocks)``, ``pad(t)`` padding a ``(G, M, ...)`` tensor's rows to
    a multiple of ``block`` with zeros, ``mask_p`` the padded mask, and
    ``blocks()`` an iterator that computes, one block at a time (so a call
    holds O(M * block) values), each block's row slice, ``r_i - r_j``,
    ``d_ij``, ``gamma_ij`` and the mask that zeroes the diagonal and the
    padded columns. ``sigma`` pads with 1.0."""
    m = mask.shape[1]
    m_pad = -(-m // block) * block

    def pad(t: Tensor) -> Tensor:
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, m_pad - m))

    pos_p = pad(pos)
    sig_p = F.pad(sigma, (0, m_pad - m), value=1.0)
    mask_p = pad(mask.to(pos.dtype))
    cols = torch.arange(m_pad, device=pos.device)
    rows_in_block = torch.arange(block, device=pos.device)[:, None]

    def blocks():
        for r0 in range(0, m_pad, block):
            rows = slice(r0, r0 + block)
            diff = pos_p[:, rows, None, :] - pos_p[:, None, :, :]
            d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)      # (G, block, M_pad)
            gamma = torch.sqrt(sig_p[:, rows, None] ** 2 + sig_p[:, None, :] ** 2 + 1e-12)
            keep = (cols != rows_in_block + r0) * mask_p[:, None, :]
            yield rows, diff, d, gamma, keep

    return pad, mask_p, blocks


def _erf_kernel_matvec(pos: Tensor, sigma: Tensor, diag: Tensor, mask: Tensor,
                       block: int = 128) -> Callable[[Tensor], Tensor]:
    """Matrix-free SPD matvec of a batch of molecules: ``pos (G, M, 3)``,
    ``sigma (G, M)``, ``diag (G, M)``, ``mask (G, M)`` bool.

    ``(A q)_i = diag_i q_i + mask_i sum_{j != i} mask_j erf(d_ij / (sqrt(2)
    gamma_ij)) / d_ij q_j`` with ``d_ij = sqrt(|r_i - r_j|^2 + 1e-12)`` and
    ``gamma_ij = sqrt(sigma_i^2 + sigma_j^2 + 1e-12)``, ``sigma`` padded
    with 1.0 up to a multiple of ``block``. The returned function takes
    ``q (G, M, K)`` and computes the rows ``block`` at a time."""
    pad, mask_p, blocks = _row_blocks(pos, sigma, mask, block)
    m = mask.shape[1]

    def matvec(q: Tensor) -> Tensor:
        q_p = pad(q)
        out = [((torch.erf(d / (gamma * math.sqrt(2.0))) / d * keep) @ q_p)
               * mask_p[:, rows, None] for rows, _, d, gamma, keep in blocks()]
        return torch.cat(out, dim=1)[:, :m] + diag[..., None] * q

    return matvec


def _erf_kernel_matvec_jvp(pos: Tensor, sigma: Tensor, diag: Tensor, mask: Tensor,
                           block: int = 128) -> Callable:
    """The tangent of :func:`_erf_kernel_matvec`'s ``A q`` at a fixed ``q``
    along the matrix's inputs: the returned function takes ``q (G, M, K)``
    and the tangents ``dpos``, ``dsigma``, ``ddiag`` (each None where it is
    zero) and gives ``(dA) q``, ``block`` rows at a time. With
    ``u = d / (sqrt(2) gamma)`` and ``off = erf(u) / d``:
    ``d off = (erf'(u) u - erf(u)) / d^2 dd - erf'(u) / (sqrt(2) gamma^2)
    dgamma``, ``dd = (r_i - r_j).(dr_i - dr_j) / d``, ``dgamma = (sigma_i
    dsigma_i + sigma_j dsigma_j) / gamma``. Written out in ordinary
    operations (a Function's ``jvp`` runs no forward mode of its own), so a
    reverse pass reaches the inputs and ``q`` through them."""
    pad, mask_p, blocks = _row_blocks(pos, sigma, mask, block)
    m = mask.shape[1]

    def tangent(q: Tensor, dpos: Optional[Tensor], dsigma: Optional[Tensor],
                ddiag: Optional[Tensor]) -> Tensor:
        out = torch.zeros_like(q) if ddiag is None else ddiag[..., None] * q
        if dpos is None and dsigma is None:
            return out
        q_p = pad(q)
        dpos_p = None if dpos is None else pad(dpos)
        sds_p = None if dsigma is None else pad(sigma * dsigma)
        rows_out = []
        for rows, diff, d, gamma, keep in blocks():
            u = d / (gamma * math.sqrt(2.0))
            derf = (2.0 / math.sqrt(math.pi)) * torch.exp(-u * u)
            doff = torch.zeros_like(d)
            if dpos_p is not None:
                ddiff = dpos_p[:, rows, None, :] - dpos_p[:, None, :, :]
                dd = torch.sum(diff * ddiff, dim=-1) / d
                doff = doff + (derf * u - torch.erf(u)) / (d * d) * dd
            if sds_p is not None:
                dgamma = (sds_p[:, rows, None] + sds_p[:, None, :]) / gamma
                doff = doff - derf / (math.sqrt(2.0) * gamma * gamma) * dgamma
            rows_out.append(((doff * keep) @ q_p) * mask_p[:, rows, None])
        return out + torch.cat(rows_out, dim=1)[:, :m]

    return tangent


def _pcg(matvec: Callable[[Tensor], Tensor], b: Tensor, inv_diag: Tensor,
         tol: float, maxiter: int) -> Tensor:
    """Jacobi-preconditioned CG on every system of ``b (G, M, K)`` at once,
    as ``jax.scipy.sparse.linalg.cg`` under ``vmap``: x0 = 0; a system
    stops, and keeps its value, once its residual has ``r.r <= tol^2 b.b``
    or after ``maxiter`` rounds. One test a round for the whole batch (a
    host sync)."""
    global solves, rounds
    x = torch.zeros_like(b)
    r = b.clone()
    z = inv_diag[..., None] * r
    p = z
    gamma = torch.sum(r * z, dim=1)                                     # (G, K)
    thresh = tol * tol * torch.sum(b * b, dim=1)
    active = torch.sum(r * r, dim=1) > thresh
    k = 0
    while k < maxiter and bool(active.any()):
        ap = matvec(p)
        denom = torch.sum(p * ap, dim=1)
        alpha = gamma / torch.where(active, denom, torch.ones_like(denom))
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * ap
        z = inv_diag[..., None] * r_new
        gamma_new = torch.sum(r_new * z, dim=1)
        beta = gamma_new / torch.where(active, gamma, torch.ones_like(gamma))
        p_new = z + beta[:, None] * p
        keep = active[:, None]
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        p = torch.where(keep, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        k += 1
        active = active & (torch.sum(r * r, dim=1) > thresh)
    solves += 1
    rounds += k
    return x


class _CGSolve(torch.autograd.Function):
    """``x = A^-1 b`` for the erf-kernel matrix of ``(pos, sigma, diag,
    mask)``, by :func:`_pcg`, differentiable to any order as
    ``lax.custom_linear_solve(symmetric=True)``: the cotangent of ``b`` is
    ``lambda = A^-1 x_bar``, a solve of the same system, and that of each
    matvec input ``theta`` is ``-<lambda, d(A x)/d theta>`` at the solution
    ``x``. Its ``jvp`` is one more solve, ``dx = A^-1 (db - (dA) x)``
    (:func:`_erf_kernel_matvec_jvp`), as ``custom_linear_solve``'s."""

    @staticmethod
    def forward(ctx, b, pos, sigma, diag, mask, block, tol, maxiter):
        with torch.no_grad():
            matvec = _erf_kernel_matvec(pos, sigma, diag, mask, block)
            x = _pcg(matvec, b, 1.0 / torch.clamp_min(diag, 1e-6), tol, maxiter)
        ctx.save_for_backward(x, pos, sigma, diag, mask)
        ctx.save_for_forward(x, pos, sigma, diag, mask)
        # an input without a tangent reaches jvp as None, not as zeros (and
        # an output without a cotangent the backward)
        ctx.set_materialize_grads(False)
        ctx.config = (block, tol, maxiter)
        return x

    @staticmethod
    def jvp(ctx, db, dpos, dsigma, ddiag, *_):
        x, pos, sigma, diag, mask = ctx.saved_tensors
        block, tol, maxiter = ctx.config
        rhs = -_erf_kernel_matvec_jvp(pos, sigma, diag, mask, block)(x, dpos, dsigma, ddiag)
        if db is not None:
            rhs = rhs + db
        return _CGSolve.apply(rhs, pos, sigma, diag, mask, block, tol, maxiter)

    @staticmethod
    def backward(ctx, x_bar):
        if x_bar is None:  # materialize_grads is off
            return (None,) * 8
        x, pos, sigma, diag, mask = ctx.saved_tensors
        block, tol, maxiter = ctx.config
        lam = _CGSolve.apply(x_bar, pos, sigma, diag, mask, block, tol, maxiter)
        needed = [i for i in range(3) if ctx.needs_input_grad[1 + i]]
        grads = [None, None, None]
        if needed:
            # grad mode is on here only when the caller asked for a graph
            # (create_graph=True); the matvec's VJP needs it either way
            create = torch.is_grad_enabled()
            with torch.enable_grad():
                # fresh aliases of the inputs, so that the VJP reaches them
                # only through the matvec, not through x = A^-1 b
                theta = [t.view_as(t) if create else t.detach().requires_grad_(i in needed)
                         for i, t in enumerate((pos, sigma, diag))]
                ax = _erf_kernel_matvec(*theta, mask, block)(x if create else x.detach())
                vjp = torch.autograd.grad(ax, [theta[i] for i in needed], lam,
                                          create_graph=create)
            for i, g in zip(needed, vjp):
                grads[i] = -g
        return (lam, *grads, None, None, None, None)


def solve_qeq_iterative_batch(pos: Tensor, sigma: Tensor, hardness_diag: Tensor,
                              chi: Tensor, qtot: Tensor, mask: Tensor,
                              block: int = 128, tol: float = 1e-6,
                              maxiter: Optional[int] = None) -> Tensor:
    """Matrix-free constrained Qeq solve of a batch of molecules padded to
    M atoms: ``pos (G, M, 3)``; ``sigma (G, M)`` Gaussian widths (Bohr);
    ``hardness_diag (G, M)`` the dense solve's diagonal (hardness +
    1/(sigma sqrt(pi)), 1.0 on padding rows); ``chi (G, M)``; ``qtot (G,)``;
    ``mask (G, M)`` bool. Returns charges ``(G, M)``, zero on padding.

    The 2 G systems ``A x1 = chi mask`` and ``A x2 = mask`` run as one
    batched CG (``maxiter`` defaults to 10 M rounds, each system stopping
    on its own); an empty molecule's charges are 0."""
    maskf = mask.to(pos.dtype)
    if maxiter is None:
        maxiter = 10 * mask.shape[1]
    b = torch.stack([chi * maskf, maskf], dim=-1)                       # (G, M, 2)
    xs = _CGSolve.apply(b, pos, sigma, hardness_diag, mask, block, tol, maxiter)
    x1, x2 = xs[..., 0], xs[..., 1]
    denom = torch.sum(maskf * x2, dim=-1)
    lam = (torch.sum(maskf * x1, dim=-1) - qtot) / torch.where(
        denom != 0, denom, torch.ones_like(denom))
    return (x1 - lam[:, None] * x2) * maskf


def solve_qeq_iterative(pos: Tensor, sigma: Tensor, hardness_diag: Tensor,
                        chi: Tensor, qtot: Tensor, mask: Tensor,
                        block: int = 128, tol: float = 1e-6,
                        maxiter: Optional[int] = None) -> Tensor:
    """:func:`solve_qeq_iterative_batch` for ONE molecule: ``pos (M, 3)``,
    ``sigma``, ``hardness_diag``, ``chi``, ``mask`` ``(M,)``, ``qtot`` a
    scalar. Returns charges ``(M,)``."""
    q = solve_qeq_iterative_batch(pos[None], sigma[None], hardness_diag[None], chi[None],
                                  torch.as_tensor(qtot, dtype=pos.dtype,
                                                  device=pos.device).reshape(1),
                                  mask[None], block=block, tol=tol, maxiter=maxiter)
    return q[0]
