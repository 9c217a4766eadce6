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
ranks of a mesh, with no collective in the solve.

The row-sharded CG (``solve_qeq_rows``, the partitioned HDNNP4th's; and
``solve_qeq_iterative_sharded``, one molecule's rows over a group) keeps
one giant molecule's M rows on D ranks, M / D each: a CG round computes
this rank's row block of the erf-kernel matvec (O(M^2 / D), never an
M x M matrix) and all-gathers it, so the iterate, the CG's scalars and its
stopping test are the same on every rank. The JAX package wraps its solve
in a ``custom_jvp`` that solves the bordered tangent system with the same
solve; here the solve is an autograd Function (:class:`_RowsCGSolve`) whose
backward solves the adjoint system by calling itself, with rank-local
right-hand sides and solutions, so that a backward through it can itself be
differentiated (the partitioned train step's force term, reverse over
reverse), and whose ``jvp`` is one more call.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ...ops.cuda.spd_solve import SPDSolve, fits_shared_memory
from ...parallel.collectives import all_gather, all_gather_tiled, psum

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


# ------------------------------------------------ row-sharded, one molecule


def _shard_pairs(pos_loc: Tensor, sig_loc: Tensor, pos_all: Tensor, sig_all: Tensor,
                 mask_all: Tensor, row0: int):
    """This rank's rows of the erf kernel's geometry against every atom:
    ``r_i - r_j``, ``d_ij``, ``gamma_ij`` (as :func:`_row_blocks`) and the
    mask that zeroes the diagonal (row ``row0 + i`` at column ``row0 + i``)
    and the padded columns, each ``(M_loc, M, ...)``."""
    diff = pos_loc[:, None, :] - pos_all[None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    gamma = torch.sqrt(sig_loc[:, None] ** 2 + sig_all[None, :] ** 2 + 1e-12)
    rows = torch.arange(pos_loc.shape[0], device=pos_loc.device)[:, None] + row0
    cols = torch.arange(pos_all.shape[0], device=pos_loc.device)[None, :]
    return diff, dist, gamma, (rows != cols).to(dist.dtype) * mask_all[None, :]


def _shard_off(pos_loc: Tensor, sig_loc: Tensor, pos_all: Tensor, sig_all: Tensor,
               mask_all: Tensor, row0: int) -> Tensor:
    """This rank's rows of the erf kernel's off-diagonal part, ``(M_loc,
    M)``, the diagonal and the padded columns zeroed (JAX's ``matvec`` of
    ``_qeq_rows_primal``)."""
    _, dist, gamma, keep = _shard_pairs(pos_loc, sig_loc, pos_all, sig_all, mask_all, row0)
    return torch.erf(dist / (gamma * math.sqrt(2.0))) / dist * keep


def _shard_rows(pos_loc: Tensor, sig_loc: Tensor, diag_loc: Tensor, maskf_loc: Tensor,
                q_all: Tensor, mesh) -> Tensor:
    """This rank's rows of ``A(pos, sigma, diag) @ q``, ``q (M, K)`` the
    whole (replicated) vector held fixed; differentiable along the rank's
    ``pos``, ``sigma`` and ``diag`` through the all-gathers, whose
    transposes bring each rank's share of the other rows' gradient home."""
    m_loc, row0 = pos_loc.shape[0], mesh.rank * pos_loc.shape[0]
    off = _shard_off(pos_loc, sig_loc, all_gather(pos_loc, mesh), all_gather(sig_loc, mesh),
                     all_gather_tiled(maskf_loc, mesh), row0)
    return (off @ q_all) * maskf_loc[:, None] + diag_loc[:, None] * q_all[row0:row0 + m_loc]


def _shard_rows_jvp(pos_loc: Tensor, sig_loc: Tensor, maskf_loc: Tensor, q_all: Tensor,
                    dpos_loc: Optional[Tensor], dsig_loc: Optional[Tensor],
                    ddiag_loc: Optional[Tensor], mesh) -> Tensor:
    """The tangent of :func:`_shard_rows` at a fixed ``q`` along ``dpos``,
    ``dsigma``, ``ddiag`` (each None where it is zero): the terms of
    :func:`_erf_kernel_matvec_jvp` on this rank's rows, the tangents of the
    other rows all-gathered. Written in ordinary operations and
    differentiable collectives, so a reverse pass reaches every input."""
    m_loc, row0 = pos_loc.shape[0], mesh.rank * pos_loc.shape[0]
    out = torch.zeros_like(q_all[:m_loc])
    if ddiag_loc is not None:
        out = out + ddiag_loc[:, None] * q_all[row0:row0 + m_loc]
    if dpos_loc is None and dsig_loc is None:
        return out
    diff, d, gamma, keep = _shard_pairs(pos_loc, sig_loc, all_gather(pos_loc, mesh),
                                        all_gather(sig_loc, mesh),
                                        all_gather_tiled(maskf_loc, mesh), row0)
    u = d / (gamma * math.sqrt(2.0))
    derf = (2.0 / math.sqrt(math.pi)) * torch.exp(-u * u)
    doff = torch.zeros_like(d)
    if dpos_loc is not None:
        dpos_all = all_gather(dpos_loc, mesh)
        ddiff = dpos_loc[:, None, :] - dpos_all[None, :, :]
        dd = torch.sum(diff * ddiff, dim=-1) / d
        doff = doff + (derf * u - torch.erf(u)) / (d * d) * dd
    if dsig_loc is not None:
        sds_loc = sig_loc * dsig_loc
        dgamma = (sds_loc[:, None] + all_gather(sds_loc, mesh)[None, :]) / gamma
        doff = doff - derf / (math.sqrt(2.0) * gamma * gamma) * dgamma
    return out + ((doff * keep) @ q_all) * maskf_loc[:, None]


class _RowsCGSolve(torch.autograd.Function):
    """``x = A^-1 b`` for one molecule whose rows are shared over the ranks
    of ``mesh``: ``b (M_loc, K)`` this rank's rows of the right-hand sides,
    ``x`` this rank's rows of the solutions. The forward runs :func:`_pcg`
    under no graph on the whole (replicated) vectors: a round computes this
    rank's rows of ``A p`` from a block of the matrix built once
    (:func:`_shard_off`) and all-gathers them. The backward's cotangent of
    ``b`` is this Function again on the rows of ``x_bar`` (``A`` is
    symmetric: the adjoint system is the same system, its right-hand side
    gathered from every rank's rows), and that of ``pos``, ``sigma``,
    ``diag`` is ``-<lambda, d(A x)/d theta>`` through
    :func:`_shard_rows`; its ``jvp`` solves ``A dx = db - (dA) x``
    (:func:`_shard_rows_jvp`)."""

    @staticmethod
    def forward(ctx, b, pos, sigma, diag, maskf, mesh, tol, maxiter):
        m_loc, row0 = b.shape[0], mesh.rank * b.shape[0]
        with torch.no_grad():
            # one all-gather of every per-atom table
            tab = all_gather_tiled(torch.cat(
                [pos, sigma[:, None], maskf[:, None],
                 1.0 / torch.clamp_min(diag, 1e-6)[:, None], b], dim=1), mesh)
            pos_all, sig_all, mask_all = tab[:, :3], tab[:, 3], tab[:, 4]
            off = _shard_off(pos, sigma, pos_all, sig_all, mask_all, row0)

            def matvec(p):
                p = p[0]
                ap = (off @ p) * maskf[:, None] + diag[:, None] * p[row0:row0 + m_loc]
                return all_gather_tiled(ap, mesh)[None]

            x = _pcg(matvec, tab[None, :, 6:], tab[None, :, 5], tol, maxiter)[0]
            x = x[row0:row0 + m_loc].clone()
        ctx.save_for_backward(x, pos, sigma, diag, maskf)
        ctx.save_for_forward(x, pos, sigma, diag, maskf)
        ctx.set_materialize_grads(False)
        ctx.config = (mesh, tol, maxiter)
        return x

    @staticmethod
    def jvp(ctx, db, dpos, dsigma, ddiag, *_):
        x, pos, sigma, diag, maskf = ctx.saved_tensors
        mesh, tol, maxiter = ctx.config
        x_all = all_gather(x, mesh)
        rhs = -_shard_rows_jvp(pos, sigma, maskf, x_all, dpos, dsigma, ddiag, mesh)
        if db is not None:
            rhs = rhs + db
        return _RowsCGSolve.apply(rhs, pos, sigma, diag, maskf, mesh, tol, maxiter)

    @staticmethod
    def backward(ctx, x_bar):
        if x_bar is None:  # materialize_grads is off (alike on every rank)
            return (None,) * 8
        x, pos, sigma, diag, maskf = ctx.saved_tensors
        mesh, tol, maxiter = ctx.config
        lam = _RowsCGSolve.apply(x_bar, pos, sigma, diag, maskf, mesh, tol, maxiter)
        needed = [i for i in range(3) if ctx.needs_input_grad[1 + i]]
        grads = [None, None, None]
        if needed:
            # grad mode is on here only when the caller asked for a graph
            create = torch.is_grad_enabled()
            with torch.enable_grad():
                theta = [t.view_as(t) if create else t.detach().requires_grad_(i in needed)
                         for i, t in enumerate((pos, sigma, diag))]
                x_all = all_gather(x, mesh) if create else all_gather_tiled(x.detach(), mesh)
                ax = _shard_rows(*theta, maskf, x_all, mesh)
                vjp = torch.autograd.grad(ax, [theta[i] for i in needed], lam,
                                          create_graph=create)
            for i, g in zip(needed, vjp):
                grads[i] = -g
        return (lam, *grads, None, None, None, None)


def solve_qeq_rows(pos_loc: Tensor, sig_loc: Tensor, diag_loc: Tensor, mask_loc: Tensor,
                   chi_loc: Tensor, qtot: Tensor, mesh, tol: float = 1e-6,
                   maxiter: Optional[int] = None) -> Tensor:
    """The constrained Qeq solve of ONE molecule whose M atoms lie on the
    ranks of ``mesh``, M / D consecutive ones on each (the JAX package's
    ``solve_qeq_rows_in_shard_map``): ``pos_loc (M_loc, 3)``, ``sig_loc``,
    ``diag_loc`` (hardness + 1/(sigma sqrt(pi)), 1.0 on padding rows),
    ``mask_loc`` bool, ``chi_loc`` ``(M_loc,)`` this rank's rows; ``qtot``
    the molecule's total charge, the same on every rank. Returns this
    rank's charges ``(M_loc,)``, zero on padding.

    ``A x1 = chi mask`` and ``A x2 = mask`` run as one CG
    (:class:`_RowsCGSolve`, ``maxiter`` defaulting to 10 M rounds); the
    multiplier comes from their sums over every rank (one ``psum``, its
    own transpose), as JAX's from its two solves. Every rank must call it
    together."""
    maskf = mask_loc.to(pos_loc.dtype)
    if maxiter is None:
        maxiter = 10 * pos_loc.shape[0] * mesh.size
    b = torch.stack([chi_loc * maskf, maskf], dim=-1)                  # (M_loc, 2)
    xs = _RowsCGSolve.apply(b, pos_loc, sig_loc, diag_loc, maskf, mesh, tol, maxiter)
    sums = psum(torch.sum(maskf[:, None] * xs, dim=0), mesh)          # (2,)
    den = sums[1]
    lam = (sums[0] - qtot) / torch.where(den != 0, den, torch.ones_like(den))
    return (xs[:, 0] - lam * xs[:, 1]) * maskf


class _RowsOfReplicated(torch.autograd.Function):
    """This rank's M / D rows of a tensor that is the same on every rank;
    its transpose gathers every rank's rows (:class:`_GatherReplicated`),
    so that each rank holds the whole gradient of a replicated input."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh) -> Tensor:
        ctx.mesh = mesh
        m_loc = x.shape[0] // mesh.size
        return x[mesh.rank * m_loc:(mesh.rank + 1) * m_loc].clone()

    @staticmethod
    def backward(ctx, g: Tensor):
        return _GatherReplicated.apply(g, ctx.mesh), None


class _GatherReplicated(torch.autograd.Function):
    """Every rank's rows gathered into a tensor that is the same on every
    rank; its transpose takes this rank's rows of the (replicated)
    cotangent, counting it once (JAX's ``_gather_r``), where the summing
    transpose of the all-gather would count it once a rank."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh) -> Tensor:
        ctx.mesh = mesh
        return all_gather_tiled(x, mesh)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _RowsOfReplicated.apply(g, ctx.mesh), None


def solve_qeq_iterative_sharded(pos: Tensor, sigma: Tensor, hardness_diag: Tensor,
                                chi: Tensor, qtot: Tensor, mask: Tensor, mesh,
                                tol: float = 1e-6, maxiter: Optional[int] = None) -> Tensor:
    """ONE molecule's constrained Qeq solve with the matvec's rows shared
    over the ranks of ``mesh`` (every rank calls it together): the
    arguments as :func:`solve_qeq_iterative`'s, the same on every rank,
    ``M`` a multiple of the ranks (pad with masked rows). Each rank solves
    its ``M / D`` rows (:func:`solve_qeq_rows`); returns the charges
    ``(M,)`` on every rank. Differentiable: each rank's gradient of a
    replicated input is the whole gradient of a loss of the charges that
    every rank computes alike."""
    m, d = pos.shape[0], mesh.size
    if m % d:
        raise ValueError(f"pad M={m} to a multiple of the {d} ranks")
    if d == 1:
        return solve_qeq_iterative(pos, sigma, hardness_diag, chi, qtot, mask, tol=tol,
                                   maxiter=maxiter)
    rows = lambda t: _RowsOfReplicated.apply(t, mesh)  # noqa: E731
    qtot = torch.as_tensor(qtot, dtype=pos.dtype, device=pos.device).reshape(())
    q_loc = solve_qeq_rows(rows(pos), rows(sigma), rows(hardness_diag),
                           mask[mesh.rank * (m // d):(mesh.rank + 1) * (m // d)],
                           rows(chi), qtot, mesh, tol=tol,
                           maxiter=10 * m if maxiter is None else maxiter)
    return _GatherReplicated.apply(q_loc, mesh)
