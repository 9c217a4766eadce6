"""The port's batched SPD solve (``ops/cuda/spd_solve.py``) and its dense
Qeq solve against the JAX package, on the CPU.

On a CPU tensor ``SPDSolve`` runs ``spd_solve_plain``, the kernel's
elimination in PyTorch operations, so these tests hold the kernel's
arithmetic and its autograd wiring; ``tests/test_torch_cuda.py`` holds the
kernel against the plain version on a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gcnn_keras_tpu.layers.conv.qeq_solver import (
    solve_qeq_dense_cholesky as jsolve_qeq_dense_cholesky)
from gcnn_keras_tpu.ops.pallas.spd_solve import _gj_solve_impl, spd_solve_lanes
from gcnn_keras_tpu_torch.layers.conv.qeq_solver import solve_qeq_dense_cholesky
from gcnn_keras_tpu_torch.ops.cuda import spd_solve as kspd

torch.set_num_threads(1)


def _spd(seed, g, m, k):
    """The inputs of tests/test_qeq_solver.py's kernel check: B B^T * 0.3^2
    + 2 I, and a random right-hand side."""
    rs = np.random.RandomState(seed)
    b = rs.randn(g, m, m).astype(np.float32) * 0.3
    a = np.einsum("gij,gkj->gik", b, b) + np.eye(m, dtype=np.float32)[None] * 2.0
    return a.astype(np.float32), rs.randn(g, m, k).astype(np.float32)


@pytest.mark.parametrize("g,m,k", [(5, 21, 2), (5, 1, 2), (1, 21, 2), (5, 21, 1),
                                   (1, 1, 1), (3, 9, 4)])
def test_plain_and_function_match_the_jax_kernel(g, m, k):
    """The JAX Gauss-Jordan kernel in interpret mode and its
    custom_linear_solve wrapper; atol 2e-6 as tests/test_qeq_solver.py."""
    a, b = _spd(1, g, m, k)
    ref = np.asarray(_gj_solve_impl(jnp.asarray(a), jnp.asarray(b), interpret=True))
    ref_lanes = np.asarray(spd_solve_lanes(jnp.asarray(a), jnp.asarray(b), interpret=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = kspd.launches
    for out in (kspd.spd_solve_plain(ta, tb), kspd.spd_solve(ta, tb),
                kspd.SPDSolve.apply(ta, tb)):
        assert out.shape == (g, m, k)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-6)
        np.testing.assert_allclose(out.numpy(), ref_lanes, rtol=0, atol=2e-6)
    assert kspd.launches == before  # nothing launches on the CPU


def test_identity_and_empty_systems():
    """Padding systems are the identity; zero right-hand sides give 0."""
    eye = torch.eye(6).repeat(3, 1, 1)
    b = torch.randn(3, 6, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(kspd.spd_solve(eye, b), b)
    assert not kspd.spd_solve(eye, torch.zeros(3, 6, 2)).any()
    assert kspd.spd_solve(torch.zeros(0, 4, 4), torch.zeros(0, 4, 2)).shape == (0, 4, 2)


def _symmetric(p, m):
    """A symmetric positive definite A(p) for gradient checks."""
    half = p.reshape(-1, m, m)
    return half @ half.transpose(-1, -2) + 2.0 * torch.eye(m, dtype=p.dtype)


@pytest.mark.parametrize("m,k", [(5, 2), (1, 1)])
def test_gradients_of_any_order(m, k):
    """float64 gradcheck and gradgradcheck through a symmetric A(p): the
    backward is SPDSolve again, so the second order runs through it too."""
    gen = torch.Generator().manual_seed(2)
    p = (0.3 * torch.randn(2 * m * m, generator=gen, dtype=torch.float64)).requires_grad_()
    b = torch.randn(2, m, k, generator=gen, dtype=torch.float64, requires_grad=True)

    def fn(p, b):
        return kspd.SPDSolve.apply(_symmetric(p, m), b)

    assert torch.autograd.gradcheck(fn, (p, b))
    assert torch.autograd.gradgradcheck(fn, (p, b))


def test_gradients_match_jax():
    """d/dA and d/db of sum(sin(x)) along a symmetric A(p), against the JAX
    custom_linear_solve in interpret mode."""
    import jax
    a, b = _spd(3, 4, 7, 2)
    p0 = np.random.RandomState(4).randn(4, 7, 7).astype(np.float32) * 0.1

    def jloss(p, bb):
        x = spd_solve_lanes(jnp.asarray(a) + p + jnp.swapaxes(p, 1, 2), bb,
                            interpret=True)
        return jnp.sum(jnp.sin(x))

    gp, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(p0), jnp.asarray(b))
    tp = torch.from_numpy(p0).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    x = kspd.SPDSolve.apply(torch.from_numpy(a) + tp + tp.transpose(1, 2), tb)
    tgp, tgb = torch.autograd.grad(torch.sin(x).sum(), (tp, tb))
    np.testing.assert_allclose(tgp.numpy(), np.asarray(gp), rtol=0, atol=5e-6)
    np.testing.assert_allclose(tgb.numpy(), np.asarray(gb), rtol=0, atol=5e-6)


def test_shared_memory_gate():
    assert kspd.max_kernel_m(2) == 239
    assert kspd.fits_shared_memory(239, 2) and not kspd.fits_shared_memory(240, 2)
    assert kspd.shared_bytes(239, 2) <= kspd.MAX_SHARED_BYTES < kspd.shared_bytes(240, 2)
    assert kspd.fits_shared_memory(kspd.max_kernel_m(1), 1)
    assert not kspd.fits_shared_memory(kspd.max_kernel_m(1) + 1, 1)


def test_rejects_what_it_cannot_take():
    a, b = torch.eye(3)[None], torch.zeros(1, 3, 2)
    with pytest.raises(ValueError):
        kspd.spd_solve(a[0], b)
    with pytest.raises(ValueError):
        kspd.spd_solve(a, torch.zeros(1, 4, 2))
    with pytest.raises(TypeError):
        kspd.spd_solve(a.double(), b)
    with pytest.raises(ValueError):
        kspd.spd_solve(a.to("meta"), b.to("meta"))


def _qeq_inputs(seed, g, m):
    rs = np.random.RandomState(seed)
    a, _ = _spd(seed, g, m, 1)
    mask = (np.arange(m)[None] < rs.randint(1, m + 1, size=g)[:, None]).astype(np.float32)
    mask[-1] = 0.0  # an empty graph
    a = np.where(mask[:, :, None] * mask[:, None, :] > 0, a,
                 np.eye(m, dtype=np.float32)[None])
    b = rs.randn(g, m).astype(np.float32) * mask
    qtot = rs.choice([-1.0, 0.0, 1.0], size=g).astype(np.float32)
    corner = (mask.sum(1) == 0).astype(np.float32)
    return a, mask, b, qtot, corner


@pytest.mark.parametrize("m", [21, 240], ids=["kernel", "beyond-the-gate"])
def test_dense_qeq_solve_matches_jax(m):
    """Within the gate the SPD solve, beyond it the Cholesky path; both
    equal to the JAX Cholesky solve, and the charges of each non-empty
    system sum to its total charge."""
    args = _qeq_inputs(5, 4, m)
    ref = np.asarray(jsolve_qeq_dense_cholesky(*map(jnp.asarray, args)))
    out = solve_qeq_dense_cholesky(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-6)
    mask, qtot = args[1], args[3]
    real = mask.sum(1) > 0
    np.testing.assert_allclose(out.sum(1)[real], qtot[real], rtol=0, atol=1e-5)
    assert not out[~real].any()
