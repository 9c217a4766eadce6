"""The port's iterative (matrix-free CG) Qeq solve against the JAX package's
``solve_qeq_iterative`` and a float64 dense solve, on the CPU.

Both packages run Jacobi-preconditioned CG in float32 to the relative
residual ``tol`` (default 1e-6) on the erf-kernel matvec computed in row
blocks; they agree with the float64 dense solve, and with each other,
within ``ATOL`` 5e-5 (``tests/test_qeq_solver.py``'s tolerance), and the
charges sum to the total charge. Derivatives are held against
``jax.grad``, central differences, ``gradcheck``/``gradgradcheck`` in
float64 and the dense solve's, through ``CENTCharge`` and a force-loss
training step (loss ``rtol 5e-5``, gradients within ``5e-4`` of each
tensor's largest entry: ``test_iterative_qeq_inside_full_force_train_step``'s
tolerances).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.layers.conv import hdnnp_electro as jelectro
from gcnn_keras_tpu.layers.conv import qeq_solver as jqs
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers.conv import hdnnp_electro as electro
from gcnn_keras_tpu_torch.layers.conv import qeq_solver as qs
from gcnn_keras_tpu_torch.ops.cuda import spd_solve as kspd
from tests.test_qeq_solver import _dense_reference, _system

torch.set_num_threads(1)

ATOL = 5e-5
LOSS_RTOL, GRAD_TOL = chip_smoke.CG_LOSS_RTOL, chip_smoke.CG_GRAD_TOL


def _torch(*arrays, dtype=None):
    return [torch.from_numpy(a if dtype is None else a.astype(dtype)) for a in arrays]


def _solve_counting(fn, *args, **kw):
    """``fn(*args, **kw)`` and the rounds of each CG call it made."""
    with chip_smoke.cg_rounds() as rounds:
        out = fn(*args, **kw)
    return out, rounds


def test_iterative_matches_jax_and_float64_dense_m1024():
    z, pos, mask, chi, sigma, hard = _system()
    qtot = 1.0
    q_dense = _dense_reference(*(a.astype(np.float64) for a in (pos, sigma, hard, chi)),
                               qtot, mask)
    q_jax = np.asarray(jqs.solve_qeq_iterative(
        *(jnp.asarray(a) for a in (pos, sigma, hard, chi)), jnp.float32(qtot),
        jnp.asarray(mask)))
    q, rounds = _solve_counting(qs.solve_qeq_iterative, *_torch(pos, sigma, hard, chi),
                                qtot, torch.from_numpy(mask))
    q = q.numpy()
    assert q.dtype == np.float32 and len(rounds) == 1 and 0 < rounds[0] < 10 * len(mask)
    np.testing.assert_allclose(q, q_dense, rtol=0, atol=ATOL)
    np.testing.assert_allclose(q, q_jax, rtol=0, atol=ATOL)
    assert abs(q.sum() - qtot) < 1e-4
    assert not q[~mask].any()


def test_iterative_float64_reaches_the_dense_solve():
    """In float64 at tol 1e-10 the CG charges are the dense ones to 1e-8."""
    z, pos, mask, chi, sigma, hard = _system()
    args64 = [a.astype(np.float64) for a in (pos, sigma, hard, chi)]
    q_dense = _dense_reference(*args64, -1.0, mask)
    q, rounds = _solve_counting(qs.solve_qeq_iterative, *_torch(*args64), -1.0,
                                torch.from_numpy(mask), tol=1e-10)
    assert q.dtype == torch.float64 and rounds[0] < 10 * len(mask)
    np.testing.assert_allclose(q.numpy(), q_dense, rtol=0, atol=1e-8)


def _mixed_batch():
    """Three molecules padded to M = 48: 40 atoms, 17 atoms and an empty
    one, with total charges 1, -1 and 0."""
    m, sizes = 48, (40, 17, 0)
    parts = [_system(m=m, n_real=n, seed=3 + i) for i, n in enumerate(sizes)]
    stack = [np.stack([p[k] for p in parts]) for k in range(1, 6)]
    pos, mask, chi, sigma, hard = stack
    return pos, mask, chi, sigma, hard, np.array([1.0, -1.0, 0.0], np.float32)


@pytest.mark.parametrize("block", [16, 128])
def test_batch_of_mixed_sizes_and_an_empty_molecule(block):
    """G = 3 in one batched CG, each system stopping on its own, against the
    JAX ``solve_qeq_iterative_batch`` (``vmap``) and each molecule's float64
    dense solve; ``block`` 16 runs three row blocks, 128 one padded block."""
    pos, mask, chi, sigma, hard, qtot = _mixed_batch()
    q_jax = np.asarray(jqs.solve_qeq_iterative_batch(
        *(jnp.asarray(a) for a in (pos, sigma, hard, chi, qtot, mask)), block=block))
    q, rounds = _solve_counting(qs.solve_qeq_iterative_batch,
                                *_torch(pos, sigma, hard, chi, qtot, mask), block=block)
    q = q.numpy()
    assert rounds[0] < 10 * mask.shape[1]
    np.testing.assert_allclose(q, q_jax, rtol=0, atol=ATOL)
    for i in range(2):
        ref = _dense_reference(*(a[i].astype(np.float64) for a in (pos, sigma, hard, chi)),
                               float(qtot[i]), mask[i])
        np.testing.assert_allclose(q[i], ref, rtol=0, atol=ATOL)
        assert abs(q[i].sum() - qtot[i]) < 1e-4
    assert not q[2].any() and np.isfinite(q).all()


def test_first_derivative_matches_jax_and_central_differences():
    """d/dpos sum(q^2) on ``tests/test_qeq_solver.py``'s differentiability
    system (M 128, 120 atoms): against ``jax.grad`` of the JAX solve, and
    one entry against central differences as that test takes them."""
    z, pos, mask, chi, sigma, hard = _system(m=128, n_real=120)
    const = [jnp.asarray(a) for a in (sigma, hard, chi)]

    def jsum(p):
        q = jqs.solve_qeq_iterative(p, *const, jnp.float32(0.0), jnp.asarray(mask))
        return jnp.sum(q ** 2)

    g_jax = np.asarray(jax.grad(jsum)(jnp.asarray(pos)))
    sig_t, hard_t, chi_t = _torch(sigma, hard, chi)
    mask_t = torch.from_numpy(mask)

    def tsum(p):
        return torch.sum(qs.solve_qeq_iterative(p, sig_t, hard_t, chi_t, 0.0, mask_t) ** 2)

    pos_t = torch.from_numpy(pos).requires_grad_()
    (g,) = torch.autograd.grad(tsum(pos_t), pos_t)
    g = g.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, g_jax, rtol=0, atol=1e-3 * np.abs(g_jax).max())
    eps = 1e-2
    p2, p3 = pos.copy(), pos.copy()
    p2[5, 0] += eps
    p3[5, 0] -= eps
    with torch.no_grad():
        num = (tsum(torch.from_numpy(p2)) - tsum(torch.from_numpy(p3))).item() / (2 * eps)
    assert abs(g[5, 0] - num) < 2e-3 + 0.05 * abs(num)


def test_gradcheck_and_gradgradcheck_float64():
    """Every input of the solve (positions, widths, diagonal, chi) to second
    order, in float64 at tol 1e-13, two molecules (one with padding) over
    two row blocks."""
    gen = torch.Generator().manual_seed(0)
    g, m = 2, 7
    pos = (torch.rand(g, m, 3, generator=gen, dtype=torch.float64) * 4).requires_grad_()
    sigma = (torch.rand(g, m, generator=gen, dtype=torch.float64) * 0.5 + 1).requires_grad_()
    diag = (torch.rand(g, m, generator=gen, dtype=torch.float64) * 2 + 3).requires_grad_()
    chi = torch.randn(g, m, generator=gen, dtype=torch.float64).requires_grad_()
    mask = torch.ones(g, m, dtype=torch.bool)
    mask[1, 5:] = False
    qtot = torch.tensor([0.0, 1.0], dtype=torch.float64)

    def f(*args):
        return qs.solve_qeq_iterative_batch(*args[:3], args[3], qtot, mask, block=4, tol=1e-13)
    assert torch.autograd.gradcheck(f, (pos, sigma, diag, chi))
    assert torch.autograd.gradgradcheck(f, (pos, sigma, diag, chi))


def _cent_batches():
    """``tests/test_qeq_solver.py::test_centcharge_iterative_matches_dense_path``'s
    batch (molecules of 6 and 9 atoms, all pairs as edges, padded to 3
    graphs) for both packages, and its electronegativities."""
    rs = np.random.RandomState(5)
    graphs = []
    for n in (6, 9):
        ei = np.array([[i, j] for i in range(n) for j in range(n) if i != j], dtype=np.int64)
        graphs.append({
            "node_number": rs.choice([1, 6, 8], size=n).astype(np.int64),
            "node_coordinates": (rs.rand(n, 3) * 4).astype(np.float32),
            "edge_indices": ei,
            "total_charge": np.array([rs.choice([-1.0, 0.0, 1.0])], dtype=np.float32)})
    kw = dict(n_node_pad=24, n_edge_pad=160, n_graph_pad=3, global_keys=("total_charge",))
    jb = jbatch_graphs(graphs, **kw)
    chi = rs.randn(jb.n_node).astype(np.float32)
    return graphs, jb, batch_graphs(graphs, device="cpu", **kw), chi


@pytest.mark.parametrize("layer", [dict(solver="iterative"),
                                   dict(solver="auto", iterative_threshold=4)],
                         ids=["iterative", "auto-past-threshold"])
def test_cent_charge_takes_cg_and_matches_dense_and_jax(layer):
    graphs, jb, tb, chi = _cent_batches()
    chi_t = torch.from_numpy(chi)
    q_dense = electro.CENTCharge(solver="dense")(tb, chi_t)
    solves, before = qs.solves, kspd.launches
    q = electro.CENTCharge(**layer)(tb, chi_t)
    assert qs.solves == solves + 1 and kspd.launches == before
    q_jax = jelectro.CENTCharge(solver="iterative").apply({}, jb, jnp.asarray(chi))
    np.testing.assert_allclose(q.numpy(), q_dense.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_jax), rtol=0, atol=2e-5)
    gid, nm = tb.graph_id.numpy(), tb.node_mask.numpy()
    for i, g in enumerate(graphs):
        assert abs(q.numpy()[(gid == i) & nm].sum() - g["total_charge"][0]) < 1e-4


def test_cent_charge_position_derivatives_match_dense_to_second_order():
    """The derivative of sum(sin q) along positions, and the derivative of
    its squared norm (grad-of-grad), iterative against dense."""
    _, _, tb, chi = _cent_batches()
    chi_t = torch.from_numpy(chi)
    out = {}
    for solver in ("dense", "iterative"):
        layer = electro.CENTCharge(solver=solver, cg_tol=1e-7)
        pos = tb.nodes["node_coordinates"].clone().requires_grad_()
        f = torch.sum(torch.sin(layer(tb, chi_t, positions=pos)) * tb.node_mask)
        (g,) = torch.autograd.grad(f, pos, create_graph=True)
        (h,) = torch.autograd.grad(torch.sum(g ** 2), pos)
        out[solver] = (g.detach().numpy(), h.numpy())
    for a, b in zip(out["iterative"], out["dense"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_TOL * np.abs(b).max())


@pytest.mark.parametrize("n", [48, 250])
def test_force_loss_step_iterative_matches_dense(n):
    """``chip_smoke.py`` phase 18's comparison on the CPU: one force-loss
    training step of the molecule-scale model (50 q + E + 200 F, through
    the forces, so through the solve's derivatives twice) on one molecule
    of ``n`` atoms, ``solver="iterative"`` against ``"dense"`` on the same
    weights, in float32; the kernel calls and the CG solves per step are the
    derived counts. 48 atoms solve densely on the SPD kernel's path, 250 by
    Cholesky."""
    batch = chip_smoke.train_batch("hdnnp4th_mol200_train", 3, n, "cpu")
    res = {}
    for solver in ("dense", "iterative"):
        model, trainer, state = chip_smoke.make_trainer("hdnnp4th_mol200_train", "cpu", solver)
        with chip_smoke.captured_calls() as calls, chip_smoke.cg_rounds() as rounds:
            state, metrics = trainer.step_fn()(state, batch)
        res[solver] = (float(metrics["loss"]), {k: p.grad for k, p in model.named_parameters()},
                       {k: len(c) for k, c in calls.items() if c}, rounds)
    (l_d, g_d, c_d, r_d), (l_c, g_c, c_c, r_c) = res["dense"], res["iterative"]
    expected = {k: v for k, v in chip_smoke.mol_launches(n, train=True).items() if v}
    assert c_d == expected and r_d == []
    assert c_c == {k: v for k, v in expected.items() if k != "spd_solve"}
    assert len(r_c) == chip_smoke.CG_SOLVES["train"] and max(r_c) < 10 * n
    np.testing.assert_allclose(l_c, l_d, rtol=LOSS_RTOL)
    assert len(g_d) == len(g_c) > 0
    for k, ref in g_d.items():
        assert (g_c[k] - ref).abs().max() <= GRAD_TOL * ref.abs().max(), k


def test_cg_solves_per_evaluation_are_the_derived_count():
    """An energy+force evaluation solves twice (the charges, then their
    adjoint in the force pass)."""
    batch = chip_smoke.train_batch("hdnnp4th_mol200_train", 3, 30, "cpu")
    fm = chip_smoke.energy_force_model("hdnnp4th_mol", "cpu", solver="iterative")
    with chip_smoke.cg_rounds() as rounds:
        out = fm.apply(batch)
    assert len(rounds) == chip_smoke.CG_SOLVES["eval"]
    assert torch.isfinite(out["force"]).all()
    assert abs(out["charge"].sum().item()) < 1e-4


def test_dense_solve_is_unchanged_by_the_split_tables():
    """``CENTCharge.assemble`` builds the dense system from ``tables``: the
    padded per-atom tables, with the physical diagonal on real atoms and 1
    on padding rows."""
    _, _, tb, chi = _cent_batches()
    layer = electro.CENTCharge()
    pos, b, sig, diag, mask, qtot = layer.tables(tb, torch.from_numpy(chi))
    a, mask2, b2, qtot2, corner = layer.assemble(tb, torch.from_numpy(chi))
    assert torch.equal(mask, mask2) and torch.equal(b, b2) and torch.equal(qtot, qtot2)
    assert torch.equal(torch.diagonal(a, dim1=1, dim2=2), diag)
    assert torch.equal(diag[mask == 0], torch.ones_like(diag[mask == 0]))
    assert corner.tolist() == [0.0, 0.0, 1.0]
    real = mask.bool()
    z = tb.nodes["node_number"].long()
    assert torch.allclose(diag[real], (layer.hardness_j[z] + 1.0 / (
        layer.sigma[z] * math.sqrt(math.pi) + 1e-12))[tb.node_mask])
