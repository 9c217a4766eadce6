"""The port's fused SchNet interaction chain (``ops/cuda/fused_interaction.py``)
against the JAX package's (``ops/pallas/fused_interaction.py``), on the CPU.

- The three plain kernel versions against the Pallas kernels ``_cf_fwd``,
  ``_cf_vjp`` and ``_cf_hesjvp`` in interpret mode on
  ``tests/test_fused_interaction.py``'s ``_case`` (senders within 40 rows),
  and against ``jax.vjp``/``jax.jvp``/``jax.grad`` of its ``_ref_chain``
  where senders lie far from their receivers (the Pallas kernels cover
  128-row windows only; the CUDA kernels any distance). The augmented
  weights' cotangents are compared by their slices.
- ``CF``/``BWD`` against ``cfconv_fused_chain(interpret=True)`` under
  ``jax.grad``: all six first-order cotangents, and the reverse-over-reverse
  loss of that file, at its tolerances (2e-4; 3e-4 of the largest entry);
  float64 ``gradcheck``/``gradgradcheck``; a third derivative raises.
- A float64 mirror of the CUDA kernels' hand-written derivatives (no
  autograd; ``csrc/fused_interaction.cu`` transcribes it line by line)
  against the ``torch.func`` plain versions, coincident positions included.
- The model: ``make_model(interaction_args={"fused_chain": True})`` with the
  JAX fused-chain model's weights (``params_from_jax``): energies and forces
  on real nodes (rtol 1e-5, atol 1e-5 max|reference|), the bench loss E +
  100 F's parameter gradients within 1e-4 of each tensor's largest entry,
  the unfused model's parameter names, the ``ValueError``s, the periodic
  fallback, and the kernel calls per evaluation and per training step.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from bench import _mols
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models.schnet import make_model as jmake_model
from gcnn_keras_tpu.ops.pallas import fused_interaction as jfi
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models.schnet import make_model
from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
from gcnn_keras_tpu_torch.training import Trainer
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from tests.test_fused_interaction import _case, _ref_chain
from tests.test_torch_schnet import _crystals

torch.set_num_threads(1)

GRAD_TOL = 1e-4
SMALL = dict(depth=2, gauss_args={"bins": 8, "distance_max": 4.0},
             input_embedding={"node": {"input_dim": 95, "output_dim": 16}},
             last_mlp={"units": [32, 16]}, output_mlp={"units": [16, 1]})


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _far(seed=4, n_node=300, n_edge=900, units=16, bins=8):
    """``_case`` with every sender 100-200 rows from its receiver."""
    st, x, pos, w1, b1, w2, b2, send, recv, mask = _case(seed, n_node, n_edge, units, bins)
    rs = np.random.RandomState(seed + 100)
    send = ((recv + rs.randint(100, 201, n_edge)) % n_node).astype(np.int32)
    return st, x, pos, w1, b1, w2, b2, send, recv, mask


def _torch_case(case):
    st, x, pos, w1, b1, w2, b2, send, recv, mask = case
    return (fi.CFStatic(*st), [_t(a) for a in (x, pos, w1, b1, w2, b2)],
            (_t(send), _t(recv), _t(mask)))


def _slices(st, w1a, w2a):
    """``(W1, b1, W2, b2)`` cut from the augmented weights (``_augment``)."""
    b, u = st.bins, st.units
    return w1a[:b, :u], w1a[b, :u], w2a[:u, :u], w2a[st.u_pad, :u]


def _close(got, want, rtol, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _jax_ref_derivatives(case, ct, tangents):
    """``(y, vjp, (J u, grad <ct, J u>))`` of ``_ref_chain`` by JAX's
    autodiff, the augmented-free reference of the three kernels."""
    st, x, pos, w1, b1, w2, b2, send, recv, mask = case
    res = tuple(jnp.asarray(a) for a in (x, pos, w1, b1, w2, b2))

    def fwd(*r):
        return _ref_chain(*r, send, recv, mask, st, x.shape[0])

    y, pull = jax.vjp(fwd, *res)

    def s_fn(*r):
        ju = jax.jvp(fwd, r, tuple(jnp.asarray(t) for t in tangents))[1]
        return jnp.sum(jnp.asarray(ct) * ju), ju

    grads, ju = jax.grad(s_fn, argnums=tuple(range(6)), has_aux=True)(*res)
    return y, pull(jnp.asarray(ct)), (ju, *grads)


def _draws(case, seed=9):
    st, x, pos, w1, b1, w2, b2, *_ = case
    rs = np.random.RandomState(seed)
    ct = rs.randn(x.shape[0], st.units).astype(np.float32)
    tangents = [rs.randn(*a.shape).astype(np.float32) for a in (x, pos, w1, b1, w2, b2)]
    return ct, tangents


# ------------------------------------------------ plain versions against JAX


def test_fwd_plain_matches_the_pallas_kernel():
    case = _case()
    st, x, pos, w1, b1, w2, b2, send, recv, mask = case
    w1a, w2a = jfi._augment(w1, b1, w2, b2, st)
    want = jfi._cf_fwd(x, pos, w1a, w2a, send, recv, mask, st, x.shape[0], interpret=True)
    tst, res, edges = _torch_case(case)
    _close(fi.cf_fwd_plain(*res, *edges, tst), want, 2e-5, 2e-5)


def test_vjp_plain_matches_the_pallas_kernel():
    case = _case(seed=1)
    st, x, pos, w1, b1, w2, b2, send, recv, mask = case
    ct, _ = _draws(case)
    w1a, w2a = jfi._augment(w1, b1, w2, b2, st)
    d_x, d_pos, dw1a, dw2a = jfi._cf_vjp(x, pos, w1a, w2a, ct, send, recv, mask, st,
                                         x.shape[0], interpret=True)
    tst, res, edges = _torch_case(case)
    got = fi.cf_vjp_plain(*res, _t(ct), *edges, tst)
    for g, w in zip(got, (d_x, d_pos, *_slices(st, dw1a, dw2a))):
        _close(g, w, 2e-4, 2e-4)


def test_hesjvp_plain_matches_the_pallas_kernel():
    case = _case(seed=2, n_node=90, n_edge=300)
    st, x, pos, w1, b1, w2, b2, send, recv, mask = case
    ct, (ux, upos, uw1, ub1, uw2, ub2) = _draws(case, 10)
    w1a, w2a = jfi._augment(w1, b1, w2, b2, st)
    uw1a, uw2a = jfi._augment(uw1, ub1, uw2, ub2, st)
    ju, w_x, w_pos, ww1a, ww2a = jfi._cf_hesjvp(
        x, pos, w1a, w2a, ct, ux, upos, uw1a, uw2a, send, recv, mask, st, x.shape[0],
        interpret=True)
    tst, res, edges = _torch_case(case)
    got = fi.cf_hesjvp_plain(*res, _t(ct), *(_t(a) for a in (ux, upos, uw1, ub1, uw2, ub2)),
                             *edges, tst)
    for g, w in zip(got, (ju, w_x, w_pos, *_slices(st, ww1a, ww2a))):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        _close(g / scale, np.asarray(w) / scale, 3e-4, 3e-4)


def test_hesjvp_plain_without_weight_tangents_matches_the_pallas_kernel():
    """The call a force loss makes: ``u_w1`` .. ``u_b2`` absent (``None``)
    against ``_cf_hesjvp`` in interpret mode with those tangents zero."""
    case = _case(seed=2, n_node=90, n_edge=300)
    st, x, pos, w1, b1, w2, b2, send, recv, mask = case
    ct, (ux, upos, *weight_tangents) = _draws(case, 12)
    zeros = [np.zeros_like(t) for t in weight_tangents]
    w1a, w2a = jfi._augment(w1, b1, w2, b2, st)
    uw1a, uw2a = jfi._augment(*zeros, st)
    ju, w_x, w_pos, ww1a, ww2a = jfi._cf_hesjvp(
        x, pos, w1a, w2a, ct, ux, upos, uw1a, uw2a, send, recv, mask, st, x.shape[0],
        interpret=True)
    tst, res, edges = _torch_case(case)
    got = fi.cf_hesjvp_plain(*res, _t(ct), _t(ux), _t(upos), None, None, None, None,
                             *edges, tst)
    for g, w in zip(got, (ju, w_x, w_pos, *_slices(st, ww1a, ww2a))):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        _close(g / scale, np.asarray(w) / scale, 3e-4, 3e-4)


@pytest.mark.parametrize("absent", [("w1", "b1", "w2", "b2"), ("x", "w1", "b1", "w2", "b2"),
                                    ("pos",), ("x", "b2")])
def test_an_absent_tangent_is_zero(absent):
    """The wrapper (on the CPU, the plain version) gives, for a tangent that
    is ``None``, exactly what it gives for zeros."""
    st, res, edges = _double_case(seed=7, n=20, e=80, u=6, b=5)
    res = [t.detach().float() for t in res]
    rs = np.random.RandomState(8)
    ct = torch.from_numpy(rs.randn(*res[0].shape).astype(np.float32))
    names = ("x", "pos", "w1", "b1", "w2", "b2")
    tangents = [torch.from_numpy(rs.randn(*t.shape).astype(np.float32)) for t in res]
    zeros = [torch.zeros_like(t) if n in absent else t for n, t in zip(names, tangents)]
    nones = [None if n in absent else t for n, t in zip(names, tangents)]
    for g, w in zip(fi.cf_hesjvp(*res, ct, *nones, *edges, st),
                    fi.cf_hesjvp(*res, ct, *zeros, *edges, st)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_plain_versions_match_jax_autodiff_with_far_senders():
    """Senders 100-200 rows from their receivers, where the Pallas kernels'
    windows do not reach: all three plain versions against JAX's autodiff
    of ``_ref_chain``."""
    case = _far()
    ct, tangents = _draws(case, 11)
    y, vjp, hes = _jax_ref_derivatives(case, ct, tangents)
    tst, res, edges = _torch_case(case)
    _close(fi.cf_fwd_plain(*res, *edges, tst), y, 2e-5, 2e-5)
    for g, w in zip(fi.cf_vjp_plain(*res, _t(ct), *edges, tst), vjp):
        _close(g, w, 2e-4, 2e-4)
    got = fi.cf_hesjvp_plain(*res, _t(ct), *(_t(a) for a in tangents), *edges, tst)
    for g, w in zip(got, hes):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        _close(g / scale, np.asarray(w) / scale, 3e-4, 3e-4)


# ----------------------------------------------------- the Functions and JAX


def test_functions_first_order_match_jax():
    """``CF``'s backward (``BWD``, kernel #6) against ``jax.grad`` through
    ``cfconv_fused_chain`` in interpret mode: all six cotangents."""
    case = _case(seed=1)
    st, x, pos, w1, b1, w2, b2, send, recv, mask = case
    ct, _ = _draws(case)

    def loss(*res):
        y = jfi.cfconv_fused_chain(*res, send, recv, mask, st, x.shape[0], interpret=True)
        return jnp.sum(y * ct)

    want = jax.grad(loss, argnums=tuple(range(6)))(x, pos, w1, b1, w2, b2)
    tst, res, edges = _torch_case(case)
    res = [t.requires_grad_(True) for t in res]
    got = torch.autograd.grad((fi.cfconv_fused_chain(*res, *edges, tst) * _t(ct)).sum(), res)
    for g, w in zip(got, want):
        _close(g, w, 2e-4, 2e-4)


def test_functions_reverse_over_reverse_match_jax():
    """The energy+force training traversal of
    ``tests/test_fused_interaction.py``: a loss on E and F = -dE/dpos,
    differentiated along x and the filter weights."""
    case = _case(seed=2, n_node=90, n_edge=300)
    st, x, pos, w1, b1, w2, b2, send, recv, mask = case
    rs = np.random.RandomState(10)
    f_tgt = rs.randn(*pos.shape).astype(np.float32)
    readout = rs.randn(x.shape[0], st.units).astype(np.float32)

    def jloss(x_, w1_, b1_, w2_, b2_):
        def e_fn(p):
            y = jfi.cfconv_fused_chain(x_, p, w1_, b1_, w2_, b2_, send, recv, mask, st,
                                       x.shape[0], interpret=True)
            return jnp.sum(y * readout)
        e, de = jax.value_and_grad(e_fn)(pos)
        return 0.1 * e + jnp.sum((-de - f_tgt) ** 2)

    want_loss = jloss(x, w1, b1, w2, b2)
    want = jax.grad(jloss, argnums=tuple(range(5)))(x, w1, b1, w2, b2)
    tst, (tx, tpos, *tw), edges = _torch_case(case)
    params = [t.requires_grad_(True) for t in (tx, *tw)]
    p = tpos.requires_grad_(True)
    e = (fi.cfconv_fused_chain(params[0], p, *params[1:], *edges, tst) * _t(readout)).sum()
    (de,) = torch.autograd.grad(e, p, create_graph=True)
    loss = 0.1 * e + ((-de - _t(f_tgt)) ** 2).sum()
    got = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4)
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        _close(g / scale, np.asarray(w) / scale, 3e-4, 3e-4)


def test_force_loss_reaches_the_second_reverse_pass_without_weight_tangents(monkeypatch):
    """``BWD`` under ``set_materialize_grads(False)``: a force loss uses
    only ``BWD``'s position cotangent, so kernel #7 is called once with
    ``u_pos`` and every other tangent absent (a counting patch on the
    wrapper), and the parameter gradients equal ``jax.grad`` of the JAX
    fused chain's force loss."""
    case = _case(seed=3, n_node=90, n_edge=300)
    st, x, pos, w1, b1, w2, b2, send, recv, mask = case
    f_tgt = np.random.RandomState(13).randn(*pos.shape).astype(np.float32)

    def jloss(x_, w1_, b1_, w2_, b2_):
        def e_fn(p):
            y = jfi.cfconv_fused_chain(x_, p, w1_, b1_, w2_, b2_, send, recv, mask, st,
                                       x.shape[0], interpret=True)
            return jnp.sum(y * y)
        return jnp.sum((-jax.grad(e_fn)(pos) - f_tgt) ** 2)

    want = jax.grad(jloss, argnums=tuple(range(5)))(x, w1, b1, w2, b2)
    calls = []
    original = fi.cf_hesjvp

    def counting(*args):
        calls.append(["absent" if a is None else "given" for a in args[7:13]])
        return original(*args)
    monkeypatch.setattr(fi, "cf_hesjvp", counting)
    tst, (tx, tpos, *tw), edges = _torch_case(case)
    params = [t.requires_grad_(True) for t in (tx, *tw)]
    p = tpos.requires_grad_(True)
    y = fi.cfconv_fused_chain(params[0], p, *params[1:], *edges, tst)
    (de,) = torch.autograd.grad((y * y).sum(), p, create_graph=True)
    got = torch.autograd.grad(((-de - _t(f_tgt)) ** 2).sum(), params)
    assert calls == [["absent", "given", "absent", "absent", "absent", "absent"]]
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        _close(g / scale, np.asarray(w) / scale, 3e-4, 3e-4)


def _double_case(seed=3, n=12, e=40, u=4, b=5, coincident=True):
    """A float64 case with masked edges and, if ``coincident``, a pair of
    atoms at one position with an edge between them."""
    rs = np.random.RandomState(seed)
    st = fi.CFStatic(bins=b, distance_max=3.0, offset=0.1, sigma=0.5, units=u)
    pos = rs.randn(n, 3) * 1.2
    if coincident:
        pos[1] = pos[0]
    recv = np.sort(rs.randint(0, n, e))
    send = rs.randint(0, n, e)
    recv[0], send[0] = 0, 1
    mask = rs.rand(e) > 0.15
    res = [torch.from_numpy(a).requires_grad_(True) for a in (
        rs.randn(n, u), pos, rs.randn(b, u) * 0.5, rs.randn(u) * 0.1, rs.randn(u, u) * 0.4,
        rs.randn(u) * 0.1)]
    edges = (_t(send, torch.int32), _t(recv, torch.int32), _t(mask))
    return st, res, edges


def test_gradcheck_and_gradgradcheck_in_float64():
    # no coincident atoms: finite differences across the 1e-12 clamp are
    # not derivatives (the mirror test below covers the clamp)
    st, res, edges = _double_case(coincident=False)

    def fn(*r):
        return fi.cfconv_fused_chain(*r, *edges, st)
    assert torch.autograd.gradcheck(fn, res, eps=1e-6, atol=1e-6)
    assert torch.autograd.gradgradcheck(fn, res, eps=1e-6, atol=1e-6)


def test_a_third_derivative_raises():
    """A graph through BWD's backward (kernel #7) raises when differentiated,
    and never gives zeros."""
    st, res, edges = _double_case()
    y = fi.cfconv_fused_chain(*res, *edges, st)
    (g,) = torch.autograd.grad(y.pow(2).sum(), res[1], create_graph=True)
    (h,) = torch.autograd.grad(g.pow(2).sum(), res[2], create_graph=True)
    assert h.abs().max() > 0
    with pytest.raises(RuntimeError, match="third derivative"):
        torch.autograd.grad(h.sum(), res[2])


# --------------------------------------------- the hand-written derivatives


def _mirror_geometry(st, pos, s, r, mask):
    v = pos[s] - pos[r]
    d2 = (v * v).sum(-1)
    live = (d2 > fi.EPS) & mask
    rr = torch.where(d2 > fi.EPS, torch.sqrt(d2.clamp_min(fi.EPS)),
                     torch.full_like(d2, math.sqrt(fi.EPS)))
    diff = rr[:, None] - st.shifts(pos.dtype, pos.device)
    return v, rr, live, torch.exp(st.gamma * diff * diff), 2.0 * st.gamma * diff


def _mirror_hidden(z):
    t = torch.exp(-z.abs())
    return (z.clamp_min(0) + torch.log1p(t) - math.log(2.0),
            torch.where(z >= 0, 1.0 / (1.0 + t), t / (1.0 + t)))


def _vjp_mirror(x, pos, w1, b1, w2, b2, ct, send, recv, mask, st):
    """Kernel #6 written out as ``csrc/fused_interaction.cu`` computes it."""
    s, r = send.long(), recv.long()
    m = mask.to(x.dtype)[:, None]
    v, rr, live, b, g = _mirror_geometry(st, pos, s, r, mask)
    h, sig = _mirror_hidden(b @ w1 + b1)
    f = h @ w2 + b2
    c, xj = ct[r], x[s]
    ct_x = torch.zeros_like(x).index_add(0, s, c * f * m)
    a = c * xj * m                                  # the cotangent of F
    dz = (a @ w2.t()) * sig                         # of z
    rbar = (dz * ((b * g) @ w1)).sum(-1)            # of r
    dv = torch.where(live[:, None], rbar[:, None] * v / rr[:, None], torch.zeros_like(v))
    ct_pos = torch.zeros_like(pos).index_add(0, s, dv).index_add(0, r, -dv)
    return ct_x, ct_pos, b.t() @ dz, dz.sum(0), h.t() @ a, a.sum(0)


def _hesjvp_mirror(x, pos, w1, b1, w2, b2, ct, ux, upos, uw1, ub1, uw2, ub2, send, recv,
                   mask, st):
    """Kernel #7 written out as ``csrc/fused_interaction.cu`` computes it."""
    s, r = send.long(), recv.long()
    m = mask.to(x.dtype)[:, None]
    v, rr, live, b, g = _mirror_geometry(st, pos, s, r, mask)
    du = upos[s] - upos[r]
    dr = torch.where(live, (v * du).sum(-1) / rr, torch.zeros_like(rr))
    h, sig = _mirror_hidden(b @ w1 + b1)
    dz = (b * g * dr[:, None]) @ w1 + b @ uw1 + ub1     # the tangent of z
    dh = sig * dz
    f = h @ w2 + b2
    df = dh @ w2 + h @ uw2 + ub2                          # of F
    xj, uxj, c = x[s], ux[s], ct[r]
    ju = torch.zeros_like(x).index_add(0, r, (df * xj + f * uxj) * m)
    w_x = torch.zeros_like(x).index_add(0, s, c * df * m)
    a, q = c * xj * m, c * uxj * m              # d<c, J u> / d dF and / d F
    abar = a @ w2.t()                           # / d dh
    hbar = a @ uw2.t() + q @ w2.t()             # / d h
    dzbar = abar * sig
    zbar = hbar * sig + abar * sig * (1 - sig) * dz
    bg = (b * g) @ w1
    drbar = (dzbar * bg).sum(-1)
    rbar = ((dzbar * ((b * (g * g + 2 * st.gamma)) @ w1)).sum(-1) * dr
            + (dzbar * ((b * g) @ uw1)).sum(-1) + (zbar * bg).sum(-1))
    vh = v / rr[:, None]
    wv = rbar[:, None] * vh + drbar[:, None] * (du - dr[:, None] * vh) / rr[:, None]
    wv = torch.where(live[:, None], wv, torch.zeros_like(wv))
    w_pos = torch.zeros_like(pos).index_add(0, s, wv).index_add(0, r, -wv)
    w_w1 = (b * g * dr[:, None]).t() @ dzbar + b.t() @ zbar
    return ju, w_x, w_pos, w_w1, zbar.sum(0), dh.t() @ a + h.t() @ q, q.sum(0)


@pytest.mark.parametrize("kernel", ["cf_vjp", "cf_hesjvp"])
def test_hand_derivation_matches_autodiff_in_float64(kernel):
    """The mirror of the CUDA kernels' derivatives against the ``torch.func``
    plain versions, coincident positions and masked edges included."""
    st, res, edges = _double_case(seed=5, n=40, e=200, u=8, b=6)
    res = [t.detach() for t in res]
    rs = np.random.RandomState(6)
    ct = torch.from_numpy(rs.randn(*res[0].shape))
    tangents = [torch.from_numpy(rs.randn(*t.shape)) for t in res]
    if kernel == "cf_vjp":
        got = _vjp_mirror(*res, ct, *edges, st)
        want = fi.cf_vjp_plain(*res, ct, *edges, st)
    else:
        got = _hesjvp_mirror(*res, ct, *tangents, *edges, st)
        want = fi.cf_hesjvp_plain(*res, ct, *tangents, *edges, st)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- the model


def _shared(graphs, global_keys=(), kw=SMALL, monkeypatch=None):
    """The JAX fused-chain EnergyForceModel with init params (Pallas kernels
    in interpret mode), and the port's fused-chain model holding the same
    weights; both batches."""
    monkeypatch.setattr(jfi, "FORCE_INTERPRET", True)
    kw = dict(kw, interaction_args={"units": 32, "fused_chain": True})
    jb = jbatch_graphs(graphs, global_keys=global_keys)
    jm = JEnergyForceModel(jmake_model(**kw))
    params = jax.jit(lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(1), jb)
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = EnergyForceModel(params_from_jax(make_model(device="cpu", **kw), params),
                          device="cpu")
    return jm, params, jb, tm, batch_graphs(graphs, global_keys=global_keys, device="cpu")


def test_model_energy_force_match_the_jax_fused_chain(monkeypatch):
    graphs = [{k: v for k, v in g.items() if k not in ("energy", "force")}
              for g in _mols(np.random.RandomState(0), 6)]
    jm, params, jb, tm, tb = _shared(graphs, monkeypatch=monkeypatch)
    ref = jax.jit(lambda p, b: jm.apply(p, b, train=False))(params, jb)
    out = tm.apply(tb)
    e_ref = np.asarray(ref["energy"])
    _close(out["energy"], e_ref, 1e-5, 1e-5 * np.abs(e_ref).max())
    real = tb.node_mask.numpy()
    f_ref = np.asarray(ref["force"])[real]
    _close(out["force"][real], f_ref, 1e-5, 1e-5 * np.abs(f_ref).max())


def test_model_force_loss_gradients_match_the_jax_fused_chain(monkeypatch):
    """The bench's SchNet loss E + 100 F differentiated along the parameters
    through the forces (CF -> BWD -> kernel #7), against
    ``jax.value_and_grad`` of the JAX fused-chain model."""
    graphs = _mols(np.random.RandomState(11), 3)
    jm, params, jb, tm, tb = _shared(graphs, ("energy",), monkeypatch=monkeypatch)

    def jloss(params, b):
        out = jm.apply(params, b, train=False)
        return (jlosses.masked_graph_mae(out["energy"], b.globals["energy"],
                                         b.globals["graph_mask"])
                + 100.0 * jlosses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask))

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params, jb)
    loss, _ = chip_smoke.ef_loss_fn(tm, 100.0)(tb)
    grads = torch.autograd.grad(loss, list(tm.energy_model.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    kw = dict(SMALL, interaction_args={"units": 32, "fused_chain": True})
    ref = dict(params_from_jax(make_model(device="cpu", **kw),
                               jax.tree_util.tree_map(np.asarray, ref_grads)).named_parameters())
    names = [n for n, _ in tm.energy_model.named_parameters()]
    assert len(names) == len(grads) == len(ref) > 0
    for n, g in zip(names, grads):
        r = ref[n].detach().numpy()
        err = np.abs(g.numpy() - r).max()
        assert err <= GRAD_TOL * np.abs(r).max(), (n, err, np.abs(r).max())


def test_model_keeps_the_unfused_parameter_tree():
    chain = chip_smoke.schnet_model("chain", "cpu", depth=2)
    plain = chip_smoke.schnet_model("unfused", "cpu", depth=2)
    assert [(n, p.shape) for n, p in chain.named_parameters()] == [
        (n, p.shape) for n, p in plain.named_parameters()]
    for (_, a), (_, b) in zip(chain.named_parameters(), plain.named_parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw,match", [
    (dict(interaction_args={"fused_chain": True, "activation": "swish"}), "reference cfconv"),
    (dict(interaction_args={"fused_chain": True, "use_bias": False}), "reference cfconv"),
    (dict(interaction_args={"fused_chain": True, "cfconv_pool": "mean"}), "reference cfconv"),
    (dict(interaction_args={"fused_chain": True}, make_distance=False), "make_distance"),
    (dict(interaction_args={"fused_chain": True}, expand_distance=False), "expand_distance"),
])
def test_model_refuses_what_the_chain_cannot_compute(kw, match):
    with pytest.raises(ValueError, match=match):
        make_model(device="cpu", depth=1, **kw)


def test_layer_needs_gauss_args():
    from gcnn_keras_tpu_torch.layers.conv.schnet import SchNetInteraction
    with pytest.raises(ValueError, match="gauss_args"):
        SchNetInteraction(units=8, in_basis=4, fused_chain=True)


def test_periodic_batch_takes_the_unfused_path():
    """A periodic batch (``range_image``) has no fused chain: the model
    equals the unfused one with the same weights, and no chain kernel is
    called."""
    graphs = _crystals(2, 3)
    b = batch_graphs(graphs, device="cpu")
    assert fi.fused_chain_ineligibility(b)
    kw = dict(SMALL, interaction_args={"units": 32})
    chain = EnergyForceModel(chip_smoke.schnet_model("chain", "cpu", **kw), device="cpu")
    plain = EnergyForceModel(chip_smoke.schnet_model("unfused", "cpu", **kw), device="cpu")
    with chip_smoke.captured_calls() as calls:
        out = chain.apply(b)
    assert not any(calls[name] for name in fi.KERNELS)
    ref = plain.apply(b)
    for key in ("energy", "force"):
        torch.testing.assert_close(out[key], ref[key], rtol=0, atol=0)


def test_kernel_calls_per_evaluation_and_per_training_step():
    """The full-width fused-chain model of ``chip_smoke.py`` calls each
    kernel wrapper as ``chip_smoke.schnet_launches("chain")`` (an
    evaluation) and ``TRAIN_PATHS["schnet_chain_train"]`` (a step) say the
    card launches it; each recorded call reproduces its plain version."""
    fm = chip_smoke.energy_force_model("schnet", "cpu", "chain")
    with chip_smoke.captured_calls() as calls:
        fm.apply(batch_graphs(chip_smoke.qm9_like_mols(3, 3), device="cpu"))
    assert {k: len(v) for k, v in calls.items() if v} == {
        k: v for k, v in chip_smoke.schnet_launches("chain").items() if v}
    _, trainer, state = chip_smoke.make_trainer("schnet_chain_train", "cpu")
    with chip_smoke.captured_calls() as step_calls:
        trainer.step_fn()(state, chip_smoke.train_batch("schnet_chain_train", 3, 3, "cpu"))
    expected = chip_smoke.TRAIN_PATHS["schnet_chain_train"]["launches"]
    assert {k: len(v) for k, v in step_calls.items() if v} == {
        k: v for k, v in expected.items() if v}
    assert expected == chip_smoke.launch_counts(cf_fwd=4, cf_vjp=8, cf_hesjvp=4,
                                                sorted_segment_sum=2)
    table = chip_smoke.kernel_wrappers()
    for name in fi.KERNELS:
        mod, attr, plain = table[name]
        for args in step_calls[name]:
            out, ref = getattr(mod, attr)(*args), plain(*args)
            for o, r in zip(out if isinstance(out, tuple) else (out,),
                            ref if isinstance(ref, tuple) else (ref,)):
                torch.testing.assert_close(o, r, rtol=0, atol=0)


def test_chain_training_loss_falls_on_the_cpu():
    """Three fused-chain ``Trainer`` steps of the bench loss on a small
    batch: finite losses, the last below the first."""
    kw = dict(SMALL, interaction_args={"units": 32, "fused_chain": True})
    fm = EnergyForceModel(make_model(device="cpu", **kw), device="cpu")
    trainer = Trainer(chip_smoke.ef_loss_fn(fm, 100.0),
                      functools.partial(torch.optim.Adam, lr=1e-3))
    state = trainer.init_state(fm.energy_model.parameters())
    batch = chip_smoke.train_batch("schnet_chain_train", 4, 4, "cpu")
    losses = []
    for _ in range(3):
        state, metrics = trainer.step_fn()(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_wrappers_refuse_what_they_cannot_take():
    st, res, edges = _double_case()
    res = [t.detach().float() for t in res]
    send, recv, mask = edges
    with pytest.raises(ValueError, match="units"):
        fi.cf_fwd(*res, *edges, st._replace(units=5))
    with pytest.raises(ValueError, match="w2"):
        fi.cf_fwd(*res[:4], res[4][:, :2], res[5], *edges, st)
    with pytest.raises(TypeError, match="int32"):
        fi.cf_fwd(*res, send.long(), recv, mask, st)
    with pytest.raises(TypeError, match="bool"):
        fi.cf_fwd(*res, send, recv, mask.int(), st)
    with pytest.raises(ValueError, match=r"ct must be"):
        fi.cf_vjp(*res, res[0][:3], *edges, st)
    assert fi.fits_shared_memory(20, 128) and not fi.fits_shared_memory(20, 200)


def test_vjp_shared_memory_is_the_tiled_layout_and_the_gate_stays():
    """cf_vjp's block at B 20, U 128: W2 and W1 once, the W1 sum, the
    chunk's h, a and dz rows (32 edges of U), its basis rows, the centres and
    the per-edge scalars; the W2 sum lives in registers. One block a SM
    takes it. cf_hesjvp's tiled kernel (U up to 128) adds u_W1 and the
    chunk's dh, q and m rows. cf_fwd's tiled kernel keeps W2, W1 and the
    chunk's h and m rows, and two of its blocks fit an SM. The shared-memory
    gate stays that of cf_hesjvp's wide kernel (U above 128): U 148 at B 20."""
    up, e, b = 128, 32, 20
    # W2, W1; the h and m rows; basis rows, centres, per-edge scalars; 4
    # ints an edge and 4 spare
    floats = up * up + b * up + 2 * e * up + e * b + b + 13 * e
    need = fi.shared_memory_bytes("cf_fwd", 20, 128)
    assert need == 4 * (floats + 4 * e + 4) == 113376
    # two blocks, each with the 1 KB the card reserves a block, in the SM's 228 KB
    assert 2 * (need + 1024) <= 228 * 1024
    # the wide cf_fwd from U 129: 16-edge chunks of hidden rows (U rounded up
    # to 4), W2, W1, the centres, basis rows and distances; 3 ints an edge
    u, e16 = 129, 16
    floats = e16 * 132 + u * u + b * u + b + e16 * b + e16
    assert fi.shared_memory_bytes("cf_fwd", 20, 129) == 4 * (floats + 3 * e16 + 4)
    floats = up * up + 2 * b * up + 3 * e * up + e * b + b + 13 * e
    need = fi.shared_memory_bytes("cf_vjp", 20, 128)
    assert need == 4 * (floats + 4 * e + 4) == 140000
    assert fi.SHARED_MEMORY_BYTES // 2 < need <= fi.SHARED_MEMORY_BYTES
    # W2, W1, u_W1, the W1 sum; the h, dh, a, q and m rows; basis rows,
    # centres, per-edge scalars; 4 ints an edge and 4 spare
    floats = up * up + 3 * b * up + 5 * e * up + e * b + b + 13 * e
    need = fi.shared_memory_bytes("cf_hesjvp", 20, 128)
    assert need == 4 * (floats + 4 * e + 4) == 183008
    assert fi.SHARED_MEMORY_BYTES // 2 < need <= fi.SHARED_MEMORY_BYTES
    assert fi.TILED_UNITS == 128
    # the wide kernel from U 129: W2 rows padded to U + 1, its sum, ...
    u, e, warps = 129, 8, 5
    floats = u * (u + 1) + u * u + b + e * b + 13 * e + 3 * b * u + 4 * e * u + 2 * warps * e
    assert fi.shared_memory_bytes("cf_hesjvp", 20, 129) == 4 * (floats + 4 * e + 4)
    assert fi.fits_shared_memory(20, 148) and not fi.fits_shared_memory(20, 149)
    assert (fi.shared_memory_bytes("cf_vjp", 20, 149) <= fi.SHARED_MEMORY_BYTES
            < fi.shared_memory_bytes("cf_hesjvp", 20, 149))
