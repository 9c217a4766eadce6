"""The port's reverse-over-forward force step against the JAX package's and
against its own reverse-over-reverse step, on the CPU.

``gcnn_keras_tpu_torch.training.fast_force_step`` is held against
``gcnn_keras_tpu.training.fast_force_step.energy_force_value_and_grad``
(jitted) on shared weights, and against the port's plain step
(``EnergyForceModel.apply(create_graph=True)`` and ``torch.autograd.grad``)
on the same model: SchNet (unfused and ``fused_aggregate=True``), PAiNN,
HDNNP2nd and HDNNP4th (dense; ``solver="iterative"`` and ``dense_impl="lu"``
with trainable Qeq tables, the latter against the port's plain step), with ``mae`` and ``mse`` losses, with and without an
``aux_loss_fn``. The port's weights come from a seeded generator and go to
JAX as a flax tree (``utils/convert.py``'s leaf map, the inverse of
``params_from_jax``).

Tolerances:
- the port's fast step against its reverse-over-reverse step:
  ``tests/test_fast_force_step.py``'s, the loss ``rtol 1e-6`` and the
  gradients ``rtol 2e-5, atol 1e-7``, flattened, with the model and batch
  in float64 (a re-association of the chain rule: float64 leaves only
  rounding); in float32, where PAiNN's gradients carry rounding noise of a
  few 1e-5 of a tensor's largest entry in either package
  (``chip_smoke.TRAIN_PATHS["painn_train"]``), each gradient within
  ``1e-4`` of its tensor's largest entry;
- against JAX: each model's existing port-test tolerance, the loss and
  metrics ``rtol 1e-5`` and each gradient within ``1e-4`` of its tensor's
  largest entry (``tests/test_torch_training.py``); the iterative Qeq
  ``chip_smoke.CG_LOSS_RTOL`` and ``CG_GRAD_TOL`` (5e-5, 5e-4), the CG's
  own stopping tolerance in either package.

Then each kernel Function's ``jvp`` against forward-mode AD of its plain
version and its reverse over forward against reverse over reverse, in
float64; the three reverse-only routes raising in both packages; the
train step descending; SchNet ``remat``; and ``chip_smoke.py`` phase 26
on the CPU with counted wrappers.
"""
import copy
import functools

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

import chip_smoke
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.models import hdnnp2nd as jhdnnp2nd
from gcnn_keras_tpu.models import hdnnp4th as jhdnnp4th
from gcnn_keras_tpu.models import painn as jpainn
from gcnn_keras_tpu.models.schnet import make_model as jschnet
from gcnn_keras_tpu.ops.pallas import fused_cfconv as jfc
from gcnn_keras_tpu.ops.pallas import fused_interaction as jfi
from gcnn_keras_tpu.ops.pallas.fused_aggregate import fused_gather_mul_segsum
from gcnn_keras_tpu.training.fast_force_step import (
    energy_force_value_and_grad as jax_value_and_grad)
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers.conv import qeq_solver as qs
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import hdnnp2nd, hdnnp4th, painn, schnet
from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
from gcnn_keras_tpu_torch.ops.cuda import bilinear as kb
from gcnn_keras_tpu_torch.ops.cuda import fused_aggregate as fa
from gcnn_keras_tpu_torch.ops.cuda import fused_cfconv as fc
from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
from gcnn_keras_tpu_torch.training import losses
from gcnn_keras_tpu_torch.training.fast_force_step import (energy_force_value_and_grad,
                                                           make_force_train_step)
from gcnn_keras_tpu_torch.utils import convert
from tests.test_fused_interaction import _case

torch.set_num_threads(1)

STEP_RTOL, STEP_ATOL, STEP_LOSS_RTOL = 2e-5, 1e-7, 1e-6
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
WEIGHTS = (1.0, 37.0)  # energy, force: tests/test_fast_force_step.py's
# the JAX steps compile without XLA's slow backend passes: the same
# function, a third of the compile time
QUICK_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

_MLP = {"units": [16, 16, 1], "num_relations": 10, "activation": ["swish", "swish", "linear"]}
_ACSF = {k: chip_smoke.HDNNP2ND_KW[k] for k in ("g2_kwargs", "g4_kwargs")}
_SCHNET = dict(depth=2, interaction_args={"units": 32}, gauss_args={"bins": 8, "distance_max": 4.0},
               input_embedding={"node": {"input_dim": 95, "output_dim": 16}},
               last_mlp={"units": [32, 16]}, output_mlp={"units": [16, 1]})
_HDNNP4TH = dict(_ACSF, mlp_charge_kwargs=_MLP, mlp_local_kwargs=_MLP)
# name: (JAX make_model, port make_model, kwargs, with ESP and charges)
MODELS = {
    "schnet": (jschnet, schnet.make_model, _SCHNET, False),
    "schnet_fused": (jschnet, schnet.make_model,
                     dict(_SCHNET, interaction_args={"units": 32, "fused_aggregate": True}), False),
    "painn": (jpainn.make_model, painn.make_model,
              dict(depth=2, conv_args={"units": 32, "cutoff": 5.0}, update_args={"units": 32},
                   input_embedding={"node": {"output_dim": 32}},
                   bessel_basis={"num_radial": 8, "cutoff": 5.0},
                   output_mlp={"units": [32, 1], "activation": ["swish", "linear"]}), False),
    "hdnnp2nd": (jhdnnp2nd.make_model_behler, hdnnp2nd.make_model_behler,
                 dict(_ACSF, mlp_kwargs=_MLP), True),
    "hdnnp4th": (jhdnnp4th.make_model_behler, hdnnp4th.make_model_behler, _HDNNP4TH, True),
    "hdnnp4th_iterative": (jhdnnp4th.make_model_behler, hdnnp4th.make_model_behler,
                           dict(_HDNNP4TH, electrostatic_kwargs={"solver": "iterative",
                                                                 "param_trainable": True}),
                           True),
    # the bordered system through LinearSolve (torch.linalg.solve's own
    # reverse over forward is wrong along trainable tables)
    "hdnnp4th_lu": (jhdnnp4th.make_model_behler, hdnnp4th.make_model_behler,
                    dict(_HDNNP4TH, electrostatic_kwargs={"dense_impl": "lu",
                                                          "param_trainable": True}), True),
}
# the JAX comparisons, one jitted step a model: (model, loss kind, with an
# auxiliary loss); the port's two steps are held together on every kind
JAX_CASES = [("schnet", "mae", False), ("schnet_fused", "mse", True), ("painn", "mse", False),
             ("hdnnp2nd", "mae", True), ("hdnnp4th", "mse", True),
             ("hdnnp4th_iterative", "mae", False)]


def _aux(xp):
    """An auxiliary loss on the per-graph energies (masked already)."""
    return lambda e, batch: 0.3 * xp.sum(e * e)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The port model (seeded weights), the same weights as a flax tree, the
    JAX model, and the port and JAX batches of 5 molecules."""
    jmake, make, kw, esp = MODELS[name]
    model = make(device="cpu", generator=torch.Generator().manual_seed(3), **kw)
    tree = {}
    for key, p, transposed in convert._flax_leaves(model):
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        value = p.detach().numpy()
        node[leaf] = jnp.asarray(value.T if transposed else value)
    graphs = chip_smoke.labelled_mols(7, 5, with_esp=esp)
    keys = ("energy", "total_charge") if esp else ("energy",)
    return (model, {"params": tree}, jmake(**kw), batch_graphs(graphs, global_keys=keys,
                                                               device="cpu"),
            jbatch_graphs(graphs, global_keys=keys))


def _jax_grads(model, jgrads):
    """The JAX gradients in the order of ``model.parameters()``."""
    flat = convert._flatten(jgrads["params"])
    by_id = {id(p): (flat[key].T if transposed else flat[key])
             for key, p, transposed in convert._flax_leaves(model)}
    return [by_id[id(p)] for p in model.parameters()]


def _reverse_over_reverse(model, batch, kind, aux):
    """The port's plain step: the forces with ``create_graph``, then the
    loss's gradients."""
    out = EnergyForceModel(model, device="cpu").apply(batch, create_graph=True)
    e_loss = (losses.masked_graph_mae if kind == "mae" else losses.masked_graph_mse)(
        out["energy"], batch.globals["energy"], batch.globals["graph_mask"])
    loss = WEIGHTS[0] * e_loss + WEIGHTS[1] * losses.force_loss(
        out["force"], batch.nodes["force"], batch.node_mask, kind)
    if aux:
        e = out["energy"] * batch.globals["graph_mask"][:, None]
        loss = loss + _aux(torch)(e, batch)
    return loss, torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)


def _close_per_tensor(model, grads, refs, tol):
    for (pname, _), g, ref in zip(model.named_parameters(), grads, refs):
        g, ref = np.asarray(g), np.asarray(ref)
        err = np.abs(g - ref).max()
        assert err <= tol * np.abs(ref).max(), (pname, err, np.abs(ref).max())


def _vag(model, kind, aux):
    return energy_force_value_and_grad(model, energy_weight=WEIGHTS[0],
                                       force_weight=WEIGHTS[1], energy_loss_kind=kind,
                                       force_loss_kind=kind,
                                       aux_loss_fn=_aux(torch) if aux else None)


# the port's two steps on every model, kind and auxiliary loss; the
# iterative Qeq (a CG solve of a few dozen eager rounds each) on two
STEP_CASES = [(name, kind, aux) for name in MODELS for kind in ("mae", "mse")
              for aux in (False, True)
              if not (name.endswith("iterative") and (kind == "mae") == aux)]


@pytest.mark.parametrize("name,kind,aux", STEP_CASES)
def test_fast_step_matches_reverse_over_reverse(name, kind, aux):
    """The port's fast step against its reverse-over-reverse step on the
    same model and batch: in float32 each gradient within ``GRAD_TOL`` of
    its tensor's largest entry; in float64 the JAX test's tolerances."""
    model, _, _, tb, _ = _setup(name)
    (loss, metrics), grads = _vag(model, kind, aux)(tb)
    assert len(grads) == len(list(model.parameters())) > 0
    assert set(metrics) == {"energy_loss", "force_loss"} | ({"aux_loss"} if aux else set())
    ref_loss, ref_grads = _reverse_over_reverse(model, tb, kind, aux)
    np.testing.assert_allclose(loss.item(), ref_loss.item(), rtol=STEP_LOSS_RTOL)
    _close_per_tensor(model, grads, ref_grads, GRAD_TOL)
    model64 = copy.deepcopy(model).double()
    tb64 = tb._map(lambda v: v.double() if v.is_floating_point() else v)
    (loss64, _), grads64 = _vag(model64, kind, aux)(tb64)
    ref_loss64, ref_grads64 = _reverse_over_reverse(model64, tb64, kind, aux)
    np.testing.assert_allclose(loss64.item(), ref_loss64.item(), rtol=STEP_LOSS_RTOL)
    flat = lambda gs: np.concatenate([g.detach().numpy().ravel() for g in gs])  # noqa: E731
    np.testing.assert_allclose(flat(grads64), flat(ref_grads64), rtol=STEP_RTOL,
                               atol=STEP_ATOL)


@pytest.mark.parametrize("name,kind,aux", JAX_CASES)
def test_fast_step_matches_jax(name, kind, aux):
    """The port's fast step against the JAX package's (jitted) on shared
    weights: the loss, each metric and every gradient."""
    model, params, jmodel, tb, jb = _setup(name)
    (loss, metrics), grads = _vag(model, kind, aux)(tb)
    (jloss, jmetrics), jgrads = jax.jit(jax_value_and_grad(
        jmodel, energy_weight=WEIGHTS[0], force_weight=WEIGHTS[1], energy_loss_kind=kind,
        force_loss_kind=kind, aux_loss_fn=_aux(jnp) if aux else None)).lower(
        params, jb).compile(compiler_options=QUICK_XLA)(params, jb)
    loss_rtol, grad_tol = ((chip_smoke.CG_LOSS_RTOL, chip_smoke.CG_GRAD_TOL)
                           if name.endswith("iterative") else (LOSS_RTOL, GRAD_TOL))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=loss_rtol)
    assert set(metrics) == set(jmetrics)
    for key, value in metrics.items():
        np.testing.assert_allclose(value.item(), float(jmetrics[key]), rtol=loss_rtol)
    _close_per_tensor(model, grads, _jax_grads(model, jax.tree_util.tree_map(np.asarray, jgrads)),
                      grad_tol)


# ------------------------------------------------------ the Functions' jvp

def _rng(seed=0):
    return np.random.RandomState(seed)


def _t64(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _sorted_ids(rs, e, n):
    return torch.from_numpy(np.sort(rs.randint(0, n, e)).astype(np.int32))


def _gms_inputs(rs, n=7, e=19):
    send = torch.from_numpy(rs.randint(0, n, e).astype(np.int32))
    recv = _sorted_ids(rs, e, n)
    perm = torch.from_numpy(np.argsort(send.numpy(), kind="stable").astype(np.int32))
    return send, recv, perm


def _acsf(kind):
    """A small HDNNP batch and its ACSF layer's static table."""
    model = hdnnp2nd.make_model_behler(device="cpu", **_ACSF, mlp_kwargs=_MLP)
    b = batch_graphs(chip_smoke.labelled_mols(3, 2, with_esp=True), device="cpu")
    (pos, *rest), _ = chip_smoke.acsf_args(f"{kind}_fwd", b)
    return pos.double(), rest, getattr(model, f"acsf_{kind}")._static


def _cg_system(rs, g=2, m=5):
    pos = _t64(rs.randn(g, m, 3) * 1.5)
    sigma = _t64(0.5 + rs.rand(g, m))
    diag = _t64(2.0 + rs.rand(g, m))
    mask = torch.from_numpy(np.arange(m)[None, :] < np.array([[m], [m - 2]]))
    return pos, sigma, diag, mask


def _dense_erf_solve(b, pos, sigma, diag, mask):
    """``A^-1 b`` with A the CG's erf-kernel matrix built densely."""
    m = mask.shape[1]
    eye = torch.eye(m, dtype=b.dtype)[None].expand(b.shape[0], m, m)
    a = qs._erf_kernel_matvec(pos, sigma, diag, mask, block=4)(eye)
    return torch.linalg.solve(a, b)


def _jvp_cases():
    """name -> (Function, plain version, primals, tangents, expected wrapper
    calls of the dual evaluation: the primal's and the tangent's)."""
    rs = _rng(1)
    vals, ids = _t64(rs.randn(19, 2, 3)), _sorted_ids(rs, 19, 6)
    send, recv, perm = _gms_inputs(rs)
    inv = kb.invert_perm(perm)
    x, m = _t64(rs.randn(7, 3)), _t64(rs.randn(19, 3))
    gms = lambda x, m: kb.gms(x, m, send, recv, perm)  # noqa: E731
    gms_plain = lambda x, m: fa.fused_gather_mul_segsum_plain(x, m, send, recv, 7)  # noqa: E731
    half = _t64(rs.randn(3, 4, 4))
    a = half @ half.transpose(1, 2) + 4.0 * torch.eye(4, dtype=torch.float64)
    da = _t64(rs.randn(3, 4, 4))
    pos, sigma, diag, mask = _cg_system(rs)
    b = _t64(rs.randn(2, 5, 2))
    cg = lambda b, p, s, d: qs._CGSolve.apply(b, p, s, d, mask, 4, 1e-13, 200)  # noqa: E731
    cases = {
        "segment_sum": (lambda v: ss.SortedSegmentSum.apply(v, ids, 6),
                        lambda v: ss.segment_sum_plain(v.reshape(19, -1), ids, 6).reshape(6, 2, 3),
                        [vals], [_t64(rs.randn(19, 2, 3))], {"sorted_segment_sum": 2}),
        "gather": (lambda v: fa.gather_with_sorted_transpose(v, send, perm),
                   lambda v: v.index_select(0, send), [x], [_t64(rs.randn(7, 3))], {}),
        "permute": (lambda v: kb.PermuteRows.apply(v, perm, inv),
                    lambda v: v.index_select(0, perm), [m], [_t64(rs.randn(19, 3))], {}),
        "gms_x": (gms, gms_plain, [x, m], [_t64(rs.randn(7, 3)), None],
                  {"gather_mul_segsum": 2}),
        "gms_m": (gms, gms_plain, [x, m], [None, _t64(rs.randn(19, 3))],
                  {"gather_mul_segsum": 2}),
        "gms_both": (gms, gms_plain, [x, m], [_t64(rs.randn(7, 3)), _t64(rs.randn(19, 3))],
                     {"gather_mul_segsum": 3}),
        "spd_solve": (ks.SPDSolve.apply, ks.spd_solve_plain, [a, _t64(rs.randn(3, 4, 2))],
                      [da + da.transpose(1, 2), _t64(rs.randn(3, 4, 2))], {"spd_solve": 2}),
        "cg_solve": (cg, lambda b, p, s, d: _dense_erf_solve(b, p, s, d, mask),
                     [b, pos, sigma, diag],
                     [_t64(rs.randn(2, 5, 2)), _t64(rs.randn(2, 5, 3)), _t64(rs.randn(2, 5)),
                      _t64(rs.randn(2, 5))], {}),
    }
    for kind in ("g4", "g2"):
        p0, rest, st = _acsf(kind)
        width = st.num_rel * (len(st.eta_inv) if kind == "g4" else len(st.sets))
        fn, vjp, jvp = (getattr(ka, f"{kind.upper()}{s}Fn") for s in ("", "Vjp", "Jvp"))
        plain = getattr(ka, f"{kind}_forward_plain")
        vjp_plain, jvp_plain = (getattr(ka, f"{kind}_{d}_plain") for d in ("vjp", "jvp"))
        n = p0.shape[0]
        cases[kind] = (lambda p, fn=fn, rest=rest, st=st: fn.apply(p, *rest, st),
                       lambda p, plain=plain, rest=rest, st=st: plain(p, *rest, st),
                       [p0], [_t64(rs.randn(n, 3))], {f"{kind}_fwd": 1, f"{kind}_jvp": 1})
        cases[f"{kind}_vjp"] = (
            lambda c, f=vjp, p0=p0, rest=rest, st=st: f.apply(c, p0, *rest, st),
            lambda c, f=vjp_plain, p0=p0, rest=rest, st=st: f(p0, *rest, c, st),
            [_t64(rs.randn(n, width))], [_t64(rs.randn(n, width))], {f"{kind}_vjp": 2})
        cases[f"{kind}_jvp"] = (
            lambda d, f=jvp, p0=p0, rest=rest, st=st: f.apply(d, p0, *rest, st),
            lambda d, f=jvp_plain, p0=p0, rest=rest, st=st: f(p0, *rest, d, st),
            [_t64(rs.randn(n, 3))], [_t64(rs.randn(n, 3))], {f"{kind}_jvp": 2})
    return cases


JVP_CASES = _jvp_cases()


def _tangent(f, primals, tangents):
    with fwAD.dual_level():
        duals = [p if t is None else fwAD.make_dual(p, t) for p, t in zip(primals, tangents)]
        return fwAD.unpack_dual(f(*duals)).tangent


@pytest.mark.parametrize("name", list(JVP_CASES))
def test_function_jvp_matches_forward_ad_of_its_plain_version(name):
    """Each kernel Function's ``jvp`` (the kernel on the tangent; the plain
    version on the CPU) against PyTorch's forward mode through the plain
    version, in float64; the wrapper calls of the dual evaluation are the
    primal's and the tangent's."""
    fn, plain, primals, tangents, expected = JVP_CASES[name]
    with chip_smoke.captured_calls() as calls:
        got = _tangent(fn, primals, tangents)
    assert {k: len(c) for k, c in calls.items() if c} == expected
    ref = _tangent(plain, primals, tangents)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-9,
                               atol=1e-9 * (1.0 + ref.abs().max().item()))


def _surrogate_case(name):
    """``(energy(theta, c), theta, c)``: a scalar through the Function of
    ``name``, with parameters ``theta`` on both sides of it and coordinates
    ``c`` feeding it."""
    rs = _rng(2)
    if name in ("g4", "g2"):
        p0, rest, st = _acsf(name)
        fn = getattr(ka, f"{name.upper()}Fn")
        width = st.num_rel * (len(st.eta_inv) if name == "g4" else len(st.sets))
        theta = [_t64(rs.randn(width)).requires_grad_()]

        def energy(th, c):
            return (th[0] * torch.tanh(fn.apply(c, *rest, st))).sum()
        return energy, theta, p0
    c0 = _t64(rs.randn(7, 3))
    theta = [_t64(rs.randn(3, 3)).requires_grad_(), _t64(rs.randn(3)).requires_grad_()]
    send, recv, perm = _gms_inputs(rs)
    inv = kb.invert_perm(perm)
    half = _t64(rs.randn(7, 7)) / 3.0

    def energy(th, c):
        h = torch.tanh(c @ th[0])                                 # (7, 3)
        if name == "segment_sum":
            out = ss.SortedSegmentSum.apply(h.index_select(0, send) * th[1], recv, 7)
        elif name == "gather":
            out = fa.gather_with_sorted_transpose(h, send, perm) * th[1]
        elif name == "permute":
            out = kb.PermuteRows.apply(h.index_select(0, send), perm, inv) * th[1]
        elif name == "gms":
            out = kb.gms(h, torch.sin(h.index_select(0, recv) * th[1]), send, recv, perm)
        elif name == "spd_solve":
            a = half @ half.t() + torch.diag(2.0 + torch.sigmoid(h.sum(1)))
            out = ks.SPDSolve.apply(a[None], (h * th[1])[None])
        else:  # cg_solve: coordinates and parameters in pos, sigma, diag and b
            sigma = (0.6 + 0.3 * torch.sigmoid(h[:, 0] * th[1][0]))[None]
            diag = (2.0 + torch.sigmoid(h[:, 1] + th[1][1]))[None]
            mask = torch.ones(1, 7, dtype=torch.bool)
            out = qs._CGSolve.apply((h * th[1])[None], c[None], sigma, diag, mask, 4,
                                    1e-13, 200)
        return (torch.tanh(out) * out.new_tensor(np.linspace(0.5, 1.5, out.numel()).reshape(
            out.shape))).sum()
    return energy, theta, c0


@pytest.mark.parametrize("name", ["segment_sum", "gather", "permute", "gms", "spd_solve",
                                  "cg_solve", "g4", "g2"])
def test_reverse_over_forward_matches_reverse_over_reverse(name):
    """d/dtheta <dE/dc, v>, taken reverse over the energy's tangent along
    ``v`` (the reverse pass after the dual level closes), against reverse
    over the gradient along ``c`` with ``create_graph``, in float64."""
    energy, theta, c0 = _surrogate_case(name)
    v = _t64(_rng(5).randn(*c0.shape))
    with fwAD.dual_level():
        de = fwAD.unpack_dual(energy(theta, fwAD.make_dual(c0, v))).tangent
    fwd = torch.autograd.grad(de, theta)
    c = c0.clone().requires_grad_()
    (gc,) = torch.autograd.grad(energy(theta, c), c, create_graph=True)
    rev = torch.autograd.grad((gc * v).sum(), theta)
    for a, b in zip(fwd, rev):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-11)


def test_acsf_pair_refuses_a_tangent_along_positions():
    """The pair holds positions constant in forward mode as in reverse: a
    tangent on its positions raises; ``_PositionsHeldConstant``'s is zero."""
    p0, rest, st = _acsf("g2")
    ct = _t64(_rng(3).randn(p0.shape[0], st.num_rel * len(st.sets)))
    with fwAD.dual_level():
        dual = fwAD.make_dual(p0, torch.ones_like(p0))
        with pytest.raises(NotImplementedError, match="position Hessian"):
            ka.G2VjpFn.apply(ct, dual, *rest, st)
        zero = ka._PositionsHeldConstant.apply(dual)
        assert fwAD.unpack_dual(zero).tangent.item() == 0.0


# -------------------------------------------------- the reverse-only routes

def _reverse_only_routes():
    """route -> (the port's call under forward mode, the JAX call under
    jax.jvp, the word the port's error names)."""
    rs = _rng(4)
    send, recv, perm = _gms_inputs(rs, n=6, e=12)
    x, filt = rs.randn(6, 4).astype(np.float32), rs.randn(12, 4).astype(np.float32)
    sj, rj = jnp.asarray(send.numpy()), jnp.asarray(recv.numpy())
    basis = rs.randn(12, 5).astype(np.float32)
    w1, b1 = rs.randn(5, 4).astype(np.float32), rs.randn(4).astype(np.float32)
    w2, b2 = rs.randn(4, 4).astype(np.float32), rs.randn(4).astype(np.float32)
    chain = _case(3, 40, 120, 8, 8)
    st, cx, cpos, cw1, cb1, cw2, cb2, csend, crecv, cmask = chain
    tchain = [torch.from_numpy(np.asarray(a)) for a in (cx, cpos, cw1, cb1, cw2, cb2)]
    tedges = [torch.from_numpy(np.asarray(a)) for a in (csend, crecv, cmask)]
    return {
        "fused_aggregate": (
            lambda d: fa.FusedGatherMulSegsum.apply(d, torch.from_numpy(filt), send, recv, 6,
                                                    perm),
            lambda: jax.jvp(lambda v: fused_gather_mul_segsum(
                v, jnp.asarray(filt), sj, rj, 6, 6, interpret=True), (jnp.asarray(x),),
                (jnp.ones_like(x),)),
            x),
        "accurate_cfconv": (
            lambda d: fc.FusedCfconv.apply(torch.from_numpy(basis), d, recv,
                                           *map(torch.from_numpy, (w1, b1, w2, b2)), 6),
            lambda: jax.jvp(lambda v: jfc.fused_cfconv(jnp.asarray(basis), v, rj, 6, w1, b1,
                                                       w2, b2),
                            (jnp.asarray(x)[send.numpy()],), (jnp.ones((12, 4)),)),
            x[send.numpy()]),
        "fused_chain": (
            lambda d: fi.cfconv_fused_chain(d, *tchain[1:], *tedges, fi.CFStatic(*st)),
            lambda: jax.jvp(lambda v: jfi.cfconv_fused_chain(
                v, cpos, cw1, cb1, cw2, cb2, csend, crecv, cmask, st, 40, interpret=True),
                (jnp.asarray(cx),), (jnp.ones_like(jnp.asarray(cx)),)),
            np.asarray(cx)),
    }


@pytest.mark.parametrize("route", ["fused_aggregate", "accurate_cfconv", "fused_chain"])
def test_reverse_only_routes_raise_in_forward_mode_in_both_packages(route, monkeypatch):
    """JAX traces the jvp of a ``custom_vjp`` and raises when it evaluates
    the linearized rule; its kernels run in interpret mode, the fused
    cfconv (no interpret switch) through ``_reference_impl``, its own
    off-TPU computation. The port raises ``NotImplementedError`` naming the
    mode."""
    monkeypatch.setattr(jfc, "_fused_cfconv_impl", jfc._reference_impl)
    port, jax_call, primal = _reverse_only_routes()[route]
    with pytest.raises(TypeError, match="custom_vjp"):
        jax_call()
    p = torch.from_numpy(np.asarray(primal))
    with fwAD.dual_level():
        with pytest.raises(NotImplementedError, match=route):
            port(fwAD.make_dual(p, torch.ones_like(p)))


# ---------------------------------------------------- the step and remat

def test_train_step_runs_and_descends():
    """``make_force_train_step``'s counterpart of the JAX test: 12 Adam
    steps at lr 1e-3 on one batch, E + 50 F."""
    tb = _setup("schnet")[3]
    model = schnet.make_model(device="cpu", generator=torch.Generator().manual_seed(3),
                              **_SCHNET)
    step = make_force_train_step(model, functools.partial(torch.optim.Adam, lr=1e-3),
                                 donate=False, energy_weight=1.0, force_weight=50.0)
    state = step.init_state()
    assert [id(p) for p in state.params] == [id(p) for p in model.parameters()]
    losses_seen = []
    for _ in range(12):
        state, loss, metrics = step(state, tb)
        losses_seen.append(loss.item())
    assert state.step == 12
    assert np.isfinite(losses_seen).all() and losses_seen[-1] < losses_seen[0]
    assert "force_loss" in metrics


def test_remat_runs_the_fast_step():
    """SchNet ``remat=True``: the fast step runs (the checkpointed
    interactions run unchecked under forward-mode tangents) and gives the
    gradients of the model without remat on the same weights, and of its
    own reverse-over-reverse step."""
    _, _, _, tb, _ = _setup("schnet")
    grads = {}
    for remat in (False, True):
        model = schnet.make_model(device="cpu", generator=torch.Generator().manual_seed(3),
                                  remat=remat, **_SCHNET)
        (_, _), grads[remat] = energy_force_value_and_grad(model, force_weight=WEIGHTS[1])(tb)
    _, ref = _reverse_over_reverse(model, tb, "mae", False)
    for a, b, r in zip(grads[True], grads[False], ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)


# ------------------------------------------------- phase 26 on the CPU

@pytest.fixture
def counted_kernels(monkeypatch):
    """Each kernel wrapper call counted as the card counts its launches; no
    device syncs."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for kname, (mod, attr, _) in chip_smoke.kernel_wrappers().items():
        def counted(*args, _run=getattr(mod, attr), _mod=mod, _name=kname):
            if isinstance(_mod.launches, dict):
                _mod.launches[_name] += 1
            else:
                _mod.launches += 1
            return _run(*args)
        monkeypatch.setattr(mod, attr, counted)
    return chip_smoke


@pytest.mark.parametrize("name", list(chip_smoke.FAST_PATHS))
def test_chip_smoke_phase_26_path_runs_on_the_cpu(name, counted_kernels):
    """Phase 26 for one path at its full width on 4 molecules (the first
    step on 3): the fast step against the Trainer step, and every step's
    launches (``FAST_PATHS``) of both."""
    cs = counted_kernels
    profiles = []
    paths = cs.phase_fast_step(name, "cpu", profiles, device="cpu", size=4, first=(2, 3),
                               steps=2)
    cfg = cs.FAST_PATHS[name]
    assert paths == {f"{name}_step": {k: 2 * v for k, v in cfg["fast"].items()},
                     f"{name}_trainer": {k: 2 * v for k, v in cfg["trainer"].items()}}
    assert len(profiles) == 2


def test_chip_smoke_phase_26_rules_run_on_the_cpu():
    """Phase 26's jvp checks at small sizes, and the reverse-only modes
    raising naming themselves."""
    recs = chip_smoke.phase_jvp_rules("cpu", sizes={"schnet_train": 3, "hdnnp2nd_train": 3,
                                                    "hdnnp4th_train": 3})
    assert len(recs) == 5
    chip_smoke.phase_reverse_only("cpu", n_mols=3)
