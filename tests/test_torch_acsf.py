"""The port's ACSF G2/G4 descriptors (``gcnn_keras_tpu_torch.ops.cuda.acsf``
and ``layers/conv/acsf.py``) against the JAX package, on the CPU.

The plain forward and the closed-form VJP and JVP of each kernel are held
against

- the JAX package's unfused ``ACSFG2``/``ACSFG4`` (forward, ``jax.grad`` of
  ``sum(out * ct)``, and ``jax.jvp``): forward within
  ``1e-5 * (1 + max|ref|)``, VJP and JVP within ``1e-4 * (1 + max|ref|)``;
  both sides compute in float32 and differ in the order of their sums and
  in the closed forms against autodiff;
- the JAX package's fused kernels run in interpret mode, at the JAX tests'
  own tolerances (``2e-5`` forward, ``1e-4`` VJP and JVP);
- torch autograd through the plain forward, and float64 ``gradcheck``/
  ``gradgradcheck`` of the autograd Functions.

The same inputs, made from a numpy seed, go to both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.layers.conv.acsf import ACSFG2 as JACSFG2, ACSFG4 as JACSFG4
from gcnn_keras_tpu.ops.pallas import fused_g4 as jfused
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers.conv import acsf as tacsf
from gcnn_keras_tpu_torch.layers.conv.acsf import (ACSFG2, ACSFG4,
                                                   ACSFConstNormalization)
from gcnn_keras_tpu_torch.ops.cuda import acsf as kacsf

torch.set_num_threads(1)

G2_KW = dict(eta=[0.0, 0.3], rs=[0.0, 3.0], rc=4.0)
G4_KW = dict(eta=[0.0, 0.3], zeta=[1.0, 8.0], lamda=[-1.0, 1.0], rc=4.0,
             multiplicity=2.0)


def _graph(z, pos):
    g = {"node_number": np.asarray(z), "node_coordinates": np.asarray(pos, np.float32)}
    g = jpre.set_range(g, max_distance=4.0, max_neighbours=8)
    g["edge_indices"] = g.pop("range_indices")
    return jpre.set_angle(g, range_indices="edge_indices")


def _mols(seed=3, n_mols=6, elements=(1, 6, 8)):
    rs = np.random.RandomState(seed)
    return [_graph(rs.choice(list(elements), size=n),
                   rs.randn(n, 3) * 1.6)
            for n in rs.randint(5, 10, size=n_mols)]


def _crystals(seed, n_cryst):
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_cryst):
        n = rs.randint(2, 5)
        lat = np.diag(rs.uniform(3.0, 4.0, size=3)) + rs.randn(3, 3) * 0.1
        g = {"node_number": rs.choice([1, 6, 8], size=n),
             "node_coordinates": (rs.rand(n, 3) @ lat).astype(np.float32),
             "graph_lattice": lat.astype(np.float32)}
        g = jpre.set_range_periodic(g, max_distance=3.5, backend="numpy")
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(g)
    return graphs


def _g4_kwargs(elements=(1, 6, 8), keep_pair_order=False, **kw):
    kwargs = JACSFG4.make_param_table(**dict(G4_KW, **kw), elements=list(elements))
    kwargs["keep_pair_order"] = keep_pair_order
    if keep_pair_order:  # ordered pairs take n_el^2 relation slots
        tab = np.asarray(kwargs["eta_zeta_lambda_rc"])
        n = len(elements)
        kwargs["eta_zeta_lambda_rc"] = np.broadcast_to(
            tab[0], (n * n,) + tab.shape[1:]).copy()
    return kwargs


def _jax_layer(layer, jb, with_jvp=False):
    """Forward and VJP (and JVP) of a JAX layer on the batch's own positions."""
    params = layer.init(jax.random.PRNGKey(0), jb)
    pos0 = jb.nodes["node_coordinates"]

    def fwd(p):
        return layer.apply(params, jb, positions=p)

    def vjp(ct):
        return np.asarray(jax.grad(lambda p: jnp.sum(fwd(p) * ct))(pos0))

    def jvp(dpos):
        return np.asarray(jax.jvp(fwd, (pos0,), (jnp.asarray(dpos),))[1])

    return (np.asarray(fwd(pos0)), vjp) + ((jvp,) if with_jvp else ())


def _ct(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tol(out, ref, rel):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() if ref.size else 0.0
    assert err <= rel * (1.0 + np.abs(ref).max()), (err, np.abs(ref).max())


def _inputs(tb):
    pos = tb.nodes["node_coordinates"]
    return pos, tb.nodes["node_number"].to(torch.int32)


def _g4_port(tb, st, ct):
    pos, z = _inputs(tb)
    out = kacsf.g4_forward_plain(pos, z, tb.angles, tb.angle_mask, st)
    dpos = kacsf.g4_vjp_plain(pos, z, tb.angles, tb.angle_mask,
                              torch.from_numpy(ct), st)
    return out, dpos


def _g2_port(tb, st, ct):
    pos, z = _inputs(tb)
    out = kacsf.g2_forward_plain(pos, z, tb.senders, tb.receivers, tb.edge_mask, st)
    dpos = kacsf.g2_vjp_plain(pos, z, tb.senders, tb.receivers, tb.edge_mask,
                              torch.from_numpy(ct), st)
    return out, dpos


def _g4_static(kwargs):
    return kacsf.make_static(kwargs["eta_zeta_lambda_rc"], kwargs["element_mapping"],
                             kwargs["keep_pair_order"], kwargs["multiplicity"])


def _g2_static(kwargs):
    return kacsf.make_static_g2(kwargs["eta_rs_rc"], kwargs["element_mapping"])


def _jvp_port(kind, tb, st, dpos):
    pos, z = _inputs(tb)
    dpos = torch.from_numpy(dpos)
    if kind == "g4":
        return kacsf.g4_jvp_plain(pos, z, tb.angles, tb.angle_mask, dpos, st)
    return kacsf.g2_jvp_plain(pos, z, tb.senders, tb.receivers, tb.edge_mask, dpos, st)


# ------------------------------------------------------------ G4

@pytest.mark.parametrize("elements,keep_pair_order", [
    ((1, 6, 8), False), ((1, 6, 8), True), ((1, 6, 7, 8, 9, 16), False)],
    ids=["unordered", "ordered", "21-pair-relations"])
def test_g4_plain_matches_unfused_jax(elements, keep_pair_order):
    graphs = _mols(elements=elements)
    kwargs = _g4_kwargs(elements, keep_pair_order)
    st = _g4_static(kwargs)
    if len(elements) == 6:
        assert st.num_rel == 21
    ref, ref_vjp = _jax_layer(JACSFG4(**kwargs), jbatch_graphs(graphs))
    ct = _ct(ref.shape)
    out, dpos = _g4_port(batch_graphs(graphs, device="cpu"), st, ct)
    _tol(out, ref, 1e-5)
    _tol(dpos, ref_vjp(ct), 1e-4)


@pytest.mark.parametrize("elements,keep_pair_order", [
    ((1, 6, 8), False), ((1, 6, 8), True), ((1, 6, 7, 8, 9, 16), False)],
    ids=["unordered", "ordered", "21-pair-relations"])
def test_g4_plain_matches_fused_interpret(elements, keep_pair_order):
    graphs = _mols(seed=4, elements=elements)
    jb = jbatch_graphs(graphs)
    # the TPU kernels take R*m <= 128: 21 pair relations get 4 sets, not 8
    kwargs = _g4_kwargs(elements, keep_pair_order,
                        **({"eta": [0.3]} if len(elements) == 6 else {}))
    jst = jfused.make_static(np.asarray(kwargs["eta_zeta_lambda_rc"], np.float32),
                             kwargs["element_mapping"], keep_pair_order, 2.0)
    z = jb.nodes["node_number"].astype(jnp.int32)

    def fused(p):
        return jfused.acsf_g4_fused(p, z, jb.angles, jb.angle_mask, jst, jb.n_node,
                                    jb.max_nodes, interpret=True)

    pos0 = jb.nodes["node_coordinates"]
    ref = np.asarray(fused(pos0))
    ct = _ct(ref.shape, seed=8)
    ref_vjp = np.asarray(jax.grad(lambda p: jnp.sum(fused(p) * ct))(pos0))
    out, dpos = _g4_port(batch_graphs(graphs, device="cpu"), _g4_static(kwargs), ct)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dpos.numpy(), ref_vjp, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["g2", "g4"])
def test_plain_vjp_matches_autograd(kind):
    tb = batch_graphs(_mols(seed=5), device="cpu")
    pos, z = _inputs(tb)
    pos = pos.double().requires_grad_(True)
    if kind == "g4":
        st = _g4_static(_g4_kwargs())
        out = kacsf.g4_forward_plain(pos, z, tb.angles, tb.angle_mask, st)
    else:
        st = _g2_static(JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8]))
        out = kacsf.g2_forward_plain(pos, z, tb.senders, tb.receivers,
                                     tb.edge_mask, st)
    ct = torch.from_numpy(_ct(out.shape, seed=9)).double()
    (auto,) = torch.autograd.grad((out * ct).sum(), pos)
    if kind == "g4":
        closed = kacsf.g4_vjp_plain(pos.detach(), z, tb.angles, tb.angle_mask, ct, st)
    else:
        closed = kacsf.g2_vjp_plain(pos.detach(), z, tb.senders, tb.receivers,
                                    tb.edge_mask, ct, st)
    torch.testing.assert_close(closed, auto, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("elements,keep_pair_order", [
    ((1, 6, 8), False), ((1, 6, 8), True), ((1, 6, 7, 8, 9, 16), False)],
    ids=["unordered", "ordered", "21-pair-relations"])
def test_g4_jvp_plain_matches_jax(elements, keep_pair_order):
    """Against ``jax.jvp`` of the unfused layer and the JVP kernel
    ``_g4_jvp`` in interpret mode."""
    graphs = _mols(seed=17, elements=elements)
    jb = jbatch_graphs(graphs)
    # the TPU kernels take R*m <= 128: 21 pair relations get 4 sets, not 8
    kwargs = _g4_kwargs(elements, keep_pair_order,
                        **({"eta": [0.3]} if len(elements) == 6 else {}))
    st = _g4_static(kwargs)
    dpos = _ct((jb.n_node, 3), seed=18)
    out = _jvp_port("g4", batch_graphs(graphs, device="cpu"), st, dpos)
    _, _, ref_jvp = _jax_layer(JACSFG4(**kwargs), jb, with_jvp=True)
    _tol(out, ref_jvp(dpos), 1e-4)
    jst = jfused.make_static(np.asarray(kwargs["eta_zeta_lambda_rc"], np.float32),
                             kwargs["element_mapping"], keep_pair_order, 2.0)
    ref = jfused._g4_jvp(jb.nodes["node_coordinates"],
                         jb.nodes["node_number"].astype(jnp.int32), jb.angles,
                         jb.angle_mask, jnp.asarray(dpos), jst, jb.n_node, jb.max_nodes,
                         st.num_rel * len(st.eta_inv), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_g2_jvp_plain_matches_jax():
    """Against ``jax.jvp`` of the unfused layer and the JVP kernel
    ``_g2_jvp`` in interpret mode."""
    graphs = _mols(seed=21)
    jb = jbatch_graphs(graphs)
    kwargs = JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8])
    st = _g2_static(kwargs)
    dpos = _ct((jb.n_node, 3), seed=22)
    out = _jvp_port("g2", batch_graphs(graphs, device="cpu"), st, dpos)
    _, _, ref_jvp = _jax_layer(JACSFG2(**kwargs), jb, with_jvp=True)
    _tol(out, ref_jvp(dpos), 1e-4)
    jst = jfused.make_static_g2(np.asarray(kwargs["eta_rs_rc"], np.float32),
                                kwargs["element_mapping"])
    ref = jfused._g2_jvp(jb.nodes["node_coordinates"],
                         jb.nodes["node_number"].astype(jnp.int32), jb.senders,
                         jb.receivers, jb.edge_mask, jnp.asarray(dpos), jst, jb.n_node,
                         jb.max_nodes, st.num_rel * len(st.sets), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["g2", "g4"])
def test_plain_jvp_matches_autograd(kind):
    tb = batch_graphs(_mols(seed=23), device="cpu")
    pos, z = _inputs(tb)
    pos = pos.double()
    if kind == "g4":
        st = _g4_static(_g4_kwargs())

        def fwd(p):
            return kacsf.g4_forward_plain(p, z, tb.angles, tb.angle_mask, st)
    else:
        st = _g2_static(JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8]))

        def fwd(p):
            return kacsf.g2_forward_plain(p, z, tb.senders, tb.receivers, tb.edge_mask, st)
    dpos = _ct(tuple(pos.shape), seed=24).astype(np.float64)
    _, auto = torch.autograd.functional.jvp(fwd, (pos,), (torch.from_numpy(dpos),))
    tb64 = tb.replace_nodes(node_coordinates=pos)
    torch.testing.assert_close(_jvp_port(kind, tb64, st, dpos), auto, rtol=1e-9, atol=1e-9)


def _pair(kind, tb):
    """(G*Fn, G*VjpFn, G*JvpFn, index rows, mask, static table, width)."""
    if kind == "g4":
        st = _g4_static(_g4_kwargs())
        return (kacsf.G4Fn, kacsf.G4VjpFn, kacsf.G4JvpFn, (tb.angles,), tb.angle_mask,
                st, st.num_rel * len(st.eta_inv))
    st = _g2_static(JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8]))
    return (kacsf.G2Fn, kacsf.G2VjpFn, kacsf.G2JvpFn, (tb.senders, tb.receivers),
            tb.edge_mask, st, st.num_rel * len(st.sets))


@pytest.mark.parametrize("kind", ["g2", "g4"])
def test_pair_gradcheck_and_gradgradcheck(kind):
    """float64 gradcheck and gradgradcheck of the Functions: the descriptors
    along positions, the force pass along its cotangent (its backward is the
    JVP Function, whose backward is the VJP Function), the JVP Function along
    its tangent, and the force pass taken through G*Fn's own backward."""
    graphs = _mols(seed=25, n_mols=2)
    tb = batch_graphs(graphs, device="cpu",
                      n_node_pad=sum(len(g["node_number"]) for g in graphs) + 1)
    fn, vjp_fn, jvp_fn, rows, mask, st, width = _pair(kind, tb)
    pos = tb.nodes["node_coordinates"].double()
    z = tb.nodes["node_number"].to(torch.int32)
    gen = torch.Generator().manual_seed(26)
    ct = torch.randn(tb.n_node, width, dtype=torch.float64, generator=gen, requires_grad=True)
    dpos = torch.randn(tb.n_node, 3, dtype=torch.float64, generator=gen, requires_grad=True)

    def descriptors(p):
        return fn.apply(p, z, *rows, mask, st)

    def force_pass(c):
        return vjp_fn.apply(c, pos, z, *rows, mask, st)

    def tangent(d):
        return jvp_fn.apply(d, pos, z, *rows, mask, st)

    def force_through_fn(c):
        p = pos.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((descriptors(p) * c).sum(), p, create_graph=True)
        return g

    assert torch.autograd.gradcheck(descriptors, (pos.clone().requires_grad_(True),),
                                    fast_mode=True)
    for f, x in ((force_pass, ct), (tangent, dpos), (force_through_fn, ct)):
        assert torch.autograd.gradcheck(f, (x,), fast_mode=True)
        assert torch.autograd.gradgradcheck(f, (x,), fast_mode=True)


@pytest.mark.parametrize("kind", ["g2", "g4"])
def test_position_hessian_raises_while_parameter_gradients_work(kind):
    """A force loss through the kernel path: its gradient along a weight on
    the descriptors equals the plain path's (autograd through the unfused
    layer), and its derivative along positions raises."""
    tb = batch_graphs(_mols(seed=27, n_mols=3), device="cpu")
    if kind == "g2":
        kwargs = JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8])
        layer, plain = ACSFG2(**kwargs), ACSFG2(**kwargs, fused=False)
    else:
        layer, plain = ACSFG4(**_g4_kwargs()), ACSFG4(**_g4_kwargs(), fused=False)
    w0 = torch.from_numpy(_ct((tb.n_node, layer.out_features), seed=28))
    grads = []
    for lay in (layer, plain):
        w = w0.clone().requires_grad_(True)
        pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
        energy = (torch.tanh(lay(tb, positions=pos)) * w).sum()
        (force,) = torch.autograd.grad(energy, pos, create_graph=True)
        loss = (force ** 2).sum()
        (gw,) = torch.autograd.grad(loss, w, retain_graph=True)
        grads.append(gw)
        if lay is layer:
            with pytest.raises(NotImplementedError, match="hold positions constant"):
                torch.autograd.grad(loss, pos)
        else:  # the plain path has the position Hessian
            assert torch.autograd.grad(loss, pos)[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-5)


def test_g4_collinear_triple_has_zero_cosine_derivative():
    # j and k on either side of the centre: cos = -1 exactly, so
    # 1 + lambda cos = 0 is clamped for lambda = 1
    graphs = [_graph([6, 6, 6], [[0.0, 0, 0], [1.0, 0, 0], [-2.0, 0, 0]])]
    kwargs = _g4_kwargs((6,), eta=[0.3], zeta=[1.0], lamda=[1.0])
    jb = jbatch_graphs(graphs)
    ref, ref_vjp, ref_jvp = _jax_layer(JACSFG4(**kwargs), jb, with_jvp=True)
    ct = np.ones_like(ref)
    tb = batch_graphs(graphs, device="cpu")
    out, dpos = _g4_port(tb, _g4_static(kwargs), ct)
    _tol(out, ref, 1e-5)
    _tol(dpos, ref_vjp(ct), 1e-4)
    tangent = _ct((tb.n_node, 3), seed=29)
    _tol(_jvp_port("g4", tb, _g4_static(kwargs), tangent), ref_jvp(tangent), 1e-4)
    jst = jfused.make_static(np.asarray(kwargs["eta_zeta_lambda_rc"], np.float32),
                             kwargs["element_mapping"], False, 2.0)
    fused_vjp = jax.grad(lambda p: jnp.sum(jfused.acsf_g4_fused(
        p, jb.nodes["node_number"].astype(jnp.int32), jb.angles, jb.angle_mask,
        jst, jb.n_node, jb.max_nodes, interpret=True)))(jb.nodes["node_coordinates"])
    np.testing.assert_allclose(dpos.numpy(), np.asarray(fused_vjp), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["g2", "g4"])
def test_unknown_element_matches_unfused_jax(kind):
    # nitrogen is not among the elements: slot 0 in G2, pair relation 0 in G4
    graphs = _mols(seed=6, elements=(1, 6, 7, 8))
    jb = jbatch_graphs(graphs)
    tb = batch_graphs(graphs, device="cpu")
    if kind == "g2":
        kwargs = JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8])
        ref, ref_vjp, ref_jvp = _jax_layer(JACSFG2(**kwargs), jb, with_jvp=True)
        ct = _ct(ref.shape)
        st = _g2_static(kwargs)
        out, dpos = _g2_port(tb, st, ct)
    else:
        kwargs = _g4_kwargs()
        ref, ref_vjp, ref_jvp = _jax_layer(JACSFG4(**kwargs), jb, with_jvp=True)
        ct = _ct(ref.shape)
        st = _g4_static(kwargs)
        out, dpos = _g4_port(tb, st, ct)
    _tol(out, ref, 1e-5)
    _tol(dpos, ref_vjp(ct), 1e-4)
    tangent = _ct((tb.n_node, 3), seed=30)
    _tol(_jvp_port(kind, tb, st, tangent), ref_jvp(tangent), 1e-4)


# ------------------------------------------------------------ G2

def test_g2_plain_matches_unfused_jax_and_fused_interpret():
    graphs = _mols(seed=10)
    jb = jbatch_graphs(graphs)
    kwargs = JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8])
    ref, ref_vjp = _jax_layer(JACSFG2(**kwargs), jb)
    ct = _ct(ref.shape)
    out, dpos = _g2_port(batch_graphs(graphs, device="cpu"), _g2_static(kwargs), ct)
    _tol(out, ref, 1e-5)
    _tol(dpos, ref_vjp(ct), 1e-4)

    jst = jfused.make_static_g2(np.asarray(kwargs["eta_rs_rc"], np.float32),
                                kwargs["element_mapping"])
    z = jb.nodes["node_number"].astype(jnp.int32)

    def fused(p):
        return jfused.acsf_g2_fused(p, z, jb.senders, jb.receivers, jb.edge_mask,
                                    jst, jb.n_node, jb.max_nodes, interpret=True)

    pos0 = jb.nodes["node_coordinates"]
    np.testing.assert_allclose(out.numpy(), np.asarray(fused(pos0)), rtol=2e-5, atol=2e-5)
    fused_vjp = jax.grad(lambda p: jnp.sum(fused(p) * ct))(pos0)
    np.testing.assert_allclose(dpos.numpy(), np.asarray(fused_vjp), rtol=1e-4, atol=1e-4)


def test_g2_periodic_batch_takes_the_plain_path():
    graphs = _crystals(2, 3)
    jb = jbatch_graphs(graphs)
    tb = batch_graphs(graphs, device="cpu")
    kwargs = JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8])
    ref, ref_vjp = _jax_layer(JACSFG2(**kwargs), jb)
    layer = ACSFG2(**kwargs)
    assert "periodic batch (range_image shifts)" in layer.kernel_reasons(tb)
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    out = layer(tb, positions=pos)
    _tol(out, ref, 1e-5)
    ct = _ct(ref.shape)
    (dpos,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), pos)
    _tol(dpos, ref_vjp(ct), 1e-4)


def test_g2_layout_cases_match_unfused_jax():
    """``chip_smoke.acsf_g2_edge_graphs`` at the G2 kernels' block range and
    window (``kG2Range`` and ``kVjpWindow``, read from ``csrc/acsf.cu``),
    batched as ``chip_smoke.acsf_g2_edge_batch`` batches them: it holds a
    receiver whose edges span three block ranges, receivers without edges
    inside a range and after the last edge, and an edge whose ends lie
    further apart in id than the window; the plain G2 versions match the
    unfused JAX layer on it."""
    import re
    from pathlib import Path
    import chip_smoke
    src = (Path(kacsf.__file__).parents[2] / "csrc" / "acsf.cu").read_text()
    g2_range, window = (int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                        for k in ("kG2Range", "kVjpWindow"))
    graphs = chip_smoke.acsf_g2_edge_graphs(g2_range, window)
    n_edge = sum(len(g["edge_indices"]) for g in graphs)
    tb = batch_graphs(graphs, device="cpu", n_edge_pad=n_edge)
    recv, send = tb.receivers.numpy(), tb.senders.numpy()
    assert tb.edge_mask.all() and np.all(np.diff(recv) >= 0)
    first = np.searchsorted(recv, np.argmax(np.bincount(recv)))
    assert first % g2_range and np.bincount(recv).max() >= 3 * g2_range
    assert np.diff(recv).max() > 1 and recv[-1] < tb.n_node - 1
    assert np.abs(recv - send).max() >= window
    kwargs = JACSFG2.make_param_table(**G2_KW, elements=chip_smoke.HDNNP_ELEMENTS)
    ref, ref_vjp = _jax_layer(JACSFG2(**kwargs), jbatch_graphs(graphs, n_edge_pad=n_edge))
    ct = _ct(ref.shape, seed=12)
    out, dpos = _g2_port(tb, _g2_static(kwargs), ct)
    _tol(out, ref, 1e-5)
    _tol(dpos, ref_vjp(ct), 1e-4)


# ------------------------------------------------------------ layers

def _per_target(table):
    """A per-target (R, R, m, k) table whose rows differ by target."""
    r = table.shape[0]
    return np.stack([table * (1.0 + 0.1 * t) for t in range(r)])


@pytest.mark.parametrize("case", ["g2-grid", "g2-per-target", "g4-grid",
                                  "g4-per-target", "g4-general", "g4-pair-mapping"])
def test_layer_plain_path_matches_unfused_jax(case):
    graphs = _mols(seed=11)
    jb = jbatch_graphs(graphs)
    tb = batch_graphs(graphs, device="cpu")
    if case.startswith("g2"):
        kwargs = JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8])
        if case == "g2-per-target":
            kwargs["eta_rs_rc"] = _per_target(kwargs["eta_rs_rc"])
        jlayer, layer = JACSFG2(**kwargs), ACSFG2(**kwargs, fused=False)
    else:
        kwargs = _g4_kwargs()
        if case == "g4-per-target":
            kwargs["eta_zeta_lambda_rc"] = _per_target(kwargs["eta_zeta_lambda_rc"])
        if case == "g4-general":  # the JAX layer's per-set branch
            kwargs = _g4_kwargs(eta=[0.1], zeta=[2.0], lamda=[1.0])
        if case == "g4-pair-mapping":  # the port's per-set branch
            kwargs["element_pair_mapping"] = np.array(
                [[1, 1], [1, 6], [1, 8], [6, 6], [6, 8], [8, 8]])[::-1].copy()
        jlayer, layer = JACSFG4(**kwargs), ACSFG4(**kwargs, fused=False)
    ref, ref_vjp = _jax_layer(jlayer, jb)
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    out = layer(tb, positions=pos)
    _tol(out, ref, 1e-5)
    ct = _ct(ref.shape)
    (dpos,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), pos)
    _tol(dpos, ref_vjp(ct), 1e-4)


@pytest.mark.parametrize("kind", ["g2", "g4"])
def test_layer_default_runs_the_kernel_functions(kind):
    """fused=None on the CPU goes through G2Fn/G4Fn (their plain versions)
    and launches no kernel; fused=False gives the same numbers."""
    tb = batch_graphs(_mols(seed=12), device="cpu")
    if kind == "g2":
        kwargs = JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8])
        layer, plain = ACSFG2(**kwargs), ACSFG2(**kwargs, fused=False)
    else:
        kwargs = _g4_kwargs()
        layer, plain = ACSFG4(**kwargs), ACSFG4(**kwargs, fused=False)
    assert layer.kernel_reasons(tb) == []
    before = dict(kacsf.launches)
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    out = layer(tb, positions=pos)
    assert out.grad_fn.name().endswith(("G2FnBackward", "G4FnBackward"))
    (dpos,) = torch.autograd.grad(out.sum(), pos)
    pos2 = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    ref = plain(tb, positions=pos2)
    (ref_dpos,) = torch.autograd.grad(ref.sum(), pos2)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dpos, ref_dpos, rtol=1e-4, atol=1e-4)
    assert kacsf.launches == before


@pytest.mark.parametrize("kind", ["g2", "g4"])
def test_padding_leaves_real_descriptors_unchanged(kind):
    graphs = _mols(seed=13, n_mols=3)
    b1 = batch_graphs(graphs, device="cpu")
    b2 = batch_graphs(graphs, device="cpu", n_node_pad=b1.n_node + 64,
                      n_edge_pad=b1.n_edge + 256,
                      n_angle_pad=b1.angles.shape[0] + 1024)
    if kind == "g2":
        layer = ACSFG2(**JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8]))
    else:
        layer = ACSFG4(**_g4_kwargs())
    outs, grads = [], []
    for b in (b1, b2):
        pos = b.nodes["node_coordinates"].clone().requires_grad_(True)
        out = layer(b, positions=pos)
        (g,) = torch.autograd.grad(out.sum(), pos)
        mask = b.node_mask
        outs.append(out[mask])
        grads.append(g[mask])
        assert not out[~mask].any() and not g[~mask].any()
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-6)


def test_fused_true_raises_with_reasons():
    tb = batch_graphs(_mols(seed=14), device="cpu")
    kw2 = JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8])
    kw4 = _g4_kwargs()
    cases = [
        (ACSFG4(**dict(kw4, element_mapping=np.array([8, 1, 6])), fused=True),
         "unsorted element_mapping"),
        (ACSFG4(**dict(kw4, eta_zeta_lambda_rc=_per_target(kw4["eta_zeta_lambda_rc"])),
                fused=True), "per-target parameter table"),
        (ACSFG4(**dict(kw4, element_pair_mapping=np.array(
            [[1, 1], [1, 6], [1, 8], [6, 6], [6, 8], [8, 8]])), fused=True),
         "custom element_pair_mapping"),
        (ACSFG2(**dict(kw2, eta_rs_rc=_per_target(kw2["eta_rs_rc"])), fused=True),
         "per-target parameter table"),
    ]
    many = JACSFG2.make_param_table(eta=[0.1 * i for i in range(9)], rs=[0.0, 1.0, 2.0, 3.0],
                                    rc=4.0, elements=[1, 6, 8])
    cases.append((ACSFG2(**many, fused=True), "m=36 > 32 sets"))
    for layer, reason in cases:
        with pytest.raises(ValueError, match=reason):
            layer(tb)
    with pytest.raises(ValueError, match="periodic batch"):
        ACSFG2(**kw2, fused=True)(batch_graphs(_crystals(3, 2), device="cpu"))


def test_uncovered_configuration_on_the_card_raises():
    """fused=None never falls back to plain operations on a CUDA tensor."""
    with pytest.raises(NotImplementedError, match="per-target parameter table"):
        tacsf._dispatch("ACSFG4", None, ["per-target parameter table"],
                        torch.device("cuda"))
    assert tacsf._dispatch("ACSFG4", None, [], torch.device("cuda"))
    assert not tacsf._dispatch("ACSFG4", False, [], torch.device("cuda"))
    assert not tacsf._dispatch("ACSFG4", None, ["x"], torch.device("cpu"))


@pytest.mark.parametrize("kind", ["g2", "g4"])
def test_vjp_double_backward_raises(kind):
    """The second derivative along positions through the kernel Functions
    (a position Hessian) raises: positions are a constant of the pair."""
    tb = batch_graphs(_mols(seed=15, n_mols=2), device="cpu")
    if kind == "g2":
        layer = ACSFG2(**JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8]))
    else:
        layer = ACSFG4(**_g4_kwargs())
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(layer(tb, positions=pos).sum(), pos, create_graph=True)
    with pytest.raises(NotImplementedError, match="position Hessian"):
        torch.autograd.grad((g * g).sum(), pos)


def test_wrappers_check_shapes():
    tb = batch_graphs(_mols(seed=16, n_mols=2), device="cpu")
    pos, z = _inputs(tb)
    st4 = _g4_static(_g4_kwargs())
    st2 = _g2_static(JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 8]))
    with pytest.raises(ValueError, match="ct must be"):
        kacsf.g4_vjp(pos, z, tb.angles, tb.angle_mask, torch.zeros(tb.n_node, 5), st4)
    with pytest.raises(ValueError, match="index rows"):
        kacsf.g4_forward(pos, z, tb.angles[:, :2], tb.angle_mask, st4)
    with pytest.raises(ValueError, match="index rows"):
        kacsf.g2_forward(pos, z, tb.senders[1:], tb.receivers, tb.edge_mask, st2)
    with pytest.raises(ValueError, match="mask"):
        kacsf.g2_forward(pos, z, tb.senders, tb.receivers, tb.edge_mask[1:], st2)
    ct = torch.zeros(tb.n_node, st2.num_rel * len(st2.sets))
    assert kacsf.g2_vjp(pos, z, tb.senders, tb.receivers, tb.edge_mask, ct, st2).shape == pos.shape
    with pytest.raises(ValueError, match="dpos must be"):
        kacsf.g4_jvp(pos, z, tb.angles, tb.angle_mask, torch.zeros(tb.n_node, 2), st4)
    assert kacsf.g2_jvp(pos, z, tb.senders, tb.receivers, tb.edge_mask,
                        torch.zeros_like(pos), st2).shape == ct.shape


def test_const_normalization():
    x = torch.arange(6.0).reshape(2, 3)
    out = ACSFConstNormalization(std=[1.0, 2.0, 4.0], mean=1.0)(x)
    torch.testing.assert_close(out, (x - 1.0) / torch.tensor([1.0, 2.0, 4.0]))


def test_static_tables_match_the_jax_package():
    kw4 = _g4_kwargs((1, 6, 7, 8, 9))
    st = _g4_static(kw4)
    jst = jfused.make_static(np.asarray(kw4["eta_zeta_lambda_rc"], np.float32),
                             kw4["element_mapping"], False, 2.0)
    assert tuple(st) == tuple(jst)
    kw2 = JACSFG2.make_param_table(**G2_KW, elements=[1, 6, 7, 8, 9])
    assert tuple(_g2_static(kw2)) == tuple(jfused.make_static_g2(
        np.asarray(kw2["eta_rs_rc"], np.float32), kw2["element_mapping"]))
    assert kacsf.g4_kernel_limits(st) == [] and st.num_rel * len(st.eta_inv) == 120
