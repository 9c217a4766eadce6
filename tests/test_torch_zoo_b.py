"""The port's second group of the model zoo (DMPNN, CMPNN, NMPN, AttentiveFP,
HamNet, MEGAN), its GRU layers and Set2Set readout, against the JAX package
on the CPU, and against the executed-kgcnn goldens.

As in ``tests/test_torch_zoo.py``: small graphs from a numpy seed, the JAX
``init`` parameters perturbed by seeded noise and carried into the port by
``params_from_jax``; outputs within ``rtol=1e-5``, ``atol=1e-6``, a masked
graph MAE's parameter gradients (a node MAE for node outputs) within
``1e-5`` of each tensor's largest entry. A few tensors' gradients are sums
that cancel: an attention logit's bias, whose gradient is 0 by the
softmax's shift invariance, and in Set2Set's readout a bias below it. There
JAX's own float32 gradient lies further than that from the float64 one
(the port's model in double precision), and the port's is held by the
float64 rules of ``chip_smoke.check_grads``, which the card's first steps
in ``chip_smoke.py`` phase 23 take too (``_grads_close``). The goldens take
the recipes of
``tests/test_reference_parity.py`` and ``tests/test_crystal_parity.py``
(the NMPN depth-0, depth-1 and no-Set2Set fixtures: NMPN's recipe at that
depth without Set2Set) at ``rtol=1e-4``, ``atol=2e-5``.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.layers import aggr as jaggr
from gcnn_keras_tpu.layers.conv import basic as jbasic
from gcnn_keras_tpu.layers.pool import set2set as jset2set
from gcnn_keras_tpu.ops import segment as jsegment
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers import aggr
from gcnn_keras_tpu_torch.layers.conv import basic
from gcnn_keras_tpu_torch.layers.pool import Set2Set
from gcnn_keras_tpu_torch.models import attentivefp, cmpnn, dmpnn, hamnet, megan, nmpn
from gcnn_keras_tpu_torch.ops import segment
from gcnn_keras_tpu_torch.training import losses
from gcnn_keras_tpu_torch.utils.convert import flax_leaf_names, params_from_jax
from tests.test_crystal_parity import _load as _crystal_load, _prepare
from tests.test_reference_parity import _apply_mapping, _load
from tests.test_torch_zoo import _close, _graphs, _perturbed

torch.set_num_threads(1)

GRAD_TOL = 1e-5  # of each gradient tensor's largest entry
GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 2e-5

NODE16 = {"node": {"input_dim": 20, "output_dim": 16}}
EMBED = {**NODE16, "edge": {"input_dim": 5, "output_dim": 8}}
OUT = {"units": [16, 1], "activation": ["relu", "linear"]}


def _grads_close(names, grads, ref, exact=None):
    """Each gradient against JAX's ``ref`` (by the same names) by
    ``chip_smoke.check_grads`` at ``GRAD_TOL``: within it of each tensor's
    largest entry or, with ``exact`` (a function giving the float64
    gradients by name), by its float64 rules."""
    import chip_smoke
    assert sorted(ref) == sorted(names)
    chip_smoke.check_grads(
        "port against JAX", dict(zip(names, grads)),
        {n: torch.as_tensor(np.asarray(r)) for n, r in ref.items()}, GRAD_TOL,
        None if exact is None else lambda: {n: torch.as_tensor(v) for n, v in exact().items()})


def _with_coordinates(graphs, seed):
    rs = np.random.RandomState(seed)
    for g in graphs:
        n = len(g.get("node_number", g.get("node_attributes")))
        g["node_coordinates"] = (rs.randn(n, 3) * 1.5).astype(np.float32)
    return graphs


# --------------------------------------------------------- the GRU layers


def _gru_case(name):
    """(JAX module, port module, arrays): a state of 8 and an input of 6 per
    row; the sequence pool (arrays None) reads 6 features per node of a
    batch."""
    rs = np.random.RandomState(40)
    state, inp = rs.randn(11, 8).astype(np.float32), rs.randn(11, 6).astype(np.float32)
    if name == "KerasGRUCellUpdate":
        return jbasic.KerasGRUCellUpdate(8), basic.KerasGRUCellUpdate(6, 8), (state, inp)
    if name == "GRUUpdate":
        return jbasic.GRUUpdate(8), basic.GRUUpdate(6, 8), (state, inp)
    return jbasic.KerasGRUSequencePooling(8), basic.KerasGRUSequencePooling(6, 8), None


@pytest.mark.parametrize("name", ["KerasGRUCellUpdate", "KerasGRUSequencePooling",
                                  "GRUUpdate"])
def test_gru_matches_jax(name):
    """Output, and the gradients of a weighted sum of it along the
    parameters and the inputs, against JAX on perturbed shared weights."""
    jmod, mod, arrays = _gru_case(name)
    if arrays is None:
        graphs = _graphs(41)
        jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
        arrays = (np.random.RandomState(42).randn(tb.n_node, 6).astype(np.float32),)
        jargs, targs = (jb,), (tb,)
    else:
        jargs, targs = (), ()
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), *jargs,
                                  *map(jnp.asarray, arrays)), 43)
    params_from_jax(mod, params)
    ref = jmod.apply(params, *jargs, *map(jnp.asarray, arrays))
    w = np.random.RandomState(44).randn(*ref.shape).astype(np.float32)

    def jloss(p, *xs):
        return jnp.sum(jmod.apply(p, *jargs, *xs) * w)
    ref_grads = jax.grad(jloss, argnums=tuple(range(1 + len(arrays))))(
        params, *map(jnp.asarray, arrays))
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = mod(*targs, *xs)
    _close(out, ref)
    names, ps = zip(*mod.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), list(ps) + xs)
    ref_named = dict(params_from_jax(_gru_case(name)[1], jax.tree_util.tree_map(
        np.asarray, ref_grads[0])).named_parameters())
    _grads_close(names, grads[:len(names)],
                 {n: p.detach().numpy() for n, p in ref_named.items()})
    for g, r in zip(grads[len(names):], ref_grads[1:]):
        _close(g, r)


def test_gru_leaves_carry_the_flax_layouts():
    """keras's (F, 3U) / (U, 3U) / (2, 3U) leaves as they are, and flax
    ``GRUCell``'s six Denses under ``GRUCell_0``, bias on the input ones and
    ``hn``."""
    assert flax_leaf_names(basic.KerasGRUCellUpdate(6, 8)) == {
        "kernel": "kernel", "recurrent_kernel": "recurrent_kernel", "bias": "bias"}
    leaves = flax_leaf_names(basic.GRUUpdate(6, 8))
    assert sorted(leaves.values()) == sorted(
        [f"GRUCell_0/{d}/kernel" for d in ("ir", "iz", "in", "hr", "hz", "hn")]
        + [f"GRUCell_0/{d}/bias" for d in ("ir", "iz", "in", "hn")])
    assert flax_leaf_names(Set2Set(8)) == {
        "kernel": "kernel", "recurrent_kernel": "recurrent_kernel", "bias": "bias"}
    model = megan.make_model(device="cpu", units=[8], importance_units=[4], final_units=[1],
                             in_features=5)
    heads = [v for v in flax_leaf_names(model).values() if v.startswith("att_0/head_")]
    assert sorted(heads) == sorted(
        f"att_0/head_{k}_{d}/Dense_0/{leaf}" for k in range(2)
        for d, leaf in (("linear", "kernel"), ("linear", "bias"), ("alpha_act", "kernel"),
                        ("alpha_act", "bias"), ("alpha", "kernel")))


# --------------------------------------------------------- Set2Set


@pytest.mark.parametrize("pooling_method,init_qstar", [("mean", "mean"), ("sum", "mean"),
                                                       ("mean", "0"), ("sum", "0")])
def test_set2set_matches_jax(pooling_method, init_qstar):
    graphs = _graphs(45)
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    x = np.random.RandomState(46).randn(tb.n_node, 6).astype(np.float32)
    jmod = jset2set.Set2Set(6, T=2, pooling_method=pooling_method, init_qstar=init_qstar)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jb, jnp.asarray(x)), 47)
    mod = params_from_jax(Set2Set(6, T=2, pooling_method=pooling_method,
                                  init_qstar=init_qstar), params)
    ref = jmod.apply(params, jb, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = mod(tb, xt)
    _close(out, ref)
    w = np.random.RandomState(48).randn(*ref.shape).astype(np.float32)
    pg, xg = jax.grad(lambda p, v: jnp.sum(jmod.apply(p, jb, v) * w), argnums=(0, 1))(
        params, jnp.asarray(x))
    names, ps = zip(*mod.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), list(ps) + [xt],
                                allow_unused=True)
    ref_named = {n: p.detach().numpy() for n, p in params_from_jax(
        Set2Set(6, T=2), jax.tree_util.tree_map(np.asarray, pg)).named_parameters()}
    # the recurrent kernel meets only the zero state: no gradient in either
    assert not np.any(ref_named["recurrent_kernel"])
    ref_named.pop("recurrent_kernel")
    keep = [i for i, n in enumerate(names) if n != "recurrent_kernel"]
    _grads_close([names[i] for i in keep], [grads[i] for i in keep], ref_named)
    assert grads[names.index("recurrent_kernel")] is None
    _close(grads[-1], xg)


def test_set2set_sums_are_unsorted():
    """As in JAX, Set2Set's mean and attention sums take ``index_add_``:
    no sorted segment-sum call."""
    import chip_smoke
    graphs = _graphs(45)
    tb = batch_graphs(graphs, device="cpu")
    with chip_smoke.captured_calls() as calls:
        Set2Set(6)(tb, torch.randn(tb.n_node, 6))
    assert not any(calls.values())


# --------------------------------------------------------- the max pool at ties


def test_segment_max_gradient_splits_among_ties_as_jax():
    """Ties in a segment's max share its gradient evenly in both packages,
    also where the max is 0 (relu messages): the port's reduction starts
    from -inf, so no start value takes a share."""
    d = np.array([[0, 1], [0, 1], [0, 2], [3, 3], [3, 0], [0, 0], [-1, 0]], np.float32)
    ids = np.array([0, 0, 0, 1, 1, 2, 3])
    w = np.random.RandomState(49).randn(5, 2).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(jsegment.segment_max(x, jnp.asarray(ids), 5, True) * w))(
        jnp.asarray(d))
    x = torch.tensor(d, requires_grad=True)
    out = segment.segment_max(x, torch.from_numpy(ids), 5, True)
    _close(out, jsegment.segment_max(jnp.asarray(d), jnp.asarray(ids), 5, True), 0, 0)
    (out * torch.from_numpy(w)).sum().backward()
    _close(x.grad, ref, 1e-6, 0)
    np.testing.assert_allclose(x.grad.numpy()[:3, 0], w[0, 0] / 3, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy()[5], w[2], rtol=1e-6)


@pytest.mark.parametrize("op", ["segment_max", "segment_min"])
def test_segment_max_and_min_take_integers(op):
    """Integer data reduces as in JAX, and an empty segment is 0, as before
    the float start value became the reduction's identity."""
    d = np.array([[3, -1], [5, 2], [-4, 7], [0, 0]], np.int64)
    ids = np.array([0, 0, 1, 3])
    out = getattr(segment, op)(torch.from_numpy(d), torch.from_numpy(ids), 4, True)
    assert out.dtype == torch.int64
    ref = np.asarray(getattr(jsegment, op)(jnp.asarray(d), jnp.asarray(ids), 4, True))
    np.testing.assert_array_equal(out.numpy()[[0, 1, 3]], ref[[0, 1, 3]])
    np.testing.assert_array_equal(out.numpy()[2], [0, 0])


def test_cmpnn_max_pool_gradient_at_ties_matches_jax():
    """CMPNN's relu messages leave many exact zeros, so its max pools meet
    ties; the pool's gradient on those messages is JAX's."""
    graphs = _graphs(50, edge_features=4)
    jb = jbatch_graphs(graphs, compute_reverse_edges=True)
    tb = batch_graphs(graphs, compute_reverse_edges=True, device="cpu")
    msg = np.maximum(np.random.RandomState(51).randn(tb.n_edge, 6), 0).astype(np.float32)
    pooled = np.asarray(jsegment.segment_max(jnp.asarray(msg), jb.receivers, tb.n_node, True))
    ties = (msg == pooled[np.asarray(jb.receivers)]).sum(0) - (pooled != 0).sum(0)
    assert ties.sum() > 0  # entries equal to a max of 0 beside another
    w = np.random.RandomState(52).randn(tb.n_node, 6).astype(np.float32)
    ref = jax.grad(lambda m: jnp.sum(w * jaggr.pool_edges_to_nodes(jb, m, mode="max")))(
        jnp.asarray(msg))
    x = torch.tensor(msg, requires_grad=True)
    (aggr.pool_edges_to_nodes(tb, x, mode="max") * torch.from_numpy(w)).sum().backward()
    _close(x.grad, ref, 0, 1e-7)


# (tested, reference, float64) of a weight ``w`` and a bias ``b``, the
# message the check raises with (None: it passes) and the tensors it takes
_RULES = {
    "within tolerance": ([1 + 1e-5], [1.0], [1.0], None, []),
    "nought": ([3e-12], [1e-12], [1e-20], None, ["b"]),
    "nought, tested too large": ([1e-3], [1e-12], [1e-20], "0 in float64", []),
    "no float64": ([1 + 1e-3], [1.0], None, "max.diff", []),
    "reference resolves it": ([1 + 1e-3], [1 + 1e-5], [1.0], "float32 resolves it", []),
    "taken": ([1 - 1e-3], [1 + 2e-4], [1.0], None, ["b"]),
    "taken, tested too far": ([1 - 2e-3], [1 + 2e-4], [1.0], "from float64 against", []),
}


@pytest.mark.parametrize("case", list(_RULES))
def test_check_grads_rules(case):
    """``chip_smoke.check_grads`` at ``TRAIN_TOL`` on a bias ``b`` beside a
    weight ``w`` that agrees: each of its float64 rules passes what it
    should and refuses the rest."""
    import chip_smoke as cs
    tested, ref, exact, message, taken = _RULES[case]
    w = torch.tensor([0.5, -1.0])
    grads = {"w": w, "b": torch.tensor(tested)}
    refs = {"w": w.clone(), "b": torch.tensor(ref)}
    x = None if exact is None else (lambda: {"w": w.double(),
                                             "b": torch.tensor(exact, dtype=torch.float64)})
    if message is not None:
        with pytest.raises(AssertionError, match=message):
            cs.check_grads(case, grads, refs, cs.TRAIN_TOL, x)
        return
    _, arbitrated = cs.check_grads(case, grads, refs, cs.TRAIN_TOL, x)
    assert sorted(arbitrated) == taken


def _cmpnn_default_gradients(n_mols):
    """CMPNN at its default widths on phase 23's first ``n_mols`` molecules
    (``chip_smoke.zoo_batch``, weights from seed 0): ``(p32, j32, p64,
    errors)``, the masked-MAE gradients by the port's names of the port in
    float32, of JAX in float32 on the same weights and of the port in
    float64; ``errors`` the port's and JAX's largest distances from float64
    over the tensors (of each tensor's largest entry), JAX's float64
    gradients' distance from the port's and the GRU readout's largest
    input."""
    import copy
    import functools

    import chip_smoke as cs
    from gcnn_keras_tpu.models import cmpnn as jcmpnn
    from gcnn_keras_tpu_torch.utils import convert
    tb = cs.zoo_batch("CMPNN", "cpu", n_mols=n_mols)
    jb = jbatch_graphs(cs.zoo_graphs("CMPNN", n_mols), global_keys=("graph_labels",),
                       compute_reverse_edges=True)
    model = cs.zoo_model("CMPNN", "cpu")
    tree, flax_of = {}, {}
    for key, p, transposed in convert._flax_leaves(model):
        node = tree
        for k in key.split("/")[:-1]:
            node = node.setdefault(k, {})
        node[key.split("/")[-1]] = (p.detach().numpy().T if transposed
                                    else p.detach().numpy()).copy()
        flax_of[id(p)] = (key, transposed)
    jm = jcmpnn.make_model()

    def jloss(params, b):
        out = jm.apply({"params": params}, b)["output"]
        return jlosses.masked_graph_mae(out, b.globals["graph_labels"], b.globals["graph_mask"])
    with jax.enable_x64(True):
        def as64(a):
            a = np.asarray(a)
            return jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a)
        j64 = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(
            jax.tree_util.tree_map(as64, tree), jax.tree_util.tree_map(as64, jb)))
    j32 = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, tree), jb))

    seen = {}
    model.gru_final.register_forward_pre_hook(
        lambda mod, args: seen.update(x=args[1].detach().abs().max().item()))
    names, params = zip(*model.named_parameters())
    p32 = dict(zip(names, torch.autograd.grad(cs.zoo_loss(model, tb), params)))
    p64 = cs.float64_grads(copy.deepcopy(model), cs.zoo_loss, tb)
    jax32, errors = {}, dict(port=0.0, jax=0.0, float64=0.0, gru_input=seen["x"])
    for n, p in zip(names, params):
        key, transposed = flax_of[id(p)]
        jx, jf = (np.asarray(functools.reduce(lambda d, k: d[k], key.split("/"), t), np.float64)
                  for t in (j64, j32))
        jx, jf = (jx.T, jf.T) if transposed else (jx, jf)
        jax32[n] = torch.from_numpy(jf).float()
        x = p64[n].numpy()
        scale = np.abs(x).max()
        if not scale:
            continue
        errors.update(port=max(errors["port"], np.abs(p32[n].double().numpy() - x).max() / scale),
                      jax=max(errors["jax"], np.abs(jf - x).max() / scale),
                      float64=max(errors["float64"], np.abs(jx - x).max() / scale))
    return p32, jax32, p64, errors


def test_cmpnn_float32_gradients_at_default_widths_need_the_float64_arbiter():
    """At its default widths CMPNN's booster multiplies sums by maxima round
    after round, so on phase 23's inputs (``chip_smoke.zoo_batch``, 16
    molecules here) the GRU readout reads values past 1e9 and saturates,
    and float32 gradients lie up to and past ``chip_smoke.TRAIN_TOL`` from
    float64. The two packages' float64 gradients agree to 1e-9. Here the
    port's float32 ones lie 5.7 times as far from float64 as JAX's (3.9e-4
    against 6.9e-5 of a tensor's largest entry; on 32 and 64 molecules 1.3
    and 2.5 times, ``test_cmpnn_float32_spread_follows_the_batch``):
    at these shapes PyTorch's float32 matmul on the CPU rounds up to 2.6x
    as far from float64 as XLA's dot
    (``test_cmpnn_float32_gap_is_the_cpu_matmul``), and the readout
    amplifies what each rounds. JAX's pass ``chip_smoke.check_grads``'
    float64 rules against the port's, as the card's are held against the
    CPU's in phase 23. A card three times as far as JAX passes by the
    rules; a 1% fault in a tensor they take, a 1e-3 fault in a small one
    they take, or one in a small tensor that float32 resolves, is
    refused."""
    import chip_smoke as cs
    p32, jax32, p64, errors = _cmpnn_default_gradients(16)
    names = list(p32)
    assert errors["gru_input"] > 1e9 and errors["float64"] <= 1e-9, errors
    port_err, jax_err = errors["port"], errors["jax"]
    # the measured gap, 5.7x, as an upper bound; JAX's largest 6.9e-5
    assert jax_err < cs.TRAIN_TOL and port_err < 6 * jax_err, (port_err, jax_err)
    cs.check_grads("JAX against the port", jax32, p32, cs.TRAIN_TOL, lambda: p64)

    def dev(g, n):
        return (g[n].double() - p64[n]).abs().max().item() / p64[n].abs().max().item()
    # ARBITER_FACTOR's measure: over the tensors whose JAX float32 gradient
    # the second rule takes, the port's lie up to 7.4 times as far
    spread = max(dev(p32, n) / dev(jax32, n) for n in names if p64[n].abs().max() > 0
                 and dev(jax32, n) > cs.TRAIN_TOL / (cs.ARBITER_FACTOR + 1))
    print(f"port {port_err:.3g}, JAX {jax_err:.3g} from float64; spread {spread:.3g}")
    assert spread < cs.ARBITER_FACTOR

    # a card three times as far from float64 as its reference (the H100's
    # lay 2.7-3.8 times as far as the CPU's), JAX's gradients the reference
    card = {n: (p64[n] + 3 * (jax32[n].double() - p64[n])).float() for n in names}
    _, arbitrated = cs.check_grads("CMPNN", card, jax32, cs.TRAIN_TOL, lambda: p64)
    top = max(v.abs().max().item() for v in p64.values())
    # edge_dense_3's bias, 5.4e-3 of the largest entry, is one the rules
    # take; node_out's, 2.5e-3 of it, float32 resolves (JAX lies 1.9e-6 of
    # it from float64), so it is held to the tolerance alone
    assert {"embedding.weight", "edge_dense_3.bias"} <= set(arbitrated)
    assert "node_out.bias" not in arbitrated
    for name, fault, match in (("embedding.weight", 1e-2, "from float64 against"),
                               ("edge_dense_3.bias", 1e-3, "from float64 against"),
                               ("node_out.bias", 1e-3, "float32 resolves it")):
        assert name == "embedding.weight" or p64[name].abs().max().item() < 1e-2 * top
        with pytest.raises(AssertionError, match=match):
            cs.check_grads("CMPNN", dict(card, **{name: card[name] * (1 + fault)}), jax32,
                           cs.TRAIN_TOL, lambda: p64)


@pytest.mark.parametrize("n_mols", [32, 64])
def test_cmpnn_float32_spread_follows_the_batch(n_mols):
    """On 32 and on 64 molecules (the first step's batch of phase 23) the
    port's float32 CMPNN gradients lie 1.3 and 2.5 times as far from
    float64 as JAX's (measured: 9.4e-4 against 7.5e-4, 2.7e-3 against
    1.1e-3 of a tensor's largest entry), on 16 5.7 times: the matmul's
    rounding, as the readout amplifies it, not a fault of the port, and
    each package's gradients pass ``chip_smoke.check_grads``' float64 rules
    against the other's. Held: the spread under 6x either way. Run with
    ``-s`` it prints the numbers."""
    import chip_smoke as cs
    p32, jax32, p64, errors = _cmpnn_default_gradients(n_mols)
    print(f"{n_mols} molecules: port {errors['port']:.3g}, JAX {errors['jax']:.3g} "
          f"from float64")
    assert errors["float64"] <= 1e-9, errors
    assert errors["port"] < 6 * errors["jax"] and errors["jax"] < 6 * errors["port"], errors
    for tested, ref in ((p32, jax32), (jax32, p32)):
        cs.check_grads(f"CMPNN, {n_mols} molecules", tested, ref, cs.TRAIN_TOL, lambda: p64)


def test_cmpnn_float32_gap_is_the_cpu_matmul():
    """Where the port's float32 CMPNN loses accuracy against JAX's on the
    CPU, layer by layer against each package's float64 forward on the
    batch of the test above: from the first Dense on, the port's module
    outputs lie up to 2.8x as far from float64 as JAX's (held under 4x);
    the GRU readout's output, 2e-4 from float64, as far in both. The
    sorted segment sum is not the cause (the port's plain path and XLA's
    give the same bits at (E, 300)); the matmul is: at the model's shapes
    PyTorch's float32 matmul on the CPU lies 1.1-2.6x as far from float64
    as XLA's dot (both within 1e-6). Run with ``-s`` it prints the
    numbers."""
    import copy

    import flax.linen as fnn

    import chip_smoke as cs
    from gcnn_keras_tpu.models import cmpnn as jcmpnn
    from gcnn_keras_tpu_torch.utils import convert
    mods = ["node_init", "edge_init"] + [f"edge_dense_{i}" for i in range(4)] + [
        "node_out", "gru_final", "out_mlp"]
    tb = cs.zoo_batch("CMPNN", "cpu", n_mols=16)
    jb = jbatch_graphs(cs.zoo_graphs("CMPNN", 16), global_keys=("graph_labels",),
                       compute_reverse_edges=True)
    model = cs.zoo_model("CMPNN", "cpu")
    tree = {}
    for key, p, transposed in convert._flax_leaves(model):
        node = tree
        for k in key.split("/")[:-1]:
            node = node.setdefault(k, {})
        node[key.split("/")[-1]] = (p.detach().numpy().T if transposed
                                    else p.detach().numpy()).copy()

    def port_outputs(m, b):
        outs = {}
        def keep(mod, args, out):
            outs[mod_names[mod]] = out.detach().double().numpy()
        mod_names = {getattr(m, name): name for name in mods}
        for mod in mod_names:
            mod.register_forward_hook(keep)
        with torch.no_grad():
            m(b)
        return outs

    def jax_outputs(params, b):
        outs = {}

        def capture(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            # the model's own children: their parent is the unnamed model
            if context.method_name == "__call__" and context.module.name in mods \
                    and getattr(context.module.parent, "name", 1) is None:
                outs[context.module.name] = np.asarray(out, np.float64)
            return out
        with fnn.intercept_methods(capture):
            jcmpnn.make_model().apply({"params": params}, b)
        return outs

    def rel(a, ref):
        return float(np.abs(np.asarray(a) - np.asarray(ref)).max() / np.abs(ref).max())
    m64 = copy.deepcopy(model).double()
    p32 = port_outputs(model, tb)
    p64 = port_outputs(m64, tb._map(lambda v: v.double() if v.is_floating_point() else v))
    j32 = jax_outputs(jax.tree_util.tree_map(jnp.asarray, tree), jb)
    with jax.enable_x64(True):
        def as64(a):
            a = np.asarray(a)
            return jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a)
        j64 = jax_outputs(jax.tree_util.tree_map(as64, tree), jax.tree_util.tree_map(as64, jb))
    for name in mods:
        port, ref = rel(p32[name], p64[name]), rel(j32[name], j64[name])
        print(f"{name}: port {port:.3g}, JAX {ref:.3g} from float64")
        assert rel(j64[name], p64[name]) < 1e-11, name
        assert port < 4 * ref, (name, port, ref)

    rs = np.random.RandomState(70)
    for m, k, n in ((tb.n_node, 64, 300), (tb.n_edge, 300, 300), (tb.n_node, 900, 300),
                    (tb.n_graphs * tb.max_nodes, 300, 900)):
        a = np.abs(rs.randn(m, k)).astype(np.float32)
        w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
        exact = a.astype(np.float64) @ w.astype(np.float64)
        port = rel((torch.from_numpy(a) @ torch.from_numpy(w)).numpy(), exact)
        ref = rel(jnp.asarray(a) @ jnp.asarray(w), exact)
        print(f"matmul ({m}, {k}) x ({k}, {n}): port {port:.3g}, XLA {ref:.3g} from float64")
        assert port < 1e-6 and ref < 1e-6
    h = np.abs(rs.randn(tb.n_edge, 300)).astype(np.float32)
    got = segment.segment_sum(torch.from_numpy(h), tb.receivers, tb.n_node, True)
    want = jsegment.segment_sum(jnp.asarray(h), jb.receivers, tb.n_node, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------- the models

# name -> (module, builder, small config, _graphs kwargs, reverse edges, coordinates)
MODELS = {
    "DMPNN": ("dmpnn", "make_model",
              dict(depth=2, input_embedding=EMBED,
                   edge_initialize={"units": 16, "activation": "relu"},
                   edge_dense={"units": 16, "activation": "linear"},
                   node_dense={"units": 16, "activation": "relu"}, output_mlp=OUT),
              {}, True, False),
    "DMPNN-float": ("dmpnn", "make_model",
                    dict(depth=2, in_features=10, edge_in_features=3,
                         edge_initialize={"units": 16, "activation": "relu"},
                         edge_dense={"units": 16, "activation": "linear"},
                         node_dense={"units": 12, "activation": "relu"},
                         output_embedding="node", output_mlp=OUT),
                    dict(node_features=10, edge_features=3), True, False),
    "DMPNN-bare": ("dmpnn", "make_model",
                   dict(depth=3, input_embedding=EMBED, edge_in_features=0,
                        edge_initialize={"units": 16, "activation": "relu"},
                        edge_dense={"units": 16, "activation": "linear"},
                        node_dense={"units": 16, "activation": "relu"}, output_mlp=OUT),
                   dict(edge_features=0), True, False),
    "CMPNN": ("cmpnn", "make_model",
              dict(depth=3, input_embedding=NODE16, edge_in_features=4,
                   node_initialize={"units": 16, "activation": "relu"},
                   edge_initialize={"units": 16, "activation": "relu"},
                   edge_dense={"units": 16, "activation": "linear"},
                   node_dense={"units": 16, "activation": "linear"},
                   pooling_gru={"units": 12}, output_mlp=OUT),
              dict(edge_features=4), True, False),
    "CMPNN-bare": ("cmpnn", "make_model",
                   dict(depth=2, in_features=10, use_final_gru=False,
                        pooling_kwargs={"pooling_method": "mean"},
                        node_initialize={"units": 16, "activation": "relu"},
                        edge_initialize={"units": 16, "activation": "relu"},
                        edge_dense={"units": 16, "activation": "linear"},
                        node_dense={"units": 16, "activation": "linear"}, output_mlp=OUT),
                   dict(node_features=10, edge_features=0), True, False),
    "NMPN": ("nmpn", "make_model",
             dict(depth=2, node_dim=8, input_embedding=EMBED,
                  edge_mlp={"units": [16, 16], "activation": "swish"},
                  set2set_args={"channels": 8, "T": 2, "pooling_method": "sum"}),
             {}, False, False),
    "NMPN-nos2s": ("nmpn", "make_model",
                   dict(depth=3, node_dim=8, in_features=10, edge_in_features=3,
                        use_set2set=False, edge_mlp={"units": [16], "activation": "swish"},
                        output_mlp=OUT),
                   dict(node_features=10, edge_features=3), False, False),
    "NMPN-distance": ("nmpn", "make_model",
                      dict(depth=2, node_dim=8, input_embedding=NODE16, make_distance=True,
                           edge_mlp={"units": [16], "activation": "swish"},
                           set2set_args={"channels": 6, "T": 3, "pooling_method": "mean"}),
                      dict(edge_features=0), False, True),
    "NMPN-crystal": ("nmpn", "make_crystal_model",
                     dict(depth=2, node_dim=8,
                          gauss_args={"bins": 10, "distance_max": 5.0, "offset": 0.0,
                                      "sigma": 0.4},
                          edge_mlp={"units": [16], "activation": "swish"},
                          set2set_args={"channels": 8, "T": 2, "pooling_method": "sum"}),
                     None, False, False),
    "NMPN-node": ("nmpn", "make_model",
                  dict(depth=2, node_dim=8, input_embedding=EMBED, output_embedding="node",
                       edge_mlp={"units": [16], "activation": "swish"}, output_mlp=OUT),
                  {}, False, False),
    "AttentiveFP": ("attentivefp", "make_model",
                    dict(depthato=3, depthmol=2, attention_args={"units": 16},
                         input_embedding=EMBED,
                         output_mlp={"units": [16, 1],
                                     "activation": ["kgcnn>leaky_relu", "linear"]}),
                    {}, False, False),
    "AttentiveFP-float": ("attentivefp", "make_model",
                          dict(depthato=2, depthmol=3, attention_args={"units": 12},
                               in_features=10, edge_in_features=3, output_mlp=OUT),
                          dict(node_features=10, edge_features=3), False, False),
    "AttentiveFP-node": ("attentivefp", "make_model",
                         dict(depthato=2, attention_args={"units": 12}, input_embedding=EMBED,
                              output_embedding="node", output_mlp=OUT),
                         {}, False, False),
    "HamNet": ("hamnet", "make_model",
               dict(depth=2, input_embedding=EMBED,
                    message_kwargs={"units": 16, "units_edge": 16},
                    fingerprint_kwargs={"units": 16, "units_attend": 12, "depth": 2},
                    gru_kwargs={"units": 16}),
               {}, False, True),
    "HamNet-learned": ("hamnet", "make_model",
                       dict(depth=2, in_features=10, edge_in_features=3,
                            given_coordinates=False, union_type_node="naive",
                            union_type_edge="gru",
                            message_kwargs={"units": 16, "units_edge": 16},
                            fingerprint_kwargs={"units": 12, "units_attend": 12, "depth": 3},
                            gru_kwargs={"units": 16},
                            output_mlp={"use_bias": [True, False], "units": [12, 1],
                                        "activation": ["relu", "linear"]}),
                       dict(node_features=10, edge_features=3), False, False),
    "HamNet-plain": ("hamnet", "make_model",
                     dict(depth=2, input_embedding=EMBED, union_type_node="None",
                          union_type_edge="naive", output_embedding="node",
                          message_kwargs={"units": 12, "units_edge": 16},
                          gru_kwargs={"units": 16},
                          output_mlp={"use_bias": [True], "units": [8, 1],
                                      "activation": ["relu", "linear"]}),
                     {}, False, True),
    "MEGAN": ("megan", "make_model",
              dict(units=[8, 8, 8], importance_units=[8], final_units=[8, 1],
                   input_embedding=NODE16, edge_in_features=4),
              dict(edge_features=4), False, False),
    "MEGAN-bare": ("megan", "make_model",
                   dict(units=[8, 6], importance_channels=3, importance_units=[],
                        final_units=[1], in_features=10, final_pooling="mean",
                        regression_reference=0.5),
                   dict(node_features=10, edge_features=0), False, False),
    "INorp-set2set": ("inorp", "make_model",
                      dict(depth=2, input_embedding={**NODE16,
                                                     "edge": {"input_dim": 15, "output_dim": 8}},
                           node_mlp_args={"units": [24, 8], "activation": ["relu", "linear"]},
                           edge_mlp_args={"units": [24, 16], "activation": "relu"},
                           use_set2set=True, set2set_args={"channels": 8, "T": 3},
                           output_mlp=OUT),
                      dict(edge_classes=15), False, False),
}


def _case_graphs(name, seed):
    mod, _, _, gkw, reverse, coords = MODELS[name]
    if gkw is None:  # a periodic batch: the NMPN crystal golden's cells
        graphs, keys = _prepare(_crystal_load("nmpn_crystal")[0])
        return graphs, keys
    graphs = _graphs(seed, **gkw)
    return (_with_coordinates(graphs, seed + 7) if coords else graphs), ()


def _shared(name, seed=60):
    """The JAX model, its perturbed variables, the port model holding them,
    and the two batches of the case's graphs."""
    mod, builder, kw, _, reverse, _ = MODELS[name]
    graphs, keys = _case_graphs(name, seed)
    if "graph_labels" not in graphs[0]:
        rs = np.random.RandomState(seed)
        for g in graphs:
            g["graph_labels"] = rs.randn(1).astype(np.float32)
    keys = ("graph_labels",) + tuple(keys)
    jb = jbatch_graphs(graphs, global_keys=keys, compute_reverse_edges=reverse)
    tb = batch_graphs(graphs, global_keys=keys, compute_reverse_edges=reverse, device="cpu")
    jm = getattr(importlib.import_module(f"gcnn_keras_tpu.models.{mod}"), builder)(
        **{k: v for k, v in kw.items() if not k.endswith("in_features")})
    variables = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jb), seed + 1)
    port = getattr(importlib.import_module(f"gcnn_keras_tpu_torch.models.{mod}"), builder)
    model = params_from_jax(port(device="cpu", **kw), variables)
    return jm, variables, model, jb, tb


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    """Every output (MEGAN's importances too) against JAX."""
    jm, variables, model, jb, tb = _shared(name)
    ref, out = jax.jit(jm.apply)(variables, jb), model(tb)
    assert sorted(out) == sorted(ref)
    for k in ref:
        _close(out[k], ref[k])


@pytest.mark.parametrize("name", list(MODELS))
def test_model_loss_gradients_match_jax(name):
    jm, variables, model, jb, tb = _shared(name)
    mod, builder, kw = MODELS[name][:3]
    node = kw.get("output_embedding") == "node"

    def jloss(params):
        out = jm.apply({**variables, "params": params}, jb)["output"]
        if node:
            return jlosses.masked_node_mae(out, jnp.zeros_like(out), jb.node_mask)
        return jlosses.masked_graph_mae(out, jb.globals["graph_labels"], jb.globals["graph_mask"])
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    out = model(tb)["output"]
    loss = losses.masked_node_mae(out, torch.zeros_like(out), tb.node_mask) if node else \
        losses.masked_graph_mae(out, tb.globals["graph_labels"], tb.globals["graph_mask"])
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)

    def exact():
        """The port model's gradients in float64, by name."""
        m64 = model.double()
        b64 = tb._map(lambda v: v.double() if v.is_floating_point() else v)
        o64 = m64(b64)["output"]
        l64 = losses.masked_node_mae(o64, torch.zeros_like(o64), b64.node_mask) if node else \
            losses.masked_graph_mae(o64, b64.globals["graph_labels"], b64.globals["graph_mask"])
        named = dict(m64.named_parameters())
        used = [n for n, g in zip(names, grads) if g is not None]
        return dict(zip(used, (g.numpy() for g in torch.autograd.grad(
            l64, [named[n] for n in used]))))
    port = getattr(importlib.import_module(f"gcnn_keras_tpu_torch.models.{mod}"), builder)
    ref = {n: p.detach().numpy() for n, p in params_from_jax(
        port(device="cpu", **kw), {"params": jax.tree_util.tree_map(np.asarray, ref_grads)}
    ).named_parameters()}
    # a parameter that no output reads (Set2Set's recurrent kernel, HamNet's
    # last edge message) has no gradient here and a zero one in JAX
    for n in [n for n, g in zip(names, grads) if g is None]:
        assert not ref.pop(n).any(), n
    _grads_close([n for n, g in zip(names, grads) if g is not None],
                 [g for g in grads if g is not None], ref, exact)


def test_attentivefp_dropout_draws_from_a_torch_generator():
    """``train=True`` drops with the call's (or the model's own) generator:
    the same seed, the same output; another seed, another. Its masks are not
    JAX's (a deliberate difference); ``train=False`` is."""
    jm, variables, model, jb, tb = _shared("AttentiveFP")
    base = model(tb)["output"]
    runs = [model(tb, train=True, generator=torch.Generator().manual_seed(s))["output"]
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert not torch.allclose(runs[0], base)
    own = [model(tb, train=True)["output"] for _ in range(2)]
    assert not torch.equal(own[0], own[1])  # the model's generator moves on
    _close(base, jm.apply(variables, jb)["output"])


@pytest.mark.parametrize("name", ["DMPNN", "CMPNN"])
def test_reverse_edges_are_required(name):
    """Without ``compute_reverse_edges`` the batch has no ``edge_pair_index``:
    a ``ValueError`` naming how to build it (JAX: an assert)."""
    _, _, model, _, _ = _shared(name)
    tb = batch_graphs(_graphs(61, **MODELS[name][3]), device="cpu")
    with pytest.raises(ValueError, match="compute_reverse_edges=True"):
        model(tb)


@pytest.mark.parametrize("case", ["CMPNN edge width", "MEGAN edge width",
                                  "AttentiveFP edges", "HamNet edges", "NMPN edges"])
def test_widths_at_build_are_checked(case):
    make, kw = {"CMPNN edge width": (cmpnn.make_model, dict(edge_in_features=None)),
                "MEGAN edge width": (megan.make_model, dict(edge_in_features=None)),
                "AttentiveFP edges": (attentivefp.make_model, dict(edge_in_features=0)),
                "HamNet edges": (hamnet.make_model, dict(edge_in_features=0)),
                "NMPN edges": (nmpn.make_model, dict(edge_in_features=0))}[case]
    with pytest.raises(ValueError, match="edge_in_features"):
        make(device="cpu", **kw)


def test_model_defaults_are_the_jax_ones():
    for mod in (dmpnn, cmpnn, nmpn, attentivefp, hamnet, megan):
        jmod = importlib.import_module(f"gcnn_keras_tpu.models.{mod.__name__.split('.')[-1]}")
        ours = {k: v for k, v in mod.model_default.items() if not k.endswith("in_features")}
        assert ours == jmod.model_default, mod.__name__


def test_model_default_widths_build():
    """Each model at its ``model_default`` widths on a small batch: integer
    node numbers and edge classes, float edge features for CMPNN and MEGAN,
    coordinates for HamNet, reverse edges for DMPNN and CMPNN."""
    ints = _with_coordinates(_graphs(62), 63)
    floats = _graphs(62, edge_features=5)
    for make, graphs, kw, reverse in (
            (dmpnn.make_model, ints, {}, True), (cmpnn.make_model, floats,
                                                 dict(edge_in_features=5), True),
            (nmpn.make_model, ints, {}, False), (attentivefp.make_model, ints, {}, False),
            (hamnet.make_model, ints, {}, False),
            (megan.make_model, floats, dict(edge_in_features=5), False)):
        tb = batch_graphs(graphs, compute_reverse_edges=reverse, device="cpu")
        out = make(device="cpu", **kw)(tb)["output"]
        assert out.shape == (tb.n_graphs, 1) and torch.isfinite(out).all()


# --------------------------------------------------------- the kgcnn goldens


def _golden(name, pop=("z", "xyz")):
    graphs, weights, ref = _load(name)
    for g in graphs:
        for k in pop:
            g.pop(k, None)
    return graphs, list(weights), ref


def _nmpn_mapping(depth, set2set):
    mapping = ["OptionalInputEmbedding_0/Embed_0/embedding",
               "node_proj/Dense_0/kernel", "node_proj/Dense_0/bias"]
    if depth:
        for blk in ("edge_net_in", "edge_net_out"):
            for j in range(3):
                mapping += [f"{blk}/dense_{j}/Dense_0/kernel", f"{blk}/dense_{j}/Dense_0/bias"]
        mapping += ["edge_net_in_out/Dense_0/kernel", "edge_net_in_out/Dense_0/bias",
                    "edge_net_out_out/Dense_0/kernel", "edge_net_out_out/Dense_0/bias",
                    "gru/kernel", "gru/recurrent_kernel", "gru/bias"]
    if set2set:
        mapping += ["set2set_proj/Dense_0/kernel", "set2set_proj/Dense_0/bias",
                    "set2set/kernel", "set2set/recurrent_kernel", "set2set/bias"]
    return mapping + ["out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
                      "out_mlp/dense_1/Dense_0/kernel", "out_mlp/dense_1/Dense_0/bias",
                      "out_mlp/dense_2/Dense_0/kernel"]


NMPN_OUT = {"units": [25, 10, 1], "activation": ["selu", "selu", "sigmoid"],
            "use_bias": [True, True, False]}


def _dmpnn_golden():
    graphs, weights, ref = _golden("dmpnn", ("z", "xyz", "edge_indices_reverse"))
    kw = dict(depth=2, output_mlp={"units": [64, 32, 1], "activation": ["relu", "relu", "linear"],
                                   "use_bias": [True, True, False]})
    mapping = ["edge_init/Dense_0/kernel", "edge_init/Dense_0/bias",
               "edge_dense_shared/Dense_0/kernel", "edge_dense_shared/Dense_0/bias",
               "node_dense/Dense_0/kernel", "node_dense/Dense_0/bias",
               "out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
               "out_mlp/dense_1/Dense_0/kernel", "out_mlp/dense_1/Dense_0/bias",
               "out_mlp/dense_2/Dense_0/kernel"]
    return graphs, weights, ref, "dmpnn", "make_model", kw, \
        dict(in_features=8, edge_in_features=5), mapping, (), True


def _cmpnn_golden():
    graphs, weights, ref = _golden("cmpnn", ("z", "xyz", "edge_indices_reverse"))
    mapping = ["node_init/Dense_0/kernel", "node_init/Dense_0/bias",
               "edge_init/Dense_0/kernel", "edge_init/Dense_0/bias",
               "edge_dense_0/Dense_0/kernel", "edge_dense_0/Dense_0/bias",
               "node_out/Dense_0/kernel", "node_out/Dense_0/bias",
               "gru_final/kernel", "gru_final/recurrent_kernel", "gru_final/bias",
               "out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
               "out_mlp/dense_1/Dense_0/kernel", "out_mlp/dense_1/Dense_0/bias",
               "out_mlp/dense_2/Dense_0/kernel"]
    return graphs, weights, ref, "cmpnn", "make_model", dict(depth=2), \
        dict(in_features=8, edge_in_features=5), mapping, (), True


def _nmpn_golden(name, depth, set2set):
    graphs, weights, ref = _load(name)
    for g in graphs:
        g["node_number"] = g.pop("z").astype(np.int64)
        g["node_coordinates"] = g["xyz"]
    kw = dict(depth=depth, make_distance=True, expand_distance=True, use_set2set=set2set,
              output_mlp=NMPN_OUT)
    return graphs, list(weights), ref, "nmpn", "make_model", kw, {}, \
        _nmpn_mapping(depth, set2set), (), False


def _nmpn_crystal_golden():
    graphs, weights, ref = _crystal_load("nmpn_crystal")
    prepared, keys = _prepare(graphs)
    kw = dict(depth=2, make_distance=True, expand_distance=True, output_mlp=NMPN_OUT)
    return prepared, list(weights), ref, "nmpn", "make_crystal_model", kw, {}, \
        _nmpn_mapping(2, True), keys, False


def _attentivefp_golden():
    graphs, weights, ref = _golden("attentivefp")
    kw = dict(depthato=2, depthmol=2, attention_args={"units": 32},
              output_mlp={"units": [16, 1], "activation": ["kgcnn>leaky_relu", "linear"]})
    mapping = ["node_in/Dense_0/kernel", "node_in/Dense_0/bias"]
    for i in range(2):
        mapping += [f"head_{i}/linear_trafo/Dense_0/kernel", f"head_{i}/linear_trafo/Dense_0/bias",
                    f"head_{i}/alpha_activation/Dense_0/kernel",
                    f"head_{i}/alpha_activation/Dense_0/bias", f"head_{i}/alpha/Dense_0/kernel"]
        if i == 0:
            mapping += ["head_0/fc1/Dense_0/kernel", "head_0/fc1/Dense_0/bias",
                        "head_0/fc2/Dense_0/kernel", "head_0/fc2/Dense_0/bias"]
        mapping += [f"gru_{i}/kernel", f"gru_{i}/recurrent_kernel", f"gru_{i}/bias"]
    mapping += ["pool_attentive/linear_trafo/Dense_0/kernel",
                "pool_attentive/linear_trafo/Dense_0/bias",
                "pool_attentive/alpha/Dense_0/kernel", "pool_attentive/alpha/Dense_0/bias",
                "pool_attentive/gru/kernel", "pool_attentive/gru/recurrent_kernel",
                "pool_attentive/gru/bias",
                "out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
                "out_mlp/dense_1/Dense_0/kernel", "out_mlp/dense_1/Dense_0/bias"]
    return graphs, weights, ref, "attentivefp", "make_model", kw, \
        dict(in_features=8, edge_in_features=5), mapping, (), False


def _hamnet_golden():
    graphs, weights, ref = _load("hamnet")
    for g in graphs:
        g.pop("z")
        g["node_coordinates"] = g.pop("xyz")
    kw = dict(depth=2, message_kwargs={"units": 32, "units_edge": 32},
              fingerprint_kwargs={"units": 32, "units_attend": 32, "depth": 2},
              gru_kwargs={"units": 32})
    mapping = ["node_init/Dense_0/kernel", "node_init/Dense_0/bias",
               "edge_init/Dense_0/kernel", "edge_init/Dense_0/bias"]
    for i in range(2):
        mapping += [f"message_{i}/dense_attend/Dense_0/kernel",
                    f"message_{i}/dense_attend/Dense_0/bias",
                    f"message_{i}/dense_align/Dense_0/kernel",
                    f"message_{i}/dense_align/Dense_0/bias",
                    f"message_{i}/dense_e/Dense_0/kernel", f"message_{i}/dense_e/Dense_0/bias",
                    f"gru_union_{i}/kernel", f"gru_union_{i}/recurrent_kernel",
                    f"gru_union_{i}/bias"]
    mapping += ["fingerprint/vertex2mol/Dense_0/kernel", "fingerprint/vertex2mol/Dense_0/bias"]
    for t in range(2):
        mapping += [f"fingerprint/attend_{t}/Dense_0/kernel",
                    f"fingerprint/attend_{t}/Dense_0/bias",
                    f"fingerprint/align_{t}/Dense_0/kernel",
                    f"fingerprint/align_{t}/Dense_0/bias"]
    for t in range(2):
        mapping += [f"fingerprint/gru_{t}/kernel", f"fingerprint/gru_{t}/recurrent_kernel",
                    f"fingerprint/gru_{t}/bias"]
    mapping += ["out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
                "out_mlp/dense_1/Dense_0/kernel", "out_mlp/dense_1/Dense_0/bias",
                "out_mlp/dense_2/Dense_0/kernel"]
    return graphs, list(weights), ref, "hamnet", "make_model", kw, \
        dict(in_features=8, edge_in_features=5), mapping, (), False


def _megan_golden():
    graphs, weights, ref = _golden("megan")
    kw = dict(units=[16, 16], importance_channels=2, importance_units=[8], final_units=[8, 1])
    mapping = []
    for i in range(2):
        for k in range(2):
            mapping += [f"att_{i}/head_{k}_linear/Dense_0/kernel",
                        f"att_{i}/head_{k}_linear/Dense_0/bias",
                        f"att_{i}/head_{k}_alpha_act/Dense_0/kernel",
                        f"att_{i}/head_{k}_alpha_act/Dense_0/bias",
                        f"att_{i}/head_{k}_alpha/Dense_0/kernel"]
    mapping += ["node_imp_0/Dense_0/kernel", "node_imp_0/Dense_0/bias",
                "node_imp_1/Dense_0/kernel", "node_imp_1/Dense_0/bias",
                "final_0/Dense_0/kernel", "final_0/Dense_0/bias",
                "final_1/Dense_0/kernel", "final_1/Dense_0/bias"]
    return graphs, weights, ref, "megan", "make_model", kw, \
        dict(in_features=8, edge_in_features=5), mapping, (), False


GOLDENS = {"dmpnn": _dmpnn_golden, "cmpnn": _cmpnn_golden,
           "nmpn": lambda: _nmpn_golden("nmpn", 2, True),
           "nmpn_crystal": _nmpn_crystal_golden,
           "nmpn_d0": lambda: _nmpn_golden("nmpn_d0", 0, False),
           "nmpn_d1": lambda: _nmpn_golden("nmpn_d1", 1, False),
           "nmpn_nos2s": lambda: _nmpn_golden("nmpn_nos2s", 2, False),
           "attentivefp": _attentivefp_golden, "hamnet": _hamnet_golden,
           "megan": _megan_golden}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_zoo_b_golden(name):
    """The reference's weights mapped into the JAX parameters by the
    recipe, carried into the port; the port's graph outputs (MEGAN's node
    and edge importances too) against the recorded ones."""
    graphs, weights, ref, mod, builder, kw, widths, mapping, keys, reverse = GOLDENS[name]()
    eis = [g["edge_indices"].copy() for g in graphs]
    jb = jbatch_graphs(graphs, global_keys=keys, compute_reverse_edges=reverse)
    jmake = getattr(importlib.import_module(f"gcnn_keras_tpu.models.{mod}"), builder)
    variables = _apply_mapping(jmake(**kw).init(jax.random.PRNGKey(0), jb), weights, mapping)
    make = getattr(importlib.import_module(f"gcnn_keras_tpu_torch.models.{mod}"), builder)
    model = params_from_jax(make(device="cpu", **kw, **widths),
                            jax.tree_util.tree_map(np.asarray, variables))
    tb = batch_graphs(graphs, global_keys=keys, compute_reverse_edges=reverse, device="cpu")
    out = model(tb)
    np.testing.assert_allclose(out["output"].detach().numpy()[:len(ref)], ref,
                               rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    if name != "megan":
        return
    d = np.load(os.path.join(os.path.dirname(__file__), "assets", f"ref_golden_{name}.npz"))
    node_imp, edge_imp = (out[k].detach().numpy() for k in ("node_importances",
                                                            "edge_importances"))
    n_off = e_off = 0
    for gi, (g, ei) in enumerate(zip(graphs, eis)):
        n, m = len(g["node_attributes"]), len(ei)
        np.testing.assert_allclose(node_imp[n_off:n_off + n], d["out1"][gi, :n],
                                   rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
        # the batcher sorts each graph's edges by receiver, stably
        perm = np.argsort(ei[:, 0], kind="stable")
        np.testing.assert_allclose(edge_imp[e_off:e_off + m], d["out2"][gi, :m][perm],
                                   rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
        n_off, e_off = n_off + n, e_off + m
