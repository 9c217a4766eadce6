"""The port's wACSF layers and HDNNP2nd's weighted, atom-wise and
inverse-distance models against the JAX package, on shared weights, on the
CPU.

Both packages compute in float32 and sum in other orders (the port's sums
run on the sorted segment-sum's plain version), so descriptors and energies
agree within ``1e-5`` of the largest reference value and forces within
``1e-4``; force-loss parameter gradients (through two reverse passes)
within ``1e-4`` of each tensor's largest entry, the tolerances of
``tests/test_torch_training.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from bench import _mols
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.layers.conv import wacsf as jwacsf
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models import hdnnp2nd as jhdnnp2nd
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers.conv import wacsf
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import hdnnp2nd, registry
from gcnn_keras_tpu_torch.ops.cuda import segment_sum as kseg
from gcnn_keras_tpu_torch.training import losses
from gcnn_keras_tpu_torch.utils import convert
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

VAL_TOL, FORCE_TOL, GRAD_TOL, LOSS_RTOL = 1e-5, 1e-4, 1e-4, 1e-5
MLP = {"units": [16, 16, 1], "num_relations": 10, "activation": ["swish", "swish", "linear"]}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(out, ref, tol):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _batches(seed, n_mols, **extra):
    graphs = _mols(np.random.RandomState(seed), n_mols, with_esp=True)
    for g in graphs:
        g.update({k: f(len(g["node_number"])) for k, f in extra.items()})
    return (jbatch_graphs(graphs, global_keys=("energy",)),
            batch_graphs(graphs, global_keys=("energy",), device="cpu"))


# ------------------------------------------------------------ wACSF layers


@pytest.mark.parametrize("kind", ["rad", "ang"])
@pytest.mark.parametrize("table", ["default", "custom"])
def test_wacsf_layer_and_its_forces_match_jax(kind, table):
    """Descriptors, and the position gradient of a random projection of them
    (the forces' path: the sorted sum's backward gather), against JAX
    autodiff; a custom table of 5 sets for every element, and a cutoff."""
    jb, tb = _batches(3, 4)
    rs = np.random.RandomState(1)
    if kind == "rad":
        kw = {} if table == "default" else {
            "eta_mu": np.stack([rs.uniform(0.5, 2.0, (118, 5)), rs.uniform(0.5, 4.0, (118, 5))],
                               -1).astype(np.float32), "cutoff": 3.5}
        jl, tl = jwacsf.wACSFRad(**kw), wacsf.wACSFRad(**kw)
    else:
        kw = {} if table == "default" else {
            "eta_mu_lambda_zeta": np.stack(
                [rs.uniform(0.01, 0.5, (118, 5)), rs.uniform(0.0, 2.0, (118, 5)),
                 rs.choice([-1.0, 1.0], (118, 5)), rs.choice([1.0, 2.0, 4.0], (118, 5))],
                -1).astype(np.float32), "cutoff": 3.5}
        jl, tl = jwacsf.wACSFAng(**kw), wacsf.wACSFAng(**kw)
    n_out = tl.out_features
    proj = rs.randn(jb.n_node, n_out).astype(np.float32)

    def jfn(pos):
        return jnp.sum(jl.apply({}, jb, positions=pos) * proj)
    ref = jl.apply({}, jb)
    ref_grad = jax.grad(jfn)(jb.nodes["node_coordinates"])
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    out = tl(tb, positions=pos)
    (grad,) = torch.autograd.grad((out * torch.from_numpy(proj)).sum(), pos)
    _close(out, ref, VAL_TOL)
    _close(grad, ref_grad, FORCE_TOL)


def test_wacsf_default_tables_match_jax():
    np.testing.assert_array_equal(wacsf.default_radial_eta_mu(), jwacsf.default_radial_eta_mu())
    np.testing.assert_array_equal(wacsf.default_angular_params(),
                                  jwacsf.default_angular_params())


def test_wacsf_sums_run_on_the_sorted_segment_sum(monkeypatch):
    """Both layers sum by a sorted id (receivers; angle centres), so each is
    one call of the kernel's wrapper; the angular one's centres ascend."""
    _, tb = _batches(4, 3)
    calls = []
    run = kseg.segment_sum

    def counted(values, ids, n):
        calls.append((values.shape, bool((ids[1:] >= ids[:-1]).all())))
        return run(values, ids, n)
    monkeypatch.setattr(kseg, "segment_sum", counted)
    wacsf.wACSFRad()(tb)
    wacsf.wACSFAng()(tb)
    assert calls == [((tb.n_edge, 22), True), ((tb.angles.shape[0], 10), True)]


def test_wacsf_angular_clamp_gives_finite_forces():
    """A collinear triple with lambda = -1 puts 1 + lambda cos at 0, below
    the 1e-30 clamp: the term and its position gradient are 0, as JAX's."""
    g = {"node_number": np.array([6, 1, 1]),
         "node_coordinates": np.array([[0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]], np.float32),
         "edge_indices": np.array([[0, 1], [0, 2], [1, 0], [1, 2], [2, 0], [2, 1]]),
         "angle_indices_nodes": np.array([[0, 1, 2], [0, 2, 1]])}
    table = np.tile(np.array([0.1, 0.0, -1.0, 2.0], np.float32), (118, 1, 1))
    jl, tl = jwacsf.wACSFAng(eta_mu_lambda_zeta=table), wacsf.wACSFAng(eta_mu_lambda_zeta=table)
    jb, tb = jbatch_graphs([g]), batch_graphs([g], device="cpu")
    ref_grad = jax.grad(lambda p: jnp.sum(jl.apply({}, jb, positions=p)))(
        jb.nodes["node_coordinates"])
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    out = tl(tb, positions=pos)
    (grad,) = torch.autograd.grad(out.sum(), pos)
    assert torch.isfinite(grad).all() and not out.any()
    np.testing.assert_array_equal(grad.numpy(), np.asarray(ref_grad))


# ----------------------------------------------------- HDNNP2nd modes


def _jax_loss(jm):
    def loss_fn(params, b):
        out = jm.apply(params, b, train=False)
        return (jlosses.masked_graph_mae(out["energy"], b.globals["energy"],
                                         b.globals["graph_mask"])
                + 100.0 * jlosses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask))
    return loss_fn


def _port_loss(fm, b):
    out = fm.apply(b, create_graph=True)
    return (losses.masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
            + 100.0 * losses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask))


def _perturbed_stats(params, rs):
    """``params`` with every ``batch_stats`` mean and var, and the ``norm``
    layer's scale and bias, moved off their initial values."""
    params = jax.tree_util.tree_map(np.array, params)
    if "batch_stats" in params:
        stats = params["batch_stats"]["norm"]
        stats["mean"] = (rs.randn(*stats["mean"].shape) * 0.3).astype(np.float32)
        stats["var"] = rs.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)
        p = params["params"]["norm"]
        p["scale"] = rs.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = (rs.randn(*p["bias"].shape) * 0.1).astype(np.float32)
    return params


MODES = {
    "weighted": (jhdnnp2nd.make_model_weighted, hdnnp2nd.make_model_weighted,
                 dict(mlp_kwargs=MLP)),
    "weighted-normalize": (jhdnnp2nd.make_model_weighted, hdnnp2nd.make_model_weighted,
                           dict(mlp_kwargs=MLP, normalize_kwargs={"epsilon": 1e-3})),
    "make_model-custom-wacsf": (jhdnnp2nd.make_model, hdnnp2nd.make_model,
                                dict(mlp_kwargs=MLP, w_acsf_rad_kwargs={"cutoff": 4.0},
                                     w_acsf_ang_kwargs={"cutoff": 4.0})),
    "behler-normalize": (jhdnnp2nd.make_model_behler, hdnnp2nd.make_model_behler,
                         dict(mlp_kwargs=MLP, normalize_kwargs={"momentum": 0.9},
                              g2_kwargs={"elements": [1, 6, 7, 8, 9], "rc": 4.0},
                              g4_kwargs={"elements": [1, 6, 7, 8, 9], "rc": 4.0})),
}


def _shared(mode, jb):
    jmake, tmake, kw = MODES[mode]
    jm = JEnergyForceModel(jmake(**kw))
    params = _perturbed_stats(_tree(jax.jit(lambda k, b: jm.init(k, b))(
        jax.random.PRNGKey(2), jb)), np.random.RandomState(5))
    tm = params_from_jax(tmake(device="cpu", **kw), params)
    return jm, params, EnergyForceModel(tm, device="cpu")


@pytest.mark.parametrize("mode", list(MODES))
def test_hdnnp2nd_energies_forces_and_force_loss_gradients_match_jax(mode):
    """Energies and forces, then the E + 100 F loss's parameter gradients;
    with ``normalize_kwargs`` on perturbed running statistics (the
    default ``train=False`` normalizes by them, in both packages)."""
    jb, tb = _batches(7, 3)
    jm, params, fm = _shared(mode, jb)
    ref = jax.jit(jm.apply)(params, jb)
    out = fm.apply(tb)
    _close(out["energy"], ref["energy"], VAL_TOL)
    _close(out["force"], ref["force"], FORCE_TOL)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(_jax_loss(jm)))(params, jb)
    loss = _port_loss(fm, tb)
    names = [n for n, _ in fm.energy_model.named_parameters()]
    grads = torch.autograd.grad(loss, list(fm.energy_model.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    jmake, tmake, kw = MODES[mode]
    ref_model = params_from_jax(tmake(device="cpu", **kw),
                                {**params, "params": _tree(ref_grads["params"])})
    ref_params = dict(ref_model.named_parameters())
    assert len(names) == len(ref_params) > 0
    for n, g in zip(names, grads):
        _close(g, ref_params[n], GRAD_TOL)


def test_hdnnp2nd_train_true_updates_the_running_statistics_as_jax():
    """``train=True``: the energies of batch statistics, and the running
    averages after, against ``apply(..., train=True, mutable=["batch_stats"])``."""
    jb, tb = _batches(8, 3)
    jmake, tmake, kw = MODES["weighted-normalize"]
    jmodel = jmake(**kw)
    params = _perturbed_stats(_tree(jmodel.init(jax.random.PRNGKey(2), jb)),
                              np.random.RandomState(6))
    ref, state = jmodel.apply(params, jb, train=True, mutable=["batch_stats"])
    tm = params_from_jax(tmake(device="cpu", **kw), params)
    out = tm(tb, train=True)
    _close(out["output"], ref["output"], VAL_TOL)
    for leaf in ("mean", "var"):
        _close(getattr(tm.norm, leaf), state["batch_stats"]["norm"][leaf], VAL_TOL)
    # train=False (the default) leaves them as they are
    before = tm.norm.mean.clone()
    tm(tb)
    assert torch.equal(tm.norm.mean, before)


def test_hdnnp2nd_atom_wise_matches_jax():
    """Energies of a given ``node_representation`` and the parameter
    gradients of their squares; no position enters, so the forces are 0."""
    rs = np.random.RandomState(9)
    jb, tb = _batches(9, 3, node_representation=lambda n: rs.randn(n, 12).astype(np.float32))
    kw = dict(mlp_kwargs=MLP, use_output_mlp=True)
    jmodel = jhdnnp2nd.make_model_atom_wise(**kw)
    params = _tree(jmodel.init(jax.random.PRNGKey(4), jb))
    tm = params_from_jax(hdnnp2nd.make_model_atom_wise(device="cpu", rep_features=12, **kw),
                         params)

    def jloss(p):
        return jnp.sum(jmodel.apply(p, jb)["output"] ** 2)
    ref_grads = jax.grad(jloss)(params)
    out = tm(tb)["output"]
    _close(out, jmodel.apply(params, jb)["output"], VAL_TOL)
    grads = torch.autograd.grad((out ** 2).sum(), list(tm.parameters()))
    ref_params = dict(params_from_jax(hdnnp2nd.make_model_atom_wise(
        device="cpu", rep_features=12, **kw), _tree(ref_grads)).named_parameters())
    for (n, _), g in zip(tm.named_parameters(), grads):
        _close(g, ref_params[n], GRAD_TOL)
    assert not EnergyForceModel(tm, device="cpu").apply(tb)["force"].any()


def _graphs_of_sizes(seed, sizes):
    rs = np.random.RandomState(seed)
    return [{"node_number": rs.choice([1, 6, 8], size=n),
             "node_coordinates": (rs.randn(n, 3) * 1.5).astype(np.float32),
             "energy": np.array([rs.randn()], np.float32),
             "force": (rs.randn(n, 3) * 0.1).astype(np.float32),
             "edge_indices": np.zeros((0, 2), np.int64)} for n in sizes]


def _equal_size_batches(seed, n_mols, n_atoms):
    graphs = _graphs_of_sizes(seed, [n_atoms] * n_mols)
    return (jbatch_graphs(graphs, global_keys=("energy",)),
            batch_graphs(graphs, global_keys=("energy",), device="cpu"))


def test_inverse_distance_model_matches_jax():
    """Energies, forces and the force loss's parameter gradients of
    ``make_model_inverse_distances`` on molecules of 7 atoms (21 pair
    distances)."""
    jb, tb = _equal_size_batches(10, 4, 7)
    kw = dict(mlp_kwargs={"units": [16, 8, 1], "activation": ["swish", "swish", "linear"]})
    jm = JEnergyForceModel(jhdnnp2nd.make_model_inverse_distances(**kw))
    params = _tree(jm.init(jax.random.PRNGKey(5), jb))
    tm = params_from_jax(hdnnp2nd.make_model_inverse_distances(device="cpu", max_nodes=7, **kw),
                         params)
    assert tm.mlp.dense_0.weight.shape == (16, 21)
    fm = EnergyForceModel(tm, device="cpu")
    ref = jax.jit(jm.apply)(params, jb)
    out = fm.apply(tb)
    _close(out["energy"], ref["energy"], VAL_TOL)
    _close(out["force"], ref["force"], FORCE_TOL)
    ref_loss, ref_grads = jax.value_and_grad(_jax_loss(jm))(params, jb)
    loss = _port_loss(fm, tb)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    ref_params = dict(params_from_jax(hdnnp2nd.make_model_inverse_distances(
        device="cpu", max_nodes=7, **kw), _tree(ref_grads)).named_parameters())
    for (n, _), g in zip(tm.named_parameters(), grads):
        _close(g, ref_params[n], GRAD_TOL)


def test_inverse_distance_model_pads_smaller_molecules_to_its_width():
    """A batch of 5- and 6-atom molecules through the 7-atom model: the
    energies and forces of the same molecules batched with ``max_nodes=7``,
    and the JAX model's on that batch."""
    graphs = _graphs_of_sizes(12, [5, 6, 5])
    kw = dict(mlp_kwargs={"units": [16, 8, 1], "activation": ["swish", "swish", "linear"]})
    jb7 = jbatch_graphs(graphs, global_keys=("energy",), max_nodes=7)
    jm = JEnergyForceModel(jhdnnp2nd.make_model_inverse_distances(**kw))
    params = _tree(jm.init(jax.random.PRNGKey(6), jb7))
    fm = EnergyForceModel(params_from_jax(hdnnp2nd.make_model_inverse_distances(
        device="cpu", max_nodes=7, **kw), params), device="cpu")
    tb = batch_graphs(graphs, global_keys=("energy",), device="cpu")
    tb7 = batch_graphs(graphs, global_keys=("energy",), device="cpu", max_nodes=7)
    assert tb.max_nodes == 6
    out, out7, ref = fm.apply(tb), fm.apply(tb7), jm.apply(params, jb7)
    for key, tol in (("energy", VAL_TOL), ("force", FORCE_TOL)):
        torch.testing.assert_close(out[key], out7[key], rtol=0, atol=0)
        _close(out[key], ref[key], tol)


def test_inverse_distance_model_refuses_a_larger_molecule():
    _, tb = _equal_size_batches(11, 2, 6)
    tm = hdnnp2nd.make_model_inverse_distances(device="cpu", max_nodes=5)
    with pytest.raises(ValueError, match="max_nodes=5"):
        tm(tb)


@pytest.mark.parametrize("builder", ["make_model", "make_model_weighted",
                                     "make_model_atom_wise", "make_model_behler",
                                     "make_model_inverse_distances"])
def test_registry_reaches_every_hdnnp2nd_builder(builder):
    fn = registry.get_model_class("HDNNP2nd", builder)
    assert fn is getattr(hdnnp2nd, builder)
    model = registry.make_model_by_name("kgcnn.literature.HDNNP2nd", builder,
                                        config={"mlp_kwargs": MLP}, device="cpu")
    assert isinstance(model, (hdnnp2nd.HDNNP2nd, hdnnp2nd.HDNNP2ndInverseDistances))
    if builder in ("make_model", "make_model_weighted"):
        assert model.mode == "weighted"


def _flax_variables(model):
    """The flax variables of a port model (``params_from_jax`` in reverse):
    its parameters, and its ``GraphBatchNorm``'s running statistics."""
    tree = {}
    for key, tensor, transposed in convert._flax_leaves(model):
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        value = tensor.detach().numpy()
        node[leaf] = value.T if transposed else value
    stats = {"norm": {"mean": model.norm.mean.numpy(), "var": model.norm.var.numpy()}}
    return {"params": tree, "batch_stats": stats}


def test_wacsf_training_recipe_gives_jax_loss_series():
    """``chip_smoke.py``'s ``hdnnp2nd_weighted_train`` (the default model
    with a GraphBatchNorm, E + 100 F, Adam 1e-3) on 16 of its molecules: the
    port's five steps give the JAX package's loss series on the same
    weights, overshoot and all (so that path holds its losses finite, not
    falling)."""
    import optax
    path = "hdnnp2nd_weighted_train"
    model, trainer, state = chip_smoke.make_trainer(path, "cpu")
    graphs = chip_smoke.labelled_mols(5, 16, True)
    tb = batch_graphs(graphs, global_keys=("energy",), device="cpu")
    jb = jbatch_graphs(graphs, global_keys=("energy",))
    variables = _flax_variables(model)
    jm = JEnergyForceModel(jhdnnp2nd.make_model(normalize_kwargs={"epsilon": 1e-3}))
    loss_fn = _jax_loss(jm)
    opt = optax.adam(1e-3)
    p, opt_state = variables["params"], opt.init(variables["params"])
    grad = jax.jit(jax.value_and_grad(
        lambda q: loss_fn({"params": q, "batch_stats": variables["batch_stats"]}, jb)))
    ref, got = [], []
    step = trainer.step_fn()
    for _ in range(5):
        loss, g = grad(p)
        updates, opt_state = opt.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        ref.append(float(loss))
        state, metrics = step(state, tb)
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert torch.equal(model.norm.mean, torch.zeros_like(model.norm.mean))
