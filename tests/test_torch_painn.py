"""The port's PAiNN against the JAX package, on shared weights, on the CPU.

The JAX parameters come from ``init``, are moved off their initial values
(biases 0, layer-norm scales 1) by a seeded perturbation so that every
weight matters, and go through ``params_from_jax`` into the port. Both
packages then run the same numpy inputs. They differ only in float32
summation order: energies, forces and layer outputs agree to ``rtol=1e-5``
and ``atol=1e-5 * max|reference|``, as in ``test_torch_schnet.py``.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.layers import geometry as jgeo
from gcnn_keras_tpu.layers.conv import painn as jpainn_conv
from gcnn_keras_tpu.layers.norm import GraphLayerNorm as JGraphLayerNorm
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models import painn as jpainn
from gcnn_keras_tpu.moldyn.base import MolDynamicsModelPredictor as JPredictor
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.graph.preprocess import set_range
from gcnn_keras_tpu_torch.layers import geometry
from gcnn_keras_tpu_torch.layers.conv import painn as painn_conv
from gcnn_keras_tpu_torch.layers.norm import GraphLayerNorm
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import painn
from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
from gcnn_keras_tpu_torch.training import Trainer
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

# depth 2, 32 units, 8 radial functions; the bench's cosine cutoff
SMALL = dict(depth=2, conv_args={"units": 32, "cutoff": 5.0}, update_args={"units": 32},
             input_embedding={"node": {"input_dim": 95, "output_dim": 32}},
             bessel_basis={"num_radial": 8, "cutoff": 5.0},
             output_mlp={"units": [32, 1], "activation": ["swish", "linear"]})
NORMS = {"no norms": {}, "equiv norm": dict(equiv_normalization=True),
         "node norm": dict(node_normalization=True),
         "both norms": dict(equiv_normalization=True, node_normalization=True)}


def _mols(seed, n_mols):
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_mols):
        n = rs.randint(4, 13)
        g = {"node_number": rs.choice([1, 6, 7, 8, 9], size=n),
             "node_coordinates": (rs.randn(n, 3) * 1.5).astype(np.float32)}
        g = jpre.set_range(g, max_distance=4.0, max_neighbours=25)
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(g)
    return graphs


def _crystals(seed, n_cryst):
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_cryst):
        n = rs.randint(2, 5)
        lat = np.diag(rs.uniform(3.0, 4.0, size=3)) + rs.randn(3, 3) * 0.1
        g = {"node_number": rs.choice([3, 8, 14], size=n),
             "node_coordinates": (rs.rand(n, 3) @ lat).astype(np.float32),
             "graph_lattice": lat.astype(np.float32)}
        g = jpre.set_range_periodic(g, max_distance=3.5, backend="numpy")
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(g)
    return graphs


def _perturbed(params, seed, scale=0.1):
    """numpy copy of a flax tree with seeded noise added to every leaf."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rs.randn(*np.shape(x))).astype(np.float32), params)


def _shared(kw, jb, seed=0, crystal=False):
    """A JAX EnergyForceModel with perturbed init params and the port's
    model on the CPU holding the same weights."""
    jm = JEnergyForceModel((jpainn.make_crystal_model if crystal else jpainn.make_model)(**kw),
                           is_physical_force=True)
    params = _perturbed(jax.jit(lambda k, b: jm.init(k, b))(jax.random.PRNGKey(1), jb), seed)
    tmodel = (painn.make_crystal_model if crystal else painn.make_model)(device="cpu", **kw)
    params_from_jax(tmodel, params)
    return jm, params, EnergyForceModel(tmodel, device="cpu")


def _close(out, ref, scale=None):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * scale)


# ------------------------------------------------------------ layers


def _geometry_cases(d, jd):
    return {
        "bessel_basis": (geometry.bessel_basis(d, 8, 5.0), jgeo.bessel_basis(jd, 8, 5.0)),
        "bessel_basis_envelope": (geometry.bessel_basis(d, 8, 3.0, envelope=True, exponent=4),
                                  jgeo.bessel_basis(jd, 8, 3.0, envelope=True, exponent=4)),
        "bessel_basis_kgcnn": (geometry.bessel_basis_kgcnn(d, 20, 3.0, 5),
                               jgeo.bessel_basis_kgcnn(jd, 20, 3.0, 5)),
        "polynomial_envelope": (geometry.polynomial_envelope(d / 3.0, 6),
                                jgeo.polynomial_envelope(jd / 3.0, 6)),
        "cosine_cutoff_envelope": (geometry.cosine_cutoff_envelope(d, 3.0),
                                   jgeo.cosine_cutoff_envelope(jd, 3.0)),
        "cosine_cutoff": (geometry.cosine_cutoff(d * 2.0 + 1.0, d, 3.0),
                          jgeo.cosine_cutoff(jd * 2.0 + 1.0, jd, 3.0)),
    }


@pytest.mark.parametrize("name", ["bessel_basis", "bessel_basis_envelope", "bessel_basis_kgcnn",
                                  "polynomial_envelope", "cosine_cutoff_envelope",
                                  "cosine_cutoff"])
def test_radial_functions_match_jax(name):
    """On distances from 0 to past every cutoff (the envelopes are 0 there)."""
    d = np.concatenate([[0.0, 1e-9], np.random.RandomState(0).uniform(0, 6, 40)])
    d = d.astype(np.float32)[:, None]
    out, ref = _geometry_cases(torch.from_numpy(d), jnp.asarray(d))[name]
    _close(out, ref)


def test_edge_directions_match_jax():
    graphs = _crystals(7, 2) + _mols(7, 2)
    jb = jbatch_graphs(graphs)
    tb = batch_graphs(graphs, device="cpu")
    assert int(tb.edge_mask.sum()) < tb.n_edge  # padding edges: direction 0
    (u, d), (ju, jd) = geometry.edge_directions(tb), jgeo.edge_directions(jb)
    _close(u, ju)
    _close(d, jd)


@pytest.mark.parametrize("shape", [(11, 16), (11, 3, 16)])
def test_graph_layer_norm_matches_jax(shape):
    rs = np.random.RandomState(1)
    x = (rs.randn(*shape) * 3.0 + 1.0).astype(np.float32)
    x[0] = 0.0  # a row of zeros (a node whose v is still 0)
    jln = JGraphLayerNorm()
    params = _perturbed(jln.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    ln = params_from_jax(GraphLayerNorm(shape[-1]), params)
    _close(ln(torch.from_numpy(x)), jln.apply(params, jnp.asarray(x)))


def _layer_inputs(seed, units):
    graphs = _mols(seed, 4)
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    rs = np.random.RandomState(seed)
    n, e = tb.n_node, tb.n_edge
    arrays = dict(s=rs.randn(n, units), v=rs.randn(n, 3, units), rbf=rs.rand(e, 8),
                  env=rs.rand(e, 1), dir_ij=rs.randn(e, 3))
    arrays = {k: a.astype(np.float32) for k, a in arrays.items()}
    return jb, tb, arrays


def test_painn_conv_matches_jax():
    jb, tb, a = _layer_inputs(3, 16)
    args = [a[k] for k in ("s", "v", "rbf", "env", "dir_ij")]
    jconv = jpainn_conv.PAiNNconv(units=16, cutoff=5.0)
    params = _perturbed(jconv.init(jax.random.PRNGKey(0), jb, *map(jnp.asarray, args)), 4)
    conv = params_from_jax(painn_conv.PAiNNconv(16, 8, units=16, cutoff=5.0), params)
    ds, dv = conv(tb, *map(torch.from_numpy, args))
    jds, jdv = jconv.apply(params, jb, *map(jnp.asarray, args))
    _close(ds, jds)
    _close(dv, jdv)


def test_painn_update_matches_jax():
    jb, tb, a = _layer_inputs(5, 16)
    a["v"][:3] = 0.0  # |v_v| under the guard
    jupd = jpainn_conv.PAiNNUpdate(units=16)
    params = _perturbed(jupd.init(jax.random.PRNGKey(0), jb, a["s"], a["v"]), 6)
    upd = params_from_jax(painn_conv.PAiNNUpdate(16, units=16), params)
    ds, dv = upd(tb, torch.from_numpy(a["s"]), torch.from_numpy(a["v"]))
    jds, jdv = jupd.apply(params, jb, jnp.asarray(a["s"]), jnp.asarray(a["v"]))
    _close(ds, jds)
    _close(dv, jdv)


@pytest.mark.parametrize("method", ["zeros", "ones"])
def test_equivariant_initialize_matches_jax(method):
    s = np.random.RandomState(0).randn(5, 7).astype(np.float32)
    out = painn_conv.equivariant_initialize(torch.from_numpy(s), method=method, value=0.5)
    ref = jpainn_conv.equivariant_initialize(jnp.asarray(s), method=method, value=0.5)
    assert out.dtype == torch.float32 and out.shape == (5, 3, 7)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("norms", list(NORMS))
def test_energy_force_matches_jax(norms):
    kw = dict(SMALL, **NORMS[norms])
    graphs = _mols(0, 6)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(kw, jb, seed=1)
    ref = jm.apply(params, jb)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    _close(out["energy"], ref["energy"])
    _close(out["force"], ref["force"])


def test_default_width_model_matches_jax():
    """The bench width (128 units, 20 radial functions) at depth 1."""
    graphs = _mols(1, 3)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(dict(depth=1, conv_args={"units": 128, "cutoff": 5.0}), jb, seed=2)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    ref = jm.apply(params, jb)
    _close(out["energy"], ref["energy"])
    _close(out["force"], ref["force"])


def test_node_output_embedding_matches_jax():
    kw = dict(SMALL, output_embedding="node", node_normalization=True)
    graphs = _mols(4, 3)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(kw, jb, seed=3)
    out = tm.energy_model(batch_graphs(graphs, device="cpu"))["output"]
    ref = jm.energy_model.apply(params, jb)["output"]
    _close(out, ref)


def test_periodic_crystal_matches_jax():
    graphs = _crystals(2, 3)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(SMALL, jb, seed=4, crystal=True)
    ref = jm.apply(params, jb)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    _close(out["energy"], ref["energy"])
    _close(out["force"], ref["force"])


def test_rotation_invariance():
    """Energies unchanged and forces rotated with the molecule, as
    ``tests/test_models_potentials.py`` holds the JAX PAiNN."""
    g = _mols(8, 1)[0]
    theta = 0.7
    rot = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1]], dtype=np.float32)
    g2 = dict(g, node_coordinates=g["node_coordinates"] @ rot.T)
    fm = EnergyForceModel(painn.make_model(device="cpu", **SMALL), device="cpu")
    out1 = fm.apply(batch_graphs([g], device="cpu"))
    out2 = fm.apply(batch_graphs([g2], device="cpu"))
    np.testing.assert_allclose(out2["energy"][0].detach().numpy(),
                               out1["energy"][0].detach().numpy(), rtol=1e-5, atol=1e-5)
    n = len(g["node_number"])
    f1, f2 = out1["force"][:n].numpy(), out2["force"][:n].numpy()
    np.testing.assert_allclose(f2, f1 @ rot.T, rtol=1e-4, atol=1e-5 * np.abs(f1).max())


def test_forces_finite_on_tetrahedral_methane():
    """``tests/test_force_parity.py``'s perfectly tetrahedral CH4: the
    centre's equivariant features cancel to 0, and the norm guard keeps
    the forces finite, as in the JAX package."""
    ch4 = {"node_number": np.array([6, 1, 1, 1, 1], dtype=np.int64),
           "node_coordinates": np.array(
               [[0.0, 0.0, 0.0], [0.6291, 0.6291, 0.6291], [-0.6291, -0.6291, 0.6291],
                [-0.6291, 0.6291, -0.6291], [0.6291, -0.6291, -0.6291]], dtype=np.float32)}
    ch4["edge_indices"] = np.array([[i, j] for i in range(5) for j in range(5) if i != j])
    jb = jbatch_graphs([ch4])
    jm, params, tm = _shared(dict(depth=2), jb, seed=5)
    out = tm.apply(batch_graphs([ch4], device="cpu"), create_graph=True)
    assert torch.isfinite(out["force"]).all()
    ref = jm.apply(params, jb)
    _close(out["force"], ref["force"])
    (g,) = torch.autograd.grad(out["force"].square().sum(), tm.energy_model.update_1.lin_v.weight)
    assert torch.isfinite(g).all()


def test_predictor_matches_jax():
    graphs = _mols(5, 5)
    pre = functools.partial(jpre.set_range, max_distance=4.0, max_neighbours=25)
    tpre = functools.partial(set_range, max_distance=4.0, max_neighbours=25)
    frames = [{k: g[k] for k in ("node_number", "node_coordinates")} for g in graphs]
    jm, params, tm = _shared(SMALL, jbatch_graphs(graphs), seed=6)
    ref = JPredictor(model=jm, variables=params, graph_preprocessors=[pre])(frames)
    out = MolDynamicsModelPredictor(tm, graph_preprocessors=[tpre], device="cpu")(frames)
    assert len(out) == len(ref) == 5
    for o, f in zip(out, frames):
        assert o["force"].shape == (len(f["node_number"]), 3)
        assert np.abs(o["force"].sum(axis=0)).max() < 1e-4
    for key in ("energy", "force"):
        _close(np.concatenate([o[key] for o in out]), np.concatenate([r[key] for r in ref]))


def test_padding_leaves_real_outputs_unchanged():
    graphs = _mols(6, 4)
    tm = EnergyForceModel(painn.make_model(device="cpu", **dict(SMALL, **NORMS["both norms"])),
                          device="cpu")
    base = tm.apply(batch_graphs(graphs, device="cpu"))
    n_real = sum(len(g["node_number"]) for g in graphs)
    for pads in (dict(n_node_pad=256, n_edge_pad=1024), dict(n_node_pad=130, n_graph_pad=9)):
        out = tm.apply(batch_graphs(graphs, device="cpu", **pads))
        np.testing.assert_allclose(out["energy"][:4].detach().numpy(),
                                   base["energy"][:4].detach().numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["force"][:n_real].numpy(),
                                   base["force"][:n_real].numpy(), rtol=1e-5, atol=1e-7)
        assert not out["force"][n_real:].any()


def test_params_from_jax_carries_every_leaf():
    """Every flax leaf of a PAiNN with both norms finds its port parameter,
    and a model without the norms leaves the norms' leaves over."""
    graphs = _mols(9, 2)
    kw = dict(SMALL, **NORMS["both norms"])
    jm = jpainn.make_model(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jbatch_graphs(graphs)))
    assert "LayerNorm_0" in params["params"]["equiv_norm_1"]
    model = params_from_jax(painn.make_model(device="cpu", **kw), params)
    assert model.node_norm_0.scale.shape == (32,)
    with pytest.raises(KeyError, match="no port counterpart"):
        params_from_jax(painn.make_model(device="cpu", **SMALL), params)


# ------------------------------------------------------------ chip_smoke.py


def test_chip_smoke_painn_is_the_bench_configuration():
    from bench import bench_painn_model
    assert painn.make_model(device="cpu", **chip_smoke.PAINN_KW).config == \
        bench_painn_model().config


def test_kernel_calls_per_evaluation_are_the_derived_count():
    """One energy+force evaluation of the bench-width PAiNN on 3 molecules
    calls the segment-sum's wrapper as often as ``chip_smoke.PAINN_LAUNCHES``
    says that the card launches it, 7 times at 384 columns (phase 17 times
    the first), and each recorded call reproduces its plain version."""
    predictor = chip_smoke.make_painn_predictor("cpu")
    _, batch = predictor.make_batch(chip_smoke.qm9_like_mols(3, 3))
    with chip_smoke.captured_calls() as calls:
        predictor.model(batch)
    assert {k: len(v) for k, v in calls.items() if v} == {
        k: v for k, v in chip_smoke.PAINN_LAUNCHES.items() if v}
    widths = [args[0].shape[1] for args in calls["sorted_segment_sum"]]
    # each conv's dv pool, and the transposes of the phi (3U) and v gathers of convs 1-2
    assert widths.count(chip_smoke.PAINN_WIDE) == 3 + 2 * 2
    table = chip_smoke.kernel_wrappers()
    mod, attr, plain = table["sorted_segment_sum"]
    for args in calls["sorted_segment_sum"]:
        torch.testing.assert_close(getattr(mod, attr)(*args), plain(*args), rtol=0, atol=0)


# ------------------------------------------------------------ the bench training recipe


def _bench_recipe(n_mols):
    """``bench.py`` ``sec_painn``'s recipe on ``_mols(RandomState(4),
    n_mols)``: the JAX bench model with its init weights, the E + 100 F
    loss, and the port's model holding the same weights."""
    from bench import _mols, bench_painn_model
    graphs = _mols(np.random.RandomState(4), n_mols)
    jb = jbatch_graphs(graphs, global_keys=("energy",))
    tb = batch_graphs(graphs, global_keys=("energy",), device="cpu")
    jm = JEnergyForceModel(bench_painn_model())
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb)
    model = params_from_jax(painn.make_model(device="cpu", **chip_smoke.PAINN_KW),
                            jax.tree_util.tree_map(np.asarray, params))

    def jloss(p, b):
        out = jm.apply(p, b)
        return (jlosses.masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
                + 100.0 * jlosses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask))
    return jb, tb, params, jloss, model


def test_bench_recipe_spikes_at_its_second_step_in_both_packages():
    """Three Adam(1e-3) steps of the bench recipe on 32 molecules: the
    port's losses track the JAX package's, and in both the loss after the
    first update is above the first. Adam moves every weight by about the
    learning rate at once, and PAiNN's equivariant features are small at
    init (the force loss goes through 1/|v|), so the step overshoots:
    ``chip_smoke.py``'s ``painn_train`` holds no falling loss for it."""
    jb, tb, params, jloss, model = _bench_recipe(32)
    opt = optax.adam(1e-3)

    @jax.jit
    def jstep(p, s):
        loss, g = jax.value_and_grad(jloss)(p, jb)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss
    ref, p, s = [], params, opt.init(params)
    for _ in range(3):
        p, s, loss = jstep(p, s)
        ref.append(float(loss))
    trainer = Trainer(chip_smoke.ef_loss_fn(EnergyForceModel(model, device="cpu"), 100.0),
                      functools.partial(torch.optim.Adam, lr=1e-3))
    state, ours = trainer.init_state(model.parameters()), []
    for _ in range(3):
        state, metrics = trainer.step(state, tb)
        ours.append(metrics["loss"].item())
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    assert ours[1] > ours[0] and ref[1] > ref[0]


def test_float32_force_loss_gradients_as_accurate_as_jax():
    """The bench recipe's parameter gradients on 16 molecules in float32,
    each package against its own float64 run: in float64 the port equals
    the JAX package (to 1e-9 of each tensor's largest entry), and the
    port's float32 error is no larger than twice the JAX package's. Both
    are above 1e-5 of a tensor's largest entry: the force loss reaches
    the second derivative of |v|, which grows as 1/|v| on the small
    features of the init. ``chip_smoke.py``'s ``painn_train`` sets its gradient
    tolerance from this."""
    jb, tb, params, jloss, model = _bench_recipe(16)

    def to64(tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)
    j32 = jax.jit(jax.grad(jloss))(params, jb)
    with jax.enable_x64(True):
        b64 = jb.replace(nodes=to64(dict(jb.nodes)), edges=to64(dict(jb.edges)),
                         globals=to64(dict(jb.globals)))
        j64 = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(to64(params), b64))
    j32 = jax.tree_util.tree_map(lambda x: np.asarray(x, dtype=np.float64), j32)

    def port_grads(m, b):
        loss, _ = chip_smoke.ef_loss_fn(EnergyForceModel(m, device="cpu"), 100.0)(b)
        return [g.double().numpy() for g in torch.autograd.grad(loss, list(m.parameters()))]

    def as_port(tree):  # a flax gradient tree in the port's parameter order
        return [p.detach().double().numpy() for p in params_from_jax(
            painn.make_model(device="cpu", **chip_smoke.PAINN_KW).double(), tree).parameters()]
    t32 = port_grads(model, tb)
    t64 = port_grads(model.double(), tb.replace(
        nodes={k: v.double() if v.is_floating_point() else v for k, v in tb.nodes.items()},
        edges={k: v.double() if v.is_floating_point() else v for k, v in tb.edges.items()},
        globals={k: v.double() if v.is_floating_point() else v for k, v in tb.globals.items()}))

    def worst(a, b):
        return max(np.abs(x - y).max() / np.abs(y).max() for x, y in zip(a, b))
    j32, j64 = as_port(j32), as_port(j64)
    assert worst(t64, j64) <= 1e-9
    port_err, jax_err = worst(t32, t64), worst(j32, j64)
    print(f"float32 gradients against float64: port {port_err:.3g}, JAX {jax_err:.3g}")
    assert 1e-5 < jax_err and port_err <= 2 * jax_err, (port_err, jax_err)
