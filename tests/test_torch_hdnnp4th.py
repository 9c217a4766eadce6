"""The port's HDNNP4th charge+energy+force serving path against the JAX
package, on shared weights, on the CPU.

The JAX parameters come from ``init`` (or from the executed-kgcnn golden),
go through ``params_from_jax`` into the port, and both packages run the
same batch. Both compute in float32 and sum in different orders, and the
port solves the Qeq system by Gauss-Jordan where the JAX package factors it
by Cholesky off the TPU; energies, charges and forces agree to
``rtol 1e-5, atol 1e-6`` (measured: about 1e-7 of the largest value).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bench import _mols
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.layers.conv import hdnnp_electro as jelectro
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models import hdnnp4th as jhdnnp4th
from gcnn_keras_tpu.moldyn.base import MolDynamicsModelPredictor as JPredictor
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.graph.preprocess import set_angle
from gcnn_keras_tpu_torch.layers.conv import hdnnp_electro as electro
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import hdnnp4th
from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
from gcnn_keras_tpu_torch.ops.cuda import acsf as kacsf
from gcnn_keras_tpu_torch.ops.cuda import segment_sum as kseg
from gcnn_keras_tpu_torch.ops.cuda import spd_solve as kspd
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from tests.test_reference_parity import (
    _apply_mapping, _load, broadcast_relational, hdnnp4th_mapping)

torch.set_num_threads(1)

ELEMENTS = [1, 6, 7, 8, 9]
# the JAX package's flagship bench configuration (bench.py bench_hdnnp4th_model)
BENCH = dict(
    g2_kwargs={"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 4.0, "elements": ELEMENTS},
    g4_kwargs={"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "rc": 4.0,
               "zeta": [1.0, 8.0], "elements": ELEMENTS, "multiplicity": 2.0},
    mlp_charge_kwargs={"units": [64, 64, 1], "num_relations": 10,
                       "activation": ["swish", "swish", "linear"]},
    mlp_local_kwargs={"units": [64, 64, 1], "num_relations": 10,
                      "activation": ["swish", "swish", "linear"]},
    electrostatic_kwargs={"param_trainable": False})
RTOL, ATOL = 1e-5, 1e-6
GLOBALS = ("total_charge",)


def _graphs(seed, n_mols):
    """bench.py's flagship molecules (ESP, ESP gradient, angles) with total
    charges -1, 0, +1 in turn; the labels dropped."""
    graphs = _mols(np.random.RandomState(seed), n_mols, with_esp=True)
    for i, g in enumerate(graphs):
        for key in ("energy", "force", "charge"):
            g.pop(key)
        g["total_charge"] = np.array([float(i % 3 - 1)], np.float32)
    return graphs


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _shared(kw, jb, perturb_tables=False):
    """A JAX EnergyForceModel with ESP coupling and init params, and the
    port's model on the CPU holding the same weights."""
    jm = JEnergyForceModel(jhdnnp4th.make_model_behler(**kw), use_esp_coupling=True)
    params = _tree(jax.jit(lambda k, b: jm.init(k, b))(jax.random.PRNGKey(1), jb))
    if perturb_tables:
        rs = np.random.RandomState(7)
        cent = params["params"]["cent_electrostatic"]
        for leaf in ("hardness_j", "sigma"):
            cent["cent_charge"][leaf] = cent["cent_charge"][leaf] * (
                1.0 + 0.1 * rs.rand(97)).astype(np.float32)
        cent["electrostatic_energy"]["sigma"] = cent["electrostatic_energy"]["sigma"] * (
            1.0 + 0.1 * rs.rand(97)).astype(np.float32)
    tmodel = hdnnp4th.make_model_behler(device="cpu", **kw)
    params_from_jax(tmodel, params)
    return jm, params, EnergyForceModel(tmodel, use_esp_coupling=True, device="cpu")


def _close(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("extra,perturb", [
    ({}, False),
    ({"electrostatic_kwargs": {"param_trainable": True}}, True),
    ({"electrostatic_kwargs": {"param_trainable": False, "dense_impl": "lu"}}, False),
    ({"use_output_mlp": True, "energy_mean_and_var": [0.5, 4.0]}, False),
], ids=["bench", "trainable-tables", "lu", "output-mlp-scaled"])
def test_energy_charge_force_match_jax(extra, perturb):
    kw = dict(BENCH, **extra)
    graphs = _graphs(0, 8)
    jm, params, tm = _shared(kw, jbatch_graphs(graphs, global_keys=GLOBALS), perturb)
    ref = jm.apply(params, jbatch_graphs(graphs, global_keys=GLOBALS))
    before = (kseg.launches, kspd.launches, dict(kacsf.launches))
    out = tm.apply(batch_graphs(graphs, global_keys=GLOBALS, device="cpu"))
    assert (kseg.launches, kspd.launches, dict(kacsf.launches)) == before
    for key in ("energy", "charge", "force", "electrostatic_energy", "qmmm_energy"):
        _close(out[key], ref[key])


def test_predictor_matches_jax():
    graphs = _graphs(2, 6)
    frames = [{k: g[k] for k in ("node_number", "node_coordinates", "edge_indices",
                                 "esp", "esp_grad", "total_charge")} for g in graphs]
    jm, params, tm = _shared(BENCH, jbatch_graphs(graphs, global_keys=GLOBALS))
    jpres = [functools.partial(jpre.set_angle, range_indices="edge_indices")]
    tpres = [functools.partial(set_angle, range_indices="edge_indices")]
    ref = JPredictor(model=jm, variables=params, graph_preprocessors=jpres)(frames)
    out = MolDynamicsModelPredictor(tm, graph_preprocessors=tpres, device="cpu")(frames)
    assert len(out) == len(ref) == 6
    for o, f in zip(out, frames):
        n = len(f["node_number"])
        assert o["force"].shape == (n, 3) and o["charge"].shape == (n,)
        assert o["energy"].shape == (1,)
        # the Qeq constraint
        assert abs(o["charge"].sum() - f["total_charge"][0]) <= 1e-4 * (
            1 + np.abs(o["charge"]).sum())
    for key in ("energy", "charge", "force"):
        _close(np.concatenate([o[key] for o in out]),
               np.concatenate([r[key] for r in ref]))


def test_force_sum_is_zero_without_esp_gradient():
    """The ESP coupling force -(dE/dPhi_i) grad Phi_i is external: with
    grad Phi = 0 the forces of each molecule sum to 0."""
    graphs = _graphs(3, 4)
    for g in graphs:
        g["esp_grad"] = np.zeros_like(g["esp_grad"])
    tm = EnergyForceModel(hdnnp4th.make_model_behler(device="cpu", **BENCH),
                          use_esp_coupling=True, device="cpu")
    b = batch_graphs(graphs, global_keys=GLOBALS, device="cpu")
    force = tm.apply(b)["force"].detach()
    sums = torch.zeros(b.n_graphs, 3).index_add_(0, b.graph_id.long(), force)
    assert sums.abs().max().item() <= 1e-5 * force.abs().max().item() * 20


def test_padding_leaves_real_outputs_unchanged():
    graphs = _graphs(4, 4)
    tm = EnergyForceModel(hdnnp4th.make_model_behler(device="cpu", **BENCH),
                          use_esp_coupling=True, device="cpu")
    base = tm.apply(batch_graphs(graphs, global_keys=GLOBALS, device="cpu"))
    n_real = sum(len(g["node_number"]) for g in graphs)
    b = batch_graphs(graphs, global_keys=GLOBALS, device="cpu", n_node_pad=256,
                     n_edge_pad=2048, n_angle_pad=8192, n_graph_pad=9, max_nodes=30)
    out = tm.apply(b)
    np.testing.assert_allclose(out["energy"][:4].detach().numpy(),
                               base["energy"][:4].detach().numpy(), rtol=1e-6, atol=1e-7)
    for key in ("force", "charge"):
        np.testing.assert_allclose(out[key][:n_real].detach().numpy(),
                                   base[key][:n_real].detach().numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert not out[key][n_real:].detach().any()


# ------------------------------------------------------------ CENT charge

def _qeq_batches():
    """The graphs of tests/test_qeq_solver.py's kernel check."""
    rs = np.random.RandomState(1)
    rs.randn(5, 21, 21), rs.randn(5, 21, 2)  # that test's raw-kernel draws
    graphs = []
    for i in range(4):
        n = rs.randint(3, 9)
        g = {"node_number": rs.choice([1, 6, 8], size=n),
             "node_coordinates": (rs.randn(n, 3) * 2).astype(np.float32),
             "total_charge": np.array([float(i % 2)], dtype=np.float32)}
        g = jpre.set_range(g, max_distance=6.0, max_neighbours=12)
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(g)
    jb = jbatch_graphs(graphs, global_keys=GLOBALS)
    chi = rs.randn(jb.n_node).astype(np.float32)
    return jb, batch_graphs(graphs, global_keys=GLOBALS, device="cpu"), chi


def _jax_cent_orders(jb, chi, impl):
    chi = jnp.asarray(chi)

    def f(pos):
        layer = jelectro.CENTCharge(solver="dense", dense_impl=impl, param_trainable=False)
        params = layer.init(jax.random.PRNGKey(0), jb, chi)
        q = layer.apply(params, jb, chi, positions=pos)
        return jnp.sum(jnp.sin(q) * jb.node_mask), q

    pos0 = jb.nodes["node_coordinates"]
    q = f(pos0)[1]
    g = jax.grad(lambda p: f(p)[0])(pos0)
    h = jax.grad(lambda p: jnp.sum(jax.grad(lambda pp: f(pp)[0])(p) ** 2))(pos0)
    return np.asarray(q), np.asarray(g), np.asarray(h)


def _port_cent_orders(tb, chi, impl):
    layer = electro.CENTCharge(solver="dense", dense_impl=impl)
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    q = layer(tb, torch.from_numpy(chi), positions=pos)
    f = torch.sum(torch.sin(q) * tb.node_mask)
    (g,) = torch.autograd.grad(f, pos, create_graph=True)
    (h,) = torch.autograd.grad(torch.sum(g ** 2), pos)
    return q.detach().numpy(), g.detach().numpy(), h.numpy()


@pytest.mark.parametrize("impl,lanes", [("cholesky", "1"), ("cholesky", "0"), ("lu", None)],
                         ids=["jax-kernel", "jax-cholesky", "lu"])
def test_cent_charge_and_its_derivatives_match_jax(impl, lanes, monkeypatch):
    """Charges, d/dpos and grad-of-grad of sum(sin q), against the JAX
    Gauss-Jordan kernel (interpret mode), the JAX Cholesky path and the
    bordered LU; tolerances 5e-6 / 5e-6 / 5e-5 as tests/test_qeq_solver.py."""
    if lanes is not None:
        monkeypatch.setenv("GCNN_QEQ_LANES", lanes)
    jb, tb, chi = _qeq_batches()
    before = kspd.launches
    ours = _port_cent_orders(tb, chi, impl)
    assert kspd.launches == before
    ref = _jax_cent_orders(jb, chi, impl)
    for o, r, atol in zip(ours, ref, (5e-6, 5e-6, 5e-5)):
        np.testing.assert_allclose(o, r, rtol=0, atol=atol)
    q, mask = ours[0], tb.node_mask.numpy()
    gid = tb.graph_id.numpy()
    for i in range(4):
        np.testing.assert_allclose(q[(gid == i) & mask].sum(), float(i % 2), atol=1e-5)


def test_cent_charge_raises_on_what_is_not_ported():
    with pytest.raises(ValueError, match="dense_impl"):
        electro.CENTCharge(dense_impl="cholesky_typo")
    with pytest.raises(ValueError, match="solver"):
        electro.CENTCharge(solver="cg")
    _, tb, chi = _qeq_batches()
    electro.CENTCharge(solver="dense", iterative_threshold=4)(tb, torch.from_numpy(chi))


# ---------------------------------------------------------- electrostatics

def _electro_inputs():
    graphs = _graphs(5, 5)
    jb = jbatch_graphs(graphs, global_keys=GLOBALS)
    tb = batch_graphs(graphs, global_keys=GLOBALS, device="cpu")
    rs = np.random.RandomState(6)
    return jb, tb, (rs.randn(jb.n_node) * 0.3).astype(np.float32)


@pytest.mark.parametrize("table,trainable,physical", [
    (None, False, True), ("cent", False, True), (None, True, True), ("cent", False, False),
], ids=["angstrom", "bohr", "trainable", "random-table"])
def test_electrostatic_energy_matches_jax(table, trainable, physical):
    """Energies and their gradients by positions and charges."""
    jb, tb, q = _electro_inputs()
    sig = None if table is None else jelectro.CENT_RADII
    jl = jelectro.ElectrostaticEnergyGaussCharge(
        sigma_table=sig, param_trainable=trainable, use_physical_params=physical)
    params = _tree(jl.init(jax.random.PRNGKey(3), jb, jnp.asarray(q)))

    def jf(pos, qq):
        return jnp.sum(jl.apply(params, jb, qq, positions=pos) ** 2)

    pos0 = jb.nodes["node_coordinates"]
    ref = np.asarray(jl.apply(params, jb, jnp.asarray(q)))
    rg = jax.grad(jf, argnums=(0, 1))(pos0, jnp.asarray(q))
    tl = electro.ElectrostaticEnergyGaussCharge(
        sigma_table=None if table is None else electro.CENT_RADII,
        param_trainable=trainable, use_physical_params=physical)
    params_from_jax(tl, params)
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    tq = torch.from_numpy(q).requires_grad_(True)
    e = tl(tb, tq, positions=pos)
    _close(e, ref)
    grads = torch.autograd.grad(torch.sum(e ** 2), (pos, tq))
    for o, r in zip(grads, rg):
        _close(o, r)


def test_qmmm_energy_and_force_match_jax():
    jb, tb, q = _electro_inputs()
    esp, esp_grad = jb.nodes["esp"], jb.nodes["esp_grad"]
    _close(electro.electrostatic_qmmm_energy(tb, torch.from_numpy(q), tb.nodes["esp"]),
           jelectro.electrostatic_qmmm_energy(jb, jnp.asarray(q), esp))
    _close(electro.electrostatic_qmmm_force(torch.from_numpy(q), tb.nodes["esp_grad"]),
           jelectro.electrostatic_qmmm_force(jnp.asarray(q), esp_grad))


def test_cent_plus_electrostatics_matches_jax():
    """The fused layer passes the Bohr radii to its energy."""
    jb, tb, chi = _electro_inputs()
    jl = jelectro.CENTChargePlusElectrostaticEnergy()
    params = jl.init(jax.random.PRNGKey(0), jb, jnp.asarray(chi))
    rq, re = jl.apply(params, jb, jnp.asarray(chi))
    tl = electro.CENTChargePlusElectrostaticEnergy()
    assert torch.equal(tl.electrostatic_energy.sigma, torch.from_numpy(electro.CENT_RADII))
    q, e = tl(tb, torch.from_numpy(chi))
    _close(q, rq)
    _close(e, re)


def test_element_tables_are_the_jax_packages():
    for name in ("_COVALENT_RADII_PM", "CENT_RADII", "GAUSS_RADII", "CENT_HARDNESS"):
        ours, ref = getattr(electro, name), getattr(jelectro, name)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), name


# ------------------------------------------------------------ model variants

def _rep_learn_batches(seed):
    graphs = _graphs(seed, 5)
    return graphs, jbatch_graphs(graphs, global_keys=GLOBALS), \
        batch_graphs(graphs, global_keys=GLOBALS, device="cpu")


def test_rep_and_learn_models_match_jax():
    graphs, jb, tb = _rep_learn_batches(8)
    kw = {k: BENCH[k] for k in ("g2_kwargs", "g4_kwargs")}
    jrep = jhdnnp4th.make_model_rep(**kw)
    ref_rep = jrep.apply(jrep.init(jax.random.PRNGKey(0), jb), jb)["output"]
    rep_model = hdnnp4th.make_model_rep(device="cpu", **kw)
    assert not list(rep_model.parameters())
    rep = rep_model(tb)["output"]
    _close(rep, ref_rep)

    lkw = {k: BENCH[k] for k in ("mlp_charge_kwargs", "mlp_local_kwargs")}
    jlearn = jhdnnp4th.make_model_learn(**lkw)
    jbl = jb.replace_nodes(rep=ref_rep)
    params = _tree(jlearn.init(jax.random.PRNGKey(2), jbl))
    ref = jlearn.apply(params, jbl)
    learn = hdnnp4th.make_model_learn(device="cpu", rep_features=rep.shape[1], **lkw)
    params_from_jax(learn, params)
    out = learn(tb.replace_nodes(rep=rep.detach()))
    for key in ("output", "charge"):
        _close(out[key], ref[key])
    with pytest.raises(ValueError, match="rep_features"):
        learn(tb.replace_nodes(rep=rep.detach()[:, :-1]))


def test_charge_separat_models_match_jax():
    graphs, jb, tb = _rep_learn_batches(9)
    for jm, tm in zip(jhdnnp4th.make_model_behler_charge_separat(**BENCH),
                      hdnnp4th.make_model_behler_charge_separat(device="cpu", **BENCH)):
        params = _tree(jm.init(jax.random.PRNGKey(4), jb))
        params_from_jax(tm, params)
        ref, out = jm.apply(params, jb), tm(tb)
        for key in ("output", "charge"):
            _close(out[key], ref[key])
    assert out["output"].shape == (tb.n_graphs, 1)
    charge_model, _ = hdnnp4th.make_model_behler_charge_separat(device="cpu", **BENCH)
    assert charge_model(tb)["output"].shape == (tb.n_node,)


def test_golden_reference_energies_and_charges():
    """The executed-kgcnn golden: its weights mapped into the JAX params as
    tests/test_reference_parity.py maps them, carried across by
    params_from_jax; tolerances as that test's."""
    graphs, weights, ref_charge = _load("hdnnp4th")
    ref_energy = np.load("tests/assets/ref_golden_hdnnp4th.npz")["out1"]
    for g in graphs:
        g["node_number"] = g.pop("z").astype(np.int64)
        g["node_coordinates"] = g["xyz"]
    kw = dict(
        g2_kwargs={"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 10.0, "elements": [1, 6, 8]},
        g4_kwargs={"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "rc": 6.0,
                   "zeta": [1.0, 8.0], "elements": [1, 6, 8], "multiplicity": 2.0},
        normalize_kwargs={},
        mlp_charge_kwargs={"units": [32, 32, 1], "num_relations": 9,
                           "activation": ["swish", "swish", "linear"]},
        mlp_local_kwargs={"units": [32, 32, 1], "num_relations": 9,
                          "activation": ["swish", "swish", "linear"]})
    jb = jbatch_graphs(graphs, global_keys=GLOBALS)
    jm = jhdnnp4th.make_model_behler(**kw)
    mapping, bcast = hdnnp4th_mapping()
    params = _apply_mapping(jm.init(jax.random.PRNGKey(0), jb),
                            broadcast_relational(weights, bcast), mapping)
    tm = hdnnp4th.make_model_behler(device="cpu", **kw)
    params_from_jax(tm, _tree(params))
    tb = batch_graphs(graphs, global_keys=GLOBALS, device="cpu")
    out = tm(tb)
    np.testing.assert_allclose(out["output"][:len(graphs)].detach().numpy(), ref_energy,
                               rtol=1e-4, atol=5e-5)
    q, nm, gid = out["charge"].detach().numpy(), tb.node_mask.numpy(), tb.graph_id.numpy()
    for i, g in enumerate(graphs):
        np.testing.assert_allclose(q[nm & (gid == i)],
                                   ref_charge[i, :len(g["node_number"]), 0],
                                   rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("call", [
    lambda: hdnnp4th.make_model_behler(device="cpu", cent_kwargs={"tolerance": 1.0}),
    lambda: hdnnp4th.make_model_behler(
        device="cpu", electrostatic_kwargs={"dense_impl": "choleksy"}),
    lambda: hdnnp4th.make_model_learn(device="cpu", output_embedding="node"),
], ids=["unknown-key", "dense-impl-typo", "learn-embedding"])
def test_bad_options_raise(call):
    with pytest.raises(ValueError):
        call()


def test_params_from_jax_carries_the_tables_exactly():
    """Table leaves left over, or missing, raise."""
    graphs = _graphs(10, 2)
    jb = jbatch_graphs(graphs, global_keys=GLOBALS)
    trainable = dict(BENCH, electrostatic_kwargs={"param_trainable": True})
    jm = jhdnnp4th.make_model_behler(**trainable)
    tree = _tree(jm.init(jax.random.PRNGKey(0), jb))
    tm = params_from_jax(hdnnp4th.make_model_behler(device="cpu", **trainable), tree)
    cent = tree["params"]["cent_electrostatic"]
    assert torch.equal(tm.cent_electrostatic.cent_charge.hardness_j,
                       torch.tensor(cent["cent_charge"]["hardness_j"]))
    assert torch.equal(tm.cent_electrostatic.electrostatic_energy.sigma,
                       torch.tensor(cent["electrostatic_energy"]["sigma"]))
    with pytest.raises(KeyError):  # the tables are left over
        params_from_jax(hdnnp4th.make_model_behler(device="cpu", **BENCH), tree)
    plain = _tree(jhdnnp4th.make_model_behler(**BENCH).init(jax.random.PRNGKey(0), jb))
    with pytest.raises(KeyError):  # the tables are missing
        params_from_jax(hdnnp4th.make_model_behler(device="cpu", **trainable), plain)


def test_make_model_seeded_generator_is_deterministic():
    a = hdnnp4th.make_model_behler(device="cpu", generator=torch.Generator().manual_seed(3),
                                   **BENCH)
    b = hdnnp4th.make_model_behler(device="cpu", generator=torch.Generator().manual_seed(3),
                                   **BENCH)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert [n for n, _ in a.named_parameters()] == [
        f"{mlp}.rel_dense_{i}.{p}" for mlp in ("mlp_charge", "mlp_local")
        for i in range(3) for p in ("kernel", "bias")]
