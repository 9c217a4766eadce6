"""The partitioned HDNNP4th of the port against the JAX package's, on the CPU.

The JAX side runs on its 8-device virtual CPU mesh (``tests/conftest.py``)
at D = 2 and 4 devices; the port's on D gloo ranks that
``parallel.launch.spawn`` starts once for each D, in the background while
JAX computes, their bodies in ``tests/torch_parallel_ranks.py`` (no JAX
there). The systems and the model are ``tests/test_partitioned_model.py``'s
(``_hdnnp_system``, 600 atoms, 240 for the flagship loss; ``_hdnnp_model``,
the CG to 1e-10), the weights JAX's, at that file's tolerances:

- the energy, forces and charges against JAX's partitioned run and the
  port's single-device dense-Qeq model, the charges summing to 0;
- one SGD(1.0) step of the energy loss against JAX's
  ``make_partitioned_train_step``, and of the flagship loss (50 q + 1 E +
  200 F) against JAX's dense-Qeq oracle (JAX's partitioned flagship step at
  2 devices can stop XLA:CPU: its CG's loop may take other rounds on each
  device), both against the port's oracle too, with no ACSF or SPD kernel
  wrapper called on a shard;
- ACSFG2 and ACSFG4 on a shard (G4 through the kernel's plain version and
  through the layer's own route) and their position gradients against
  JAX's layers on the same stacked batch;
- the row-sharded CG: ``solve_qeq_iterative_sharded`` against JAX's
  (``tests/test_qeq_solver.py``), its first and second derivatives and the
  row solve's tangent against the single-device ``_CGSolve``'s;
- the example's counterpart with ``--check``, and wACSF's raise.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.layers.conv.acsf import ACSFG2 as JACSFG2, ACSFG4 as JACSFG4
from gcnn_keras_tpu.layers.conv.qeq_solver import (
    solve_qeq_iterative_sharded as jsolve_sharded)
from gcnn_keras_tpu.parallel import mesh as jmesh, partitioned as jpart
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.models import hdnnp2nd, hdnnp4th
from gcnn_keras_tpu_torch.parallel import launch, partitioned as part
from gcnn_keras_tpu_torch.parallel.mesh import make_mesh
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from test_partitioned_model import _hdnnp_model, _hdnnp_system
from test_qeq_solver import _system as _qeq_system

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 300.0
DS = (2, 4)
E_TARGET = -2.0
W_FLAGSHIP = (1.0, 200.0, 50.0)  # w_e, w_f, w_q
STEPS = {"big": (("energy_step", 1.0, 0.0, 0.0),), "small": (("flagship_step",) + W_FLAGSHIP,)}
QTOT = 1.0


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _targets(rs, n):
    """``test_partitioned_hdnnp4th_flagship_loss_train_grads_match_oracle``'s
    force and charge targets, drawn after its system."""
    return ((rs.randn(n, 3) * 0.05).astype(np.float32),
            (rs.randn(n) * 0.05).astype(np.float32))


def _oracle_batch(g, esp, device=None):
    kw = dict(global_keys=("total_charge",))
    g = dict(g, esp=esp, total_charge=np.zeros(1, np.float32))
    return jbatch_graphs([g], **kw) if device is None else batch_graphs([g], device=device, **kw)


def _qeq_derivs_system():
    """A float64 system of 128 atoms (120 real) for the derivatives."""
    z, pos, mask, chi, sigma, hard = _qeq_system(m=128, n_real=120, seed=3)
    return tuple(a.astype(np.float64) if a.dtype != bool else a
                 for a in ((pos * 0.25), sigma, hard, chi, mask))


@pytest.fixture(scope="module")
def inputs():
    """The systems, JAX's model and weights, and each D's jobs."""
    out = {"jobs": {d: {} for d in DS}}
    for key, n in (("big", 600), ("small", 240)):
        g, z, pos, send, recv, angles, esp, rs = _hdnnp_system(n=n)
        out[key] = dict(g=g, system=(z, pos, send, recv, angles), esp=esp)
        if key == "small":
            out[key]["f_target"], out[key]["q_target"] = _targets(rs, n)
    model = _hdnnp_model("dense")
    ob = _oracle_batch(out["big"]["g"], out["big"]["esp"])
    # the JAX tests' weights: the init does not depend on the molecule
    out["variables"] = jax.jit(model.init)(jax.random.PRNGKey(0), ob)
    tree = _plain(out["variables"])
    z, pos, mask, chi, sigma, hard = _qeq_system(m=1024, n_real=1000)
    out["qeq"] = (pos, sigma, hard, chi, mask)
    for d in DS:
        for key in ("big", "small"):
            sysd = out[key]
            pin = part.prepare_partitioned(*sysd["system"][:4], d, angles=sysd["system"][4])
            sysd[("pin", d)] = pin
            out["jobs"][d][key] = ("hdnnp", dict(
                tree=tree, pin=pin, esp=sysd["esp"], e_target=E_TARGET,
                f_target=sysd.get("f_target"), q_target=sysd.get("q_target"),
                steps=STEPS[key]))
        out["jobs"][d]["acsf"] = ("acsf", dict(pin=out["big"][("pin", d)]))
        out["jobs"][d]["qeq_rows"] = ("qeq_rows", dict(system=out["qeq"], qtot=QTOT, tol=1e-8,
                                                       derivs=_qeq_derivs_system()))
    return out


@pytest.fixture(scope="module")
def rank_runs(inputs):
    """The D = 2 and D = 4 ranks, started together in the background."""
    pool = concurrent.futures.ThreadPoolExecutor(len(DS))
    runs = {d: pool.submit(launch.spawn, ranks.run_checks, d, inputs["jobs"][d], device="cpu",
                           threads=1, timeout_s=SPAWN_TIMEOUT_S) for d in DS}
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def rank_results(rank_runs, jax_side):
    return {d: run.result() for d, run in rank_runs.items()}


def _sharded(mesh, pin, esp=None):
    batch = jpart.build_partitioned_batch(
        pin, node_props=None if esp is None else {"esp": esp},
        global_props=None if esp is None else {"total_charge": np.zeros(1, np.float32)})
    sh = NamedSharding(mesh, P("data"))
    return jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), sh), batch), sh


def _jax_hdnnp(inputs, d):
    """JAX's partitioned run of the 600-atom molecule at D = d: energy,
    forces, charges (ORIGINAL order), and the energy step's gradient tree
    and metrics."""
    sysd, variables = inputs["big"], inputs["variables"]
    pin = jpart.prepare_partitioned(*sysd["system"][:4], d, angles=sysd["system"][4])
    mesh = jmesh.make_mesh(d)
    batch, sh = _sharded(mesh, pin, sysd["esp"])
    model = _hdnnp_model("auto")
    e, f = jpart.make_partitioned_energy_force(model, mesh)(variables, batch)

    def q_device(v, b):
        return model.apply(v, jax.tree.map(lambda x: x[0], b))["charge"][None]

    qfn = jax.jit(shard_map(q_device, mesh=mesh, in_specs=(P(), P("data")),
                            out_specs=P("data"), check_vma=False))
    out = {"energy": float(e), "force": jpart.unshard_node_array(pin, np.asarray(f)),
           "charge": jpart.unshard_node_array(pin, np.asarray(qfn(variables, batch)))}
    n = len(pin.order)
    for name, w_e, w_f, w_q in STEPS["big"]:
        tx = optax.sgd(1.0)
        step = jpart.make_partitioned_train_step(model, mesh, tx, w_energy=w_e, w_force=w_f,
                                                 w_charge=w_q)
        args = [jax.device_put(jnp.asarray(jpart.shard_node_array(pin, t)), sh)
                for t in (np.zeros((n, 3), np.float32), np.zeros(n, np.float32))]
        vp, _, metrics = step(variables, tx.init(variables), batch, E_TARGET, *args)
        out[name] = (_plain(jax.tree_util.tree_map(lambda a, b: a - b, variables, vp)),
                     {k: float(v) for k, v in metrics.items()})
    return out


def _jax_oracle_step(inputs, key):
    """The JAX dense-Qeq model's loss and gradients of each step of
    ``STEPS[key]`` on the whole molecule
    (``test_partitioned_hdnnp4th_flagship_loss_train_grads_match_oracle``'s
    oracle)."""
    sysd, variables = inputs[key], inputs["variables"]
    model = _hdnnp_model("dense")
    ob = _oracle_batch(sysd["g"], sysd["esp"])
    n = len(sysd["system"][0])
    f_pad, q_pad = np.zeros((ob.n_node, 3), np.float32), np.zeros(ob.n_node, np.float32)
    f_pad[:n], q_pad[:n] = sysd["f_target"], sysd["q_target"]
    out = {}
    for name, w_e, w_f, w_q in STEPS[key]:
        def loss(v):
            def e_fn(p):
                o = model.apply(v, ob.replace_nodes(node_coordinates=p))
                return o["output"][0, 0], o["charge"].reshape(-1)

            (e, q), gpos = jax.value_and_grad(e_fn, has_aux=True)(ob.nodes["node_coordinates"])
            m = ob.node_mask.astype(jnp.float32)
            df, dq = (-gpos - f_pad) * m[:, None], (q - q_pad) * m
            return (w_e * (e - E_TARGET) ** 2 + w_f * jnp.sum(df * df) / (jnp.sum(m) * 3.0)
                    + w_q * jnp.sum(dq * dq) / jnp.sum(m))

        value, grads = jax.jit(jax.value_and_grad(loss))(variables)
        out[name] = (_plain(grads), {"loss": float(value)})
    return out


def _jax_acsf(pin, d):
    """JAX's ACSF layers on the stacked batch at D = d, and the gradients of
    their outputs against the ranks' weights along the positions."""
    mesh = jmesh.make_mesh(d)
    batch, _ = _sharded(mesh, pin)
    kw = ranks.HDNNP_PART_KW
    layers = {"g2": JACSFG2(**JACSFG2.make_param_table(**kw["g2_kwargs"])),
              "g4": JACSFG4(**JACSFG4.make_param_table(**kw["g4_kwargs"]))}
    out = {}
    for name, layer in layers.items():
        def dev(p, b, layer=layer):
            lb = jax.tree.map(lambda x: x[0], b)
            return layer.apply({}, lb.replace_nodes(node_coordinates=p[0]))[None]

        fn = jax.jit(shard_map(dev, mesh=mesh, in_specs=(P("data"), P("data")),
                               out_specs=P("data"), check_vma=False))
        pos = batch.nodes["node_coordinates"]
        val = np.asarray(fn(pos, batch))
        w = jnp.asarray(torch.linspace(-1.0, 1.0, val[0].size).numpy()).reshape(val.shape[1:])
        grad = jax.jit(jax.grad(lambda p: jnp.sum(fn(p, batch) * w[None])))(pos)
        out[name], out[f"grad_{name}"] = val, np.asarray(grad)
    return out


def _port_oracle(inputs, key):
    """The port's HDNNP4th with a dense Qeq on the whole molecule: energy,
    forces, charges, and each step's loss and gradients."""
    sysd = inputs[key]
    kw = dict(ranks.HDNNP_PART_KW, electrostatic_kwargs={"param_trainable": False,
                                                         "solver": "dense"})
    model = params_from_jax(hdnnp4th.make_model_behler(device="cpu", **kw),
                            _plain(inputs["variables"]))
    ob = _oracle_batch(sysd["g"], sysd["esp"], device="cpu")
    n = len(sysd["system"][0])
    params = list(model.parameters())
    m = ob.node_mask.float()
    f_pad, q_pad = torch.zeros(ob.n_node, 3), torch.zeros(ob.n_node)
    if "f_target" in sysd:
        f_pad[:n], q_pad[:n] = torch.as_tensor(sysd["f_target"]), torch.as_tensor(sysd["q_target"])
    p = ob.nodes["node_coordinates"].clone().requires_grad_(True)
    out = model(ob.replace_nodes(node_coordinates=p))
    e, q = out["output"][0, 0], out["charge"].reshape(-1)
    (g,) = torch.autograd.grad(e, p, create_graph=True)
    res = {"energy": float(e.detach()), "force": -g.detach().numpy()[:n],
           "charge": q.detach().numpy()[:n]}
    for name, w_e, w_f, w_q in STEPS[key]:
        df, dq = (-g - f_pad) * m[:, None], (q - q_pad) * m
        loss = (w_e * (e - E_TARGET) ** 2 + w_f * (df * df).sum() / (m.sum() * 3.0)
                + w_q * (dq * dq).sum() / m.sum())
        grads = torch.autograd.grad(loss, params, retain_graph=True)
        res[name] = (dict(zip([k for k, _ in model.named_parameters()],
                              [t.numpy() for t in grads])), float(loss.detach()))
    return model, res


@pytest.fixture(scope="module")
def jax_side(inputs, rank_runs):
    """JAX's results and the port's oracles, while the ranks run."""
    out = {"oracle": {}}
    for key in ("big", "small"):
        out["model"], out["oracle"][key] = _port_oracle(inputs, key)
    for d in DS:
        out[("big", d)] = _jax_hdnnp(inputs, d)
    # the flagship step against JAX's dense-Qeq oracle: JAX's partitioned
    # step of it at 2 devices can stop XLA:CPU, its CG's loop taking other
    # rounds on each device (the JAX test runs it at 8)
    flagship = _jax_oracle_step(inputs, "small")
    for d in DS:
        out[("small", d)] = flagship
    for d in DS:
        out[("acsf", d)] = _jax_acsf(jpart.prepare_partitioned(
            *inputs["big"]["system"][:4], d, angles=inputs["big"]["system"][4]), d)
    pos, sig, hard, chi, mask = (jnp.asarray(a) for a in inputs["qeq"])
    out["qeq"] = {d: np.asarray(jsolve_sharded(pos, sig, hard, chi, jnp.float32(QTOT), mask,
                                               jmesh.make_mesh(d), tol=1e-8)) for d in DS}
    return out


def _grad_errors(names, got, ref):
    """Each gradient's largest difference over its tensor's largest entry."""
    return {n: np.abs(g - ref[n]).max() / max(float(np.abs(ref[n]).max()), 1e-8)
            for n, g in zip(names, got)}


@pytest.mark.parametrize("d", DS)
def test_partitioned_energy_forces_charges_match_jax_and_the_oracle(jax_side, rank_results, d):
    """``tests/test_partitioned_model.py``'s tolerances: energy rtol 1e-5,
    forces rtol 1e-3 / atol 1e-5, charges atol 5e-6 summing to 0 within
    1e-5, on every rank."""
    ref, oracle = jax_side[("big", d)], jax_side["oracle"]["big"]
    for res in rank_results[d]:
        got = res["big"]
        for r in (ref, oracle):
            np.testing.assert_allclose(got["energy"], r["energy"], rtol=1e-5)
            np.testing.assert_allclose(got["force"], r["force"], rtol=1e-3, atol=1e-5)
            np.testing.assert_allclose(got["charge"], r["charge"], atol=5e-6)
        assert abs(float(got["charge"].sum())) < 1e-5
        assert got["cg_rounds_per_solve"] > 0


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("key,name,tol", [("big", "energy_step", 1e-4),
                                          ("small", "flagship_step", 3e-4)])
def test_partitioned_train_step_grads_match_jax_and_the_oracle(jax_side, rank_results, d, key,
                                                               name, tol):
    """One SGD(1.0) step: the loss to rtol 1e-4, each gradient within
    ``tol`` of its tensor's largest entry (the JAX tests'), against JAX's
    (its partitioned step for the energy loss, its dense-Qeq oracle for the
    flagship loss) and the port's dense-Qeq oracle; equal on every
    rank."""
    g_tree, metrics = jax_side[(key, d)][name]
    model = jax_side["model"]
    names = [n for n, _ in model.named_parameters()]
    ref = {n: p.detach().numpy() for n, p in params_from_jax(model, g_tree).named_parameters()}
    oracle_grads, oracle_loss = jax_side["oracle"][key][name]
    for res in rank_results[d]:
        got = res[key][name]
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["metrics"]["loss"], oracle_loss, rtol=1e-4)
        for k in set(metrics) & {"energy", "force_loss", "charge_loss"}:
            np.testing.assert_allclose(got["metrics"][k], metrics[k], rtol=1e-4, atol=1e-7)
        for r in (ref, oracle_grads):
            errs = _grad_errors(names, got["grads"], r)
            assert max(errs.values()) < tol, errs
    first = rank_results[d][0][key][name]["grads"]
    for res in rank_results[d][1:]:
        assert all(np.array_equal(x, y) for x, y in zip(first, res[key][name]["grads"]))


@pytest.mark.parametrize("d", DS)
def test_no_acsf_or_spd_kernel_is_called_on_a_shard(rank_results, d):
    """The shards' ACSF layers take the plain route and the Qeq solve the
    row-sharded CG: of the kernel wrappers only the sorted segment-sum's
    (#1: the readout, the self and QM/MM energies, their transposes) is
    called."""
    for res in rank_results[d]:
        for key in ("big", "small", "acsf"):
            launches = res[key]["launches"]
            assert set(launches) <= {"sorted_segment_sum"}, launches
        assert res["big"]["launches"].get("sorted_segment_sum", 0) > 0
        assert res["acsf"]["reasons"][0] == "edge-partitioned batch"


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", ["g2", "g4", "g4_pairs"])
def test_acsf_on_a_shard_matches_jax(jax_side, rank_results, d, name):
    """The outputs (rtol 1e-5, atol 1e-6) and position gradients (rtol
    1e-4, atol 1e-5) of each rank's shard; ``g4`` is the G4 kernel's plain
    version, ``g4_pairs`` the layer's own route."""
    ref = jax_side[("acsf", d)]
    jname = "g4" if name == "g4_pairs" else name
    for r, res in enumerate(rank_results[d]):
        np.testing.assert_allclose(res["acsf"][name], ref[jname][r], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["acsf"][f"grad_{name}"], ref[f"grad_{jname}"][r],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", DS)
def test_row_sharded_qeq_matches_jax_and_the_single_device_cg(jax_side, rank_results, d):
    """``solve_qeq_iterative_sharded`` against JAX's (atol 5e-5, the total
    charge to 1e-4: ``tests/test_qeq_solver.py``); in float64 its charges,
    first derivatives (along pos, sigma, diag, chi) and second derivatives
    (of the position gradient, along every input) and the row solve's
    tangent against the single-device CG's, to 1e-8 of each tensor's
    largest entry."""
    ref = jax_side["qeq"][d]
    for res in rank_results[d]:
        got = res["qeq_rows"]
        np.testing.assert_allclose(got["q"], ref, atol=5e-5)
        assert abs(got["q"].sum() - QTOT) < 1e-4
        for a, b in zip(got["sharded"], got["single"]):
            assert np.abs(a - b).max() <= 1e-8 * max(np.abs(b).max(), 1.0)
        assert np.abs(got["jvp_rows"] - got["jvp_single"]).max() <= 1e-8 * np.abs(
            got["jvp_single"]).max()


def test_example_runs_and_checks():
    """``scripts/partitioned_giant_graph.py --check`` on a 2000-node chain
    over 2 CPU ranks, with one training step."""
    from gcnn_keras_tpu_torch.scripts import partitioned_giant_graph as ex
    out = ex.main(["--nodes", "2000", "--devices", "2", "--depth", "2", "--units", "16",
                   "--train-steps", "1", "--check", "--device", "cpu"])
    assert out["ok"] and out["ranks"] == 2 and out["halo_size"] > 0
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()


def test_wacsf_raises_on_a_shard():
    """wACSF reads no halo table in either package, so the port refuses a
    shard rather than index the wrong nodes (JAX's computes them): both
    layers, and HDNNP2nd's weighted model through them."""
    z, pos, send, recv, angles = _hdnnp_system(n=64)[1:6]
    pin = part.prepare_partitioned(z, pos, send, recv, 1, angles=angles)
    shard = part.rank_shard(pin, make_mesh(1, device="cpu"))
    model = hdnnp2nd.make_model(device="cpu")
    with pytest.raises(NotImplementedError, match="reads no halo table, as in the JAX package"):
        model(shard)
    for name, layer in (("wACSFRad", model.wacsf_rad), ("wACSFAng", model.wacsf_ang)):
        with pytest.raises(NotImplementedError, match=f"^{name} on an edge-partitioned batch"):
            layer(shard)
