"""The port's data parallelism, replica MD and G-sharded dense Qeq solve
against the JAX package's, on 2 gloo ranks that one ``launch.spawn`` starts
in the background while JAX computes (the rank side:
``tests/torch_parallel_ranks.py``; the shared helpers:
``tests/test_torch_parallel.py``): two data-parallel SGD steps of SchNet and
HDNNP4th against the JAX ``Trainer(mesh=make_mesh(2))`` (SGD: Adam on
gradients that cancel to rounding differs by its learning rate,
``tests/test_torch_training.py``), the replicas' parameters equal bit for
bit; ``run_ensemble(n_devices=2)``; ``solve_qeq_batch_sharded``."""
import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
import torch_parallel_ranks as ranks
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.layers.conv.qeq_solver import solve_qeq_batch_sharded as jsolve_sharded
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models import hdnnp4th as jhdnnp4th, schnet as jschnet
from gcnn_keras_tpu.moldyn.trajectory import ScannedMD as JScannedMD
from gcnn_keras_tpu.parallel import data_parallel as jdp, mesh as jmesh
from gcnn_keras_tpu.training.trainer import Trainer as JTrainer
from gcnn_keras_tpu_torch.parallel import launch
from gcnn_keras_tpu_torch.parallel.mesh import Mesh
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from test_torch_parallel import (DP_LR, JMAKE, MD_ATOL, MD_KW, SPAWN_TIMEOUT_S, _jax_dp_loss,
                                 _md_systems, _neighbours, _pads, _plain)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs():
    """The batches, models and weights, and the jobs of the 2 ranks."""
    out = {"jobs": {}}
    # data parallelism: 2 steps of 2 batches
    for kind in ("schnet", "hdnnp4th"):
        esp = kind == "hdnnp4th"
        graph_lists = [chip_smoke.labelled_mols(30 + i, 3, with_esp=esp) for i in range(4)]
        pads = _pads(graph_lists, kind)
        jbs = [jbatch_graphs(g, global_keys=ranks.DP_KEYS[kind], **pads) for g in graph_lists]
        make = jschnet.make_model if kind == "schnet" else jhdnnp4th.make_model_behler
        jm = JEnergyForceModel(make(**ranks.dp_kw(kind)), use_esp_coupling=esp)
        params = jax.jit(lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(3), jbs[0])
        out[("dp", kind)] = (jm, params, jbs)
        out["jobs"][f"dp_{kind}"] = ("dp", dict(kind=kind, tree=_plain(params),
                                                graph_lists=graph_lists, pads=pads, lr=DP_LR))
    # replica MD: 4 molecules over 2 devices, 2 segments
    systems = _md_systems()
    md_model = JMAKE["md_schnet"]()
    md_vars = md_model.init(jax.random.PRNGKey(2), jbatch_graphs([_neighbours(systems[0])]))
    out["md"] = (systems, md_model, md_vars)
    out["jobs"]["md"] = ("md", dict(tree=_plain(md_vars), systems=systems, kw=MD_KW,
                                    n_segments=2))
    # the G-sharded dense Qeq solve, of symmetric positive definite systems
    # (Qeq's) and of general ones
    rs = np.random.RandomState(4)
    m_ = rs.randn(8, 12, 12).astype(np.float32)
    eye = 12 * np.eye(12, dtype=np.float32)
    rhs = rs.randn(8, 12).astype(np.float32)
    for spd, a in ((True, (m_ @ m_.transpose(0, 2, 1) + eye).astype(np.float32)),
                   (False, (m_ + eye).astype(np.float32))):
        out[("qeq", spd)] = (a, rhs)
        out["jobs"][f"qeq_{spd}"] = ("qeq", dict(a=a, rhs=rhs))
    return out


@pytest.fixture(scope="module")
def rank_runs(inputs):
    """The 2 ranks, started in the background while the JAX side computes."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    runs = {2: pool.submit(launch.spawn, ranks.run_checks, 2, inputs["jobs"], device="cpu",
                           threads=1, timeout_s=SPAWN_TIMEOUT_S)}
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def rank_results(rank_runs, jax_side):
    """``{2: [each rank's results]}``."""
    return {d: run.result() for d, run in rank_runs.items()}


@pytest.fixture(scope="module")
def jax_side(inputs, rank_runs):
    """The JAX package's results on the same inputs."""
    out = {}
    for kind in ("schnet", "hdnnp4th"):
        jm, params, jbs = inputs[("dp", kind)]
        mesh2 = jmesh.make_mesh(2)
        jtr = JTrainer(_jax_dp_loss(jm, kind), optax.sgd(DP_LR), mesh=mesh2)
        jstate = jtr.init_state(jax.tree_util.tree_map(jnp.asarray, params))
        losses = []
        for stacked in jdp.dp_batch_iterator(jbs, mesh2):
            jstate, m = jtr.step_fn()(jstate, stacked)
            losses.append(float(m["loss"]))
        out[("dp", kind)] = (losses, _plain(jstate.params), _plain(params))
    systems, md_model, md_vars = inputs["md"]
    out["md"] = JScannedMD(md_model, md_vars, **MD_KW).run_ensemble(systems, 2, n_devices=2)
    for spd in (False, True):
        a, rhs = inputs[("qeq", spd)]
        out[("qeq", spd)] = (np.asarray(jsolve_sharded(jnp.asarray(a), jnp.asarray(rhs),
                                                       jmesh.make_mesh(2))), a, rhs)
    return out


@pytest.mark.parametrize("kind", ["schnet", "hdnnp4th"])
def test_dp_trainer_steps_match_jax(jax_side, rank_results, kind):
    """Two SGD steps on 2 ranks against the JAX ``Trainer`` on a 2-device
    mesh: each step's loss (rtol 1e-5) and the parameters after (rtol 1e-5,
    atol 1e-6, ``tests/test_torch_training.py``'s), equal on both ranks
    though rank 1 built its replica with other weights."""
    losses, jparams, tree = jax_side[("dp", kind)]
    ref = dict(params_from_jax(ranks.port_model(f"dp_{kind}", tree), jparams).named_parameters())
    results = [res[f"dp_{kind}"] for res in rank_results[2]]
    for res in results:
        assert len(res["losses"]) == 2
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        for name, p in zip(res["names"], res["params"]):
            np.testing.assert_allclose(p, ref[name].detach().numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    a, b = results
    assert a["losses"] == b["losses"]
    assert all(np.array_equal(x, y) for x, y in zip(a["params"], b["params"]))
    # make_dp_eval_step: every rank's outputs, gathered in rank order
    for res in results:
        assert res["eval_gathered"].shape == (2,) + a["eval_own"].shape
        for r, own in enumerate(results):
            np.testing.assert_array_equal(res["eval_gathered"][r], own["eval_own"])


def test_replica_md_matches_jax(jax_side, rank_results):
    """``run_ensemble(n_devices=2)``, velocity Verlet: 4 molecules, 2
    segments of 10 steps, every rank holding every replica's result."""
    ref = jax_side["md"]
    for res in rank_results[2]:
        md = res["md"]
        assert md["edge_counts"] == ref["edge_counts"]
        for key in ("e_pot", "e_kin"):
            assert md[key].shape == ref[key].shape == (20, 4)
            np.testing.assert_allclose(md[key], ref[key], rtol=0, atol=MD_ATOL)
        for p, r in zip(md["pos"], ref["pos"]):
            np.testing.assert_allclose(p, r, rtol=0, atol=MD_ATOL)


@pytest.mark.parametrize("spd", [False, True])
def test_qeq_batch_sharded_matches_jax(jax_side, rank_results, spd):
    """Symmetric positive definite systems (``spd``) and general ones."""
    ref, a, rhs = jax_side[("qeq", spd)]
    for res in rank_results[2]:
        np.testing.assert_allclose(res[f"qeq_{spd}"], ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        from gcnn_keras_tpu_torch.layers.conv.qeq_solver import solve_qeq_batch_sharded
        solve_qeq_batch_sharded(torch.as_tensor(a[:3]), torch.as_tensor(rhs[:3]),
                                Mesh(2, 0, "cpu", "gloo"))

