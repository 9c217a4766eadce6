"""The port's partitioned models against the JAX package's, on gloo ranks:
the halo and all-gather aggregates and their transposes (1e-6), and the
partitioned SchNet and PAiNN (energies and forces against JAX's
``run_partitioned_energy_force`` and the port's single-device model, one
SGD(1.0) step's gradients against JAX's ``make_partitioned_train_step``, at
``tests/test_partitioned_model.py``'s tolerances), the all-gather fallback
and the collectives' routes. The JAX side runs on its virtual CPU mesh at D
devices, the port's on D ranks that one ``launch.spawn`` starts for each D
(2 and 4) in the background while JAX computes (the rank side:
``tests/torch_parallel_ranks.py``; the shared helpers:
``tests/test_torch_parallel.py``)."""
import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_parallel_ranks as ranks
from gcnn_keras_tpu.parallel import edge_partition as jep, mesh as jmesh
from gcnn_keras_tpu.parallel import partitioned as jpart
from gcnn_keras_tpu_torch.parallel import edge_partition as ep, launch
from gcnn_keras_tpu_torch.parallel import partitioned as part
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from test_torch_parallel import (E_TARGET, JMAKE, SPAWN_TIMEOUT_S, W_E, W_F, _jax_ef, _plain,
                                 _random_system, _system, _weights)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs():
    """The systems, the JAX models and their weights, and each D's jobs for
    the ranks."""
    z, pos, send, recv = _system()
    n = len(z)
    out = {"system": (z, pos, send, recv), "jobs": {2: {}, 4: {}},
           "f_target": np.random.RandomState(5).randn(n, 3).astype(np.float32) * 0.1,
           "feats": np.random.RandomState(3).randn(n, 8).astype(np.float32)}
    for d in (2, 4):
        p = ep.partition_graph(out["feats"], send, recv, d, positions=pos)
        halo = part.fit_halo(p)
        sidx, ok = ep.encode_halo_senders(p, halo, d)
        assert halo > 0 and ok
        out["jobs"][d]["aggregate"] = ("aggregate", dict(part=p, sidx=sidx, halo=halo))
    ob = jpart.single_graph_batch(z, pos, send, recv)
    for kind in ("schnet", "painn"):
        model = JMAKE[kind]()
        out[("model", kind)] = (model, model.init(jax.random.PRNGKey(0), ob))
        for d in (2, 4):
            out["jobs"][d][kind] = ("partitioned", dict(
                kind=kind, tree=_plain(out[("model", kind)][1]),
                pin=part.prepare_partitioned(z, pos, send, recv, d),
                f_target=out["f_target"], e_target=E_TARGET, w_e=W_E, w_f=W_F))
    # the fused SchNet (its weights are the unfused one's) at D = 2
    out[("model", "schnet_fused")] = (JMAKE["schnet_fused"](), out[("model", "schnet")][1])
    out["jobs"][2]["schnet_fused"] = ("partitioned", dict(
        out["jobs"][2]["schnet"][1], kind="schnet_fused"))
    # the all-gather fallback
    rsys = _random_system()
    model = JMAKE["schnet"]()
    out["fallback"] = (rsys, model, model.init(jax.random.PRNGKey(2),
                                               jpart.single_graph_batch(*rsys)))
    out["jobs"][2]["fallback"] = ("partitioned", dict(
        kind="schnet", tree=_plain(out["fallback"][2]),
        pin=part.prepare_partitioned(*rsys, 2, locality_sort=False)))
    return out


@pytest.fixture(scope="module")
def rank_runs(inputs):
    """The D = 2 and D = 4 ranks, started together in the background (one
    spawn of D gloo ranks each) while the JAX side computes."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    runs = {d: pool.submit(launch.spawn, ranks.run_checks, d, inputs["jobs"][d], device="cpu",
                           threads=1, timeout_s=SPAWN_TIMEOUT_S) for d in (2, 4)}
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def rank_results(rank_runs, jax_side):
    """``{D: [each rank's results]}``."""
    return {d: run.result() for d, run in rank_runs.items()}


@pytest.fixture(scope="module")
def jax_side(inputs, rank_runs):
    """The JAX package's results on the same inputs."""
    z, pos, send, recv = inputs["system"]
    f_target = inputs["f_target"]
    out = {}
    for d in (2, 4):
        jm = jmesh.make_mesh(d)
        p = jep.partition_graph(inputs["feats"], send, recv, d, positions=pos)
        halo = jpart.fit_halo(p)
        sidx, _ = jep.encode_halo_senders(p, halo, d)
        jh, ja = jep.make_halo_aggregate(jm, halo), jep.make_partitioned_aggregate(jm)
        rest_h = (sidx, p.receivers_local, p.edge_mask)
        rest_a = (p.senders_global, p.receivers_local, p.edge_mask)
        feats = jnp.asarray(p.node_feats)
        out[("aggregate", d)] = {
            "halo": np.asarray(jh(feats, *rest_h)),
            "all_gather": np.asarray(ja(feats, *rest_a)),
            "grad_halo": np.asarray(jax.grad(
                lambda f: jnp.sum(jh(f, *rest_h) * _weights(f)))(feats)),
            "grad_all_gather": np.asarray(jax.grad(
                lambda f: jnp.sum(ja(f, *rest_a) * _weights(f)))(feats))}
    ob = jpart.single_graph_batch(z, pos, send, recv)
    for kind in ("schnet", "painn", "schnet_fused"):
        model, variables = inputs[("model", kind)]
        out[("oracle", kind)] = _jax_ef(model, variables, ob)
        for d in ((2,) if kind == "schnet_fused" else (2, 4)):
            jm = jmesh.make_mesh(d)
            pin = jpart.prepare_partitioned(z, pos, send, recv, d)
            out[("energy_force", kind, d)] = jpart.run_partitioned_energy_force(
                model, variables, pin, jm)
            tx = optax.sgd(1.0)
            step = jpart.make_partitioned_train_step(model, jm, tx, w_energy=W_E, w_force=W_F)
            vp, _, metrics = step(variables, tx.init(variables), jpart.build_partitioned_batch(pin),
                                  E_TARGET, jnp.asarray(jpart.shard_node_array(pin, f_target)))
            out[("step", kind, d)] = (
                _plain(jax.tree_util.tree_map(lambda a, b: a - b, variables, vp)),
                float(metrics["loss"]))
    rsys, model, variables = inputs["fallback"]
    rpin = jpart.prepare_partitioned(*rsys, 2, locality_sort=False)
    assert rpin.halo_size == 0
    out["fallback"] = (jpart.run_partitioned_energy_force(model, variables, rpin,
                                                          jmesh.make_mesh(2)),
                       _jax_ef(model, variables, jpart.single_graph_batch(*rsys)))
    out["system"] = inputs["system"]
    out[("tree", "schnet")] = _plain(inputs[("model", "schnet")][1])
    out[("tree", "painn")] = _plain(inputs[("model", "painn")][1])
    out[("tree", "schnet_fused")] = out[("tree", "schnet")]
    return out


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("key", ["halo", "all_gather", "grad_halo", "grad_all_gather"])
def test_aggregates_match_jax(jax_side, rank_results, d, key):
    ref = jax_side[("aggregate", d)][key]
    for r, res in enumerate(rank_results[d]):
        np.testing.assert_allclose(res["aggregate"][key], ref[r], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,d", [("schnet", 2), ("schnet", 4), ("painn", 2), ("painn", 4),
                                    ("schnet_fused", 2)])
def test_partitioned_energy_forces_match_jax_and_the_oracle(jax_side, rank_results, kind, d):
    """``tests/test_partitioned_model.py``'s tolerances, against JAX's
    partitioned function and the port's model on the whole graph.
    ``schnet_fused`` is SchNet with ``fused_aggregate=True``, which the
    shards take unfused and the whole graph fused."""
    z, pos, send, recv = jax_side["system"]
    n = len(z)
    e_ref, f_ref = jax_side[("energy_force", kind, d)]
    oracle = ranks.port_model(kind, jax_side[("tree", kind)])
    ob = part.single_graph_batch(z, pos, send, recv, device="cpu")
    p = ob.nodes["node_coordinates"].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(oracle(ob.replace_nodes(node_coordinates=p))["output"][0, 0], p)
    for res in rank_results[d]:
        e, f = res[kind]["energy"], res[kind]["force"]
        np.testing.assert_allclose(e, e_ref, rtol=2e-5)
        np.testing.assert_allclose(f, f_ref, rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(e, jax_side[("oracle", kind)][0], rtol=2e-5)
        np.testing.assert_allclose(f, -g.numpy()[:n], rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("kind,d", [("schnet", 2), ("schnet", 4), ("painn", 2), ("painn", 4),
                                    ("schnet_fused", 2)])
def test_partitioned_train_step_grads_match_jax(jax_side, rank_results, kind, d):
    """One SGD(1.0) step: the loss within 1e-5 and each gradient within
    1e-4 of its tensor's largest entry (the JAX test's), on every rank."""
    g_tree, loss_ref = jax_side[("step", kind, d)]
    ref = dict(params_from_jax(ranks.port_model(kind, jax_side[("tree", kind)]),
                               g_tree).named_parameters())
    names = [n for n, _ in ranks.port_model(kind, jax_side[("tree", kind)]).named_parameters()]
    for res in rank_results[d]:
        np.testing.assert_allclose(res[kind]["loss"], loss_ref, rtol=1e-5)
        assert len(res[kind]["grads"]) == len(names)
        for name, g in zip(names, res[kind]["grads"]):
            r = ref[name].detach().numpy()
            scale = max(float(np.abs(r).max()), 1e-8)
            assert np.abs(g - r).max() / scale < 1e-4, name
    first = rank_results[d][0][kind]["grads"]
    for res in rank_results[d][1:]:
        assert all(np.array_equal(x, y) for x, y in zip(first, res[kind]["grads"]))


def test_halo_fallback_matches_jax(jax_side, rank_results):
    (e_jax, f_jax), (e_or, f_or) = jax_side["fallback"]
    for res in rank_results[2]:
        e, f = res["fallback"]["energy"], res["fallback"]["force"]
        np.testing.assert_allclose(e, e_jax, rtol=2e-5)
        np.testing.assert_allclose(f, f_jax, rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(e, e_or, rtol=2e-5)
        np.testing.assert_allclose(f, f_or[:len(f)], rtol=1e-4, atol=2e-5)



def test_collectives_take_their_routes(rank_results):
    """CPU ranks over gloo: every collective direct, none staged; the
    halo's ring permutations and the readout's sums both ran."""
    for res in rank_results[2] + rank_results[4]:
        assert not res["transport"]["staged"]
        assert res["transport"]["direct"]["ppermute"] > 0
        assert res["transport"]["direct"]["all_reduce"] > 0

