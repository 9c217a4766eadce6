"""The port's ``parallel/`` against the JAX package's, on the CPU.

The JAX side runs on its 8-device virtual CPU mesh (``tests/conftest.py``)
at D devices; the port's on D gloo ranks that ``parallel.launch.spawn``
starts once for each D (2 and 4, module-scoped fixtures), their bodies in
``tests/torch_parallel_ranks.py`` (no JAX there). The checks:

- the host half (partition, halo encoding and fitting, the partitioned
  inputs with angles, the stacked batch, the host shards) bit for bit;
- the halo and all-gather aggregates and their transposes (1e-6);
- partitioned SchNet and PAiNN: energies and forces against JAX's
  ``run_partitioned_energy_force`` and the port's single-device model, one
  SGD(1.0) step's gradients against JAX's ``make_partitioned_train_step``,
  at the JAX tests' tolerances (``tests/test_partitioned_model.py``);
- two data-parallel SGD steps of SchNet and HDNNP4th against the JAX
  ``Trainer(mesh=make_mesh(2))`` (SGD: Adam on gradients that cancel to
  rounding differs by its learning rate, ``tests/test_torch_training.py``),
  the replicas' parameters equal bit for bit;
- replica MD, the sharded dense Qeq solve, ``train_force --n-devices 2``;
- the raises that remain.
"""
import concurrent.futures
import functools
import importlib.util
import json
import os
import subprocess
import sys

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
from gcnn_keras_tpu.models import hdnnp4th as jhdnnp4th, painn as jpainn, schnet as jschnet
from gcnn_keras_tpu.moldyn.trajectory import ScannedMD as JScannedMD
from gcnn_keras_tpu.parallel import data_parallel as jdp, distributed as jdist
from gcnn_keras_tpu.parallel import edge_partition as jep, mesh as jmesh
from gcnn_keras_tpu.parallel import partitioned as jpart
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu.training.trainer import Trainer as JTrainer
from gcnn_keras_tpu_torch.batch import GraphBatch
from gcnn_keras_tpu_torch.layers.aggr import pool_edges_to_nodes
from gcnn_keras_tpu_torch.models import hdnnp4th
from gcnn_keras_tpu_torch.parallel import distributed, edge_partition as ep, launch
from gcnn_keras_tpu_torch.parallel import partitioned as part
from gcnn_keras_tpu_torch.parallel.mesh import Mesh, make_mesh
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240.0
W_E, W_F, E_TARGET = 1.0, 10.0, -3.0
MD_KW = dict(dt=1e-3, segment_steps=10, max_distance=4.0, max_neighbours=25)
MD_ATOL = 1e-5
DP_LR = 1e-3


def _plain(tree):
    """A flax variables tree as nested dicts of numpy arrays (it pickles
    without flax)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _knn(pos, k):
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nn = np.argsort(d, axis=1)[:, :k]
    return nn.reshape(-1).astype(np.int64), np.repeat(np.arange(len(pos)), k).astype(np.int64)


def _system(n=512, seed=1, k=6, aspect=20.0):
    """``tests/test_partitioned_model.py``'s locality chain."""
    rs = np.random.RandomState(seed)
    pos = rs.rand(n, 3).astype(np.float32)
    pos[:, 0] *= aspect
    send, recv = _knn(pos, k)
    z = rs.choice([1, 6, 8], size=n).astype(np.int32)
    return z, pos, send, recv


def _random_system(n=512, seed=7):
    """``test_halo_fallback_never_clips``' graph without locality."""
    rs = np.random.RandomState(seed)
    pos = rs.rand(n, 3).astype(np.float32)
    recv = np.repeat(np.arange(n), 4).astype(np.int64)
    send = rs.randint(0, n, size=len(recv)).astype(np.int64)
    keep = send != recv
    z = rs.choice([1, 6, 8], size=n).astype(np.int32)
    return z, pos, send[keep], recv[keep]


def _angles(send, recv, n):
    """(i, j, k) triples: centre i with two of its neighbours."""
    nb = [[] for _ in range(n)]
    for s, r in zip(send, recv):
        nb[r].append(s)
    return np.array([(i, a, b) for i in range(n) for a in nb[i][:3] for b in nb[i][:3]
                     if a != b], dtype=np.int64)


JMAKE = {"schnet": lambda: jschnet.make_model(**ranks.SCHNET_KW),
         "schnet_fused": lambda: jschnet.make_model(**ranks.SCHNET_FUSED_KW),
         "painn": lambda: jpainn.make_model(**ranks.PAINN_KW),
         "md_schnet": lambda: jschnet.make_model(**ranks.MD_KW)}


def _jax_ef(model, variables, ob):
    def e_fn(p):
        return model.apply(variables, ob.replace_nodes(node_coordinates=p))["output"][0, 0]
    e, g = jax.value_and_grad(e_fn)(ob.nodes["node_coordinates"])
    return float(e), -np.asarray(g)


def _jax_dp_loss(jm, kind):
    wq, wf = ranks.DP_WEIGHTS[kind]

    def loss_fn(params, b):
        out = jm.apply(params, b, train=False)
        e = jlosses.masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
        f = jlosses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask)
        if wq:
            q = jlosses.masked_node_mae(out["charge"], b.nodes["charge"], b.node_mask)
            return wq * q + e + wf * f, {}
        return e + wf * f, {}
    return loss_fn


def _pads(graph_lists, kind):
    """Pads that give every batch one shape (the JAX mesh stacks them)."""
    bs = [jbatch_graphs(g, global_keys=ranks.DP_KEYS[kind], np_out=True) for g in graph_lists]
    pads = dict(n_node_pad=max(b.n_node for b in bs), n_edge_pad=max(b.n_edge for b in bs),
                max_nodes=max(b.max_nodes for b in bs))
    if bs[0].angles is not None:
        pads["n_angle_pad"] = max(b.angles.shape[0] for b in bs)
    return pads


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
        out["jobs"][2][f"dp_{kind}"] = ("dp", dict(kind=kind, tree=_plain(params),
                                                   graph_lists=graph_lists, pads=pads, lr=DP_LR))
    # replica MD: 4 molecules over 2 devices, 2 segments
    systems = _md_systems()
    md_model = JMAKE["md_schnet"]()
    md_vars = md_model.init(jax.random.PRNGKey(2), jbatch_graphs([_neighbours(systems[0])]))
    out["md"] = (systems, md_model, md_vars)
    out["jobs"][2]["md"] = ("md", dict(tree=_plain(md_vars), systems=systems, kw=MD_KW,
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
        out["jobs"][2][f"qeq_{spd}"] = ("qeq", dict(a=a, rhs=rhs))
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
    out["system"] = inputs["system"]
    out[("tree", "schnet")] = _plain(inputs[("model", "schnet")][1])
    out[("tree", "painn")] = _plain(inputs[("model", "painn")][1])
    out[("tree", "schnet_fused")] = out[("tree", "schnet")]
    return out


def _weights(f):
    """Fixed cotangent weights of an aggregate's output ``(D, N_loc, F)``:
    the ranks' ``torch.linspace`` over one shard's output."""
    return jnp.asarray(torch.linspace(-1.0, 1.0, f.size // f.shape[0]).numpy()
                       ).reshape(f.shape[1:])[None]


def _neighbours(system):
    from gcnn_keras_tpu.graph.preprocess import set_range
    g = set_range(dict(system), max_distance=4.0, max_neighbours=25)
    g["edge_indices"] = g.pop("range_indices")
    return g


def _md_systems(n_mols=4):
    """``tests/test_torch_moldyn.py``'s helical molecules."""
    systems = []
    for s in range(n_mols):
        rs = np.random.RandomState(s)
        n = 5 + s
        t = np.arange(n) * 1.2
        p = np.stack([t, 1.3 * np.sin(t), 1.3 * np.cos(t)], axis=1)
        systems.append({"node_number": rs.choice([1, 6, 7, 8], size=n),
                        "node_coordinates": (p + rs.randn(n, 3) * 0.05).astype(np.float32),
                        "velocities": (rs.randn(n, 3) * 0.05).astype(np.float32)})
    return systems


# ------------------------------------------------------------- host half


def _host_cases():
    z, pos, send, recv = _system()
    rz, rpos, rsend, rrecv = _random_system()
    return {"chain_d2": (z, pos, send, recv, 2, True, None),
            "chain_d4_angles": (z, pos, send, recv, 4, True, _angles(send, recv, len(z))),
            "chain_d8": (z, pos, send, recv, 8, True, None),
            "no_locality_d2": (rz, rpos, rsend, rrecv, 2, False, None),
            "no_locality_d4_angles": (rz, rpos, rsend, rrecv, 4, False,
                                      _angles(rsend, rrecv, len(rz)))}


@pytest.mark.parametrize("case", list(_host_cases()))
def test_partitioning_equals_jax_bit_for_bit(case):
    z, pos, send, recv, d, local, angles = _host_cases()[case]
    feats = pos.astype(np.float32)
    got, ref = (ep.partition_graph(feats, send, recv, d, locality_sort=local, positions=pos),
                jep.partition_graph(feats, send, recv, d, locality_sort=local, positions=pos))
    for key in ("node_feats", "senders_global", "receivers_local", "edge_mask", "node_mask",
                "order"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    assert got.n_local == ref.n_local
    assert ep.required_halo_size(got) == jep.required_halo_size(ref)
    assert part.fit_halo(got) == jpart.fit_halo(ref)
    for halo in (1, 64, part.fit_halo(got)):
        s, ok = ep.encode_halo_senders(got, halo, d)
        rs_, rok = jep.encode_halo_senders(ref, halo, d)
        np.testing.assert_array_equal(s, rs_)
        assert ok == rok
    pin = part.prepare_partitioned(z, pos, send, recv, d, locality_sort=local, angles=angles)
    rpin = jpart.prepare_partitioned(z, pos, send, recv, d, locality_sort=local, angles=angles)
    assert pin._fields == rpin._fields
    for key in pin._fields:
        a, b = getattr(pin, key), getattr(rpin, key)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key
    esp = np.random.RandomState(1).randn(len(z)).astype(np.float32)
    kw = dict(node_props={"esp": esp}, global_props={"total_charge": 1.0})
    got_b, ref_b = part.build_partitioned_batch(pin, **kw), jpart.build_partitioned_batch(rpin, **kw)
    for name in GraphBatch.__dataclass_fields__:
        a, b = getattr(got_b, name), getattr(ref_b, name)
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), name
            for k in b:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"{name}.{k}")
        elif b is None or isinstance(b, (int, str, bool)):
            assert a == b, name
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    f = np.random.RandomState(2).randn(len(z), 3).astype(np.float32)
    sh = part.shard_node_array(pin, f)
    np.testing.assert_array_equal(sh, jpart.shard_node_array(rpin, f))
    np.testing.assert_array_equal(part.unshard_node_array(pin, sh), f)


def test_host_shard_indices_equal_jax():
    for n, pi, pc, seed, drop in [(103, 0, 1, 0, True), (103, 1, 4, 3, True),
                                  (103, 3, 4, 3, False), (64, 1, 2, 42, True)]:
        np.testing.assert_array_equal(
            distributed.host_shard_indices(n, pi, pc, seed, drop),
            jdist.host_shard_indices(n, pi, pc, seed, drop))
    # one process: every index, in the seeded order
    np.testing.assert_array_equal(distributed.host_shard_indices(50, seed=7),
                                  jdist.host_shard_indices(50, seed=7))


def test_local_batch_iterator_equals_jax():
    """One host's loader (``host_shard_indices``, shuffled batches, groups
    of the local ranks) on a mesh of one: the JAX iterator's batches."""
    graphs = chip_smoke.labelled_mols(7, 13)
    ours = list(distributed.local_batch_iterator(graphs, 4, make_mesh(1, device="cpu"),
                                                 seed=3, global_keys=("energy",)))
    ref = list(jdist.local_batch_iterator(graphs, 4, jmesh.make_mesh(1), seed=3,
                                          global_keys=("energy",)))
    assert len(ours) == len(ref) == 3
    for b, jb in zip(ours, ref):
        for name in ("senders", "receivers", "graph_id", "node_mask"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(jb, name))[0])
        np.testing.assert_array_equal(b.nodes["node_coordinates"].numpy(),
                                      np.asarray(jb.nodes["node_coordinates"])[0])
        np.testing.assert_array_equal(b.globals["energy"].numpy(),
                                      np.asarray(jb.globals["energy"])[0])


def test_encode_halo_strict_raises_as_jax():
    rs = np.random.RandomState(9)
    pos = rs.rand(256, 3).astype(np.float32)
    recv = np.repeat(np.arange(256), 3).astype(np.int64)
    send = rs.randint(0, 256, size=len(recv)).astype(np.int64)
    got = ep.partition_graph(pos, send, recv, 8, locality_sort=False)
    assert ep.required_halo_size(got) == jep.required_halo_size(
        jep.partition_graph(pos, send, recv, 8, locality_sort=False)) == -1
    with pytest.raises(ValueError, match="does not cover"):
        ep.encode_halo_senders(got, 1, 8, strict=True)
    with pytest.raises(ValueError):
        jep.encode_halo_senders(jep.partition_graph(pos, send, recv, 8, locality_sort=False),
                                1, 8, strict=True)


# ------------------------------------------------------------- device half


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


def test_collectives_take_their_routes(rank_results):
    """CPU ranks over gloo: every collective direct, none staged; the
    halo's ring permutations and the readout's sums both ran."""
    for res in rank_results[2] + rank_results[4]:
        assert not res["transport"]["staged"]
        assert res["transport"]["direct"]["ppermute"] > 0
        assert res["transport"]["direct"]["all_reduce"] > 0


# ------------------------------------------------------------- the driver


def _score(path):
    for ext in (".yaml", ".json"):
        if os.path.exists(path + ext):
            with open(path + ext) as f:
                text = f.read()
            try:
                import yaml
                return yaml.safe_load(text)
            except ImportError:
                return json.loads(text)
    raise AssertionError(f"no score {path}")


def test_train_force_n_devices_matches_the_jax_driver(tmp_path, monkeypatch):
    """``python -m ...train_force --n-devices 2 --device cpu`` in one
    subprocess: 13 training frames in batches of 4 give one group of 2
    (the third batch dropped), so the epoch's loss is the first
    data-parallel step's. The JAX driver's ``--n-devices 2`` on the port's
    initial weights takes the same step."""
    argv = ["--frames", "16", "--batch-size", "4", "--epochs", "1", "--no-plots",
            "--n-devices", "2"]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the port's run in the background while the JAX driver runs here
    proc = subprocess.Popen([sys.executable, "-m", "gcnn_keras_tpu_torch.scripts.train_force",
                             *argv, "--device", "cpu"], cwd=port_dir, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        from gcnn_keras_tpu.model import force as jforce
        from gcnn_keras_tpu_torch.scripts import train_force
        port = train_force.build_model("Schnet", "cpu", torch.Generator().manual_seed(42))
        tree = _flax_tree(port.energy_model)
        monkeypatch.setattr(jforce.EnergyForceModel, "init", lambda self, *a, **kw: tree)
        spec = importlib.util.spec_from_file_location(
            "_jax_train_force_dp", os.path.join(ROOT, "training", "train_force.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        monkeypatch.chdir(jax_dir)
        monkeypatch.setattr(sys, "argv", ["train_force"] + argv)
        mod.main()
        ref = _score(str(jax_dir / "results" / "force" / "Schnet_score"))
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    got = _score(str(port_dir / "results" / "force" / "Schnet_score"))
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["energy_mae"], ref["energy_mae"], rtol=1e-5)
    np.testing.assert_allclose(got["force_mae"], ref["force_mae"], rtol=1e-5)


def _flax_tree(model):
    """The flax variables of a port model's weights."""
    from gcnn_keras_tpu_torch.utils import convert
    tree = {}
    for key, tensor, transposed in convert._flax_leaves(model):
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        value = tensor.detach().numpy()
        node[leaf] = jnp.asarray(value.T if transposed else value)
    return {"params": tree}


# ------------------------------------------------------------- the raises


def _one_rank_shard(angles=False):
    """A partitioned shard on a mesh of this process alone."""
    z, pos, send, recv = _system(n=64)
    ang = _angles(send, recv, 64) if angles else None
    pin = part.prepare_partitioned(z, pos, send, recv, 1, angles=ang)
    return part.rank_shard(pin, make_mesh(1, device="cpu"))


def test_partitioned_hdnnp4th_raises_naming_the_roadmap_item():
    shard = _one_rank_shard(angles=True)
    model = hdnnp4th.make_model_behler(device="cpu", **ranks.dp_kw("hdnnp4th"))
    with pytest.raises(NotImplementedError, match="'Parallel'"):
        model(shard)
    with pytest.raises(NotImplementedError, match="'Parallel'"):
        model.cent_electrostatic.cent_charge(shard, torch.zeros(shard.n_node, 1))


def test_partitioned_charge_loss_and_other_pools_raise():
    from gcnn_keras_tpu_torch.models import schnet
    shard = _one_rank_shard()
    mesh = shard.part_axis
    with pytest.raises(NotImplementedError, match="'Parallel'"):
        part.make_partitioned_train_step(schnet.make_model(device="cpu"), mesh,
                                         functools.partial(torch.optim.SGD, lr=1.0),
                                         w_charge=1.0)
    ev = torch.ones(shard.n_edge, 2)
    with pytest.raises(NotImplementedError, match="sum aggregation"):
        pool_edges_to_nodes(shard, ev, mode="mean")
    # the padding edges' messages are masked
    got = pool_edges_to_nodes(shard, ev)
    assert got.sum().item() == 2 * shard.edge_mask.sum().item()
    with pytest.raises(ValueError, match="accurate_cfconv"):
        schnet.make_model(device="cpu", interaction_args={"units": 16,
                                                          "accurate_cfconv": True},
                          depth=1)(shard)


def test_make_mesh_refuses_more_ranks_than_exist():
    with pytest.raises(ValueError, match=r"make_mesh\(n_devices=2\).*1 rank"):
        make_mesh(2, device="cpu")
    assert make_mesh(1, device="cpu").size == make_mesh(device="cpu").size == 1
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{have + 1} ranks need {have + 1} CUDA devices, "
                                         f"but this machine has {have}"):
        launch.rank_devices(have + 1, "cuda")


# ------------------------------------------------------------- a fault it found


def test_softplus_derivatives_stay_finite_as_jax():
    """The readout of a partitioned giant graph puts ``shifted_softplus``'s
    input near 200, where ``torch.logaddexp``'s second derivative is NaN:
    the values and first two derivatives against ``jax.nn.softplus``'s."""
    from gcnn_keras_tpu_torch.ops.activ import shifted_softplus, softplus
    x = np.concatenate([np.linspace(-300.0, 300.0, 6001), [0.0, 88.7, 89.0, 197.0, -197.0]]
                       ).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(softplus(t).sum(), t, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), t)
    jg = jax.vmap(jax.grad(jax.nn.softplus))
    jh = jax.vmap(jax.grad(jax.grad(jax.nn.softplus)))
    np.testing.assert_allclose(softplus(t).detach().numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg(x)), rtol=1e-6, atol=1e-7)
    assert np.isfinite(h.numpy()).all()
    # float32 rounding of two formulas for sigmoid(x) (1 - sigmoid(x)), at most 0.25
    np.testing.assert_allclose(h.numpy(), np.asarray(jh(x)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(shifted_softplus(t).detach().numpy(),
                               np.asarray(jax.nn.softplus(x)) - np.log(2.0),
                               rtol=1e-6, atol=1e-6)
