"""The port's ``parallel/`` against the JAX package's, on the CPU: the host
half and what needs no ranks. The device half is in
``tests/test_torch_parallel_models.py`` (the aggregates and the partitioned
SchNet and PAiNN, D = 2 and 4) and ``tests/test_torch_parallel_dp.py`` (data
parallelism, replica MD, the sharded dense Qeq, D = 2): each file starts
its own ranks (one ``launch.spawn`` per D), so that the tier-1 run's
workers take them apart. This file holds the helpers they share. The
checks here:

- the host half (partition, halo encoding and fitting, the partitioned
  inputs with angles, the stacked batch, the host shards) bit for bit;
- ``train_force --n-devices 2`` in a subprocess of its own (2 gloo ranks)
  against the JAX driver run here;
- what runs on one rank: the partitioned HDNNP4th on a one-rank shard,
  the charge weight, the pools that raise, ``make_mesh``'s counts;
- softplus's derivatives (a fault the partitioned SchNet found).
"""
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

import chip_smoke
import torch_parallel_ranks as ranks
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.models import painn as jpainn, schnet as jschnet
from gcnn_keras_tpu.parallel import distributed as jdist
from gcnn_keras_tpu.parallel import edge_partition as jep, mesh as jmesh
from gcnn_keras_tpu.parallel import partitioned as jpart
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import GraphBatch
from gcnn_keras_tpu_torch.layers.aggr import pool_edges_to_nodes
from gcnn_keras_tpu_torch.models import hdnnp4th
from gcnn_keras_tpu_torch.parallel import distributed, edge_partition as ep, launch
from gcnn_keras_tpu_torch.parallel import partitioned as part
from gcnn_keras_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each spawn of ranks is joined by this deadline
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
    """What raised here until the partitioned HDNNP4th was ported (the
    model and ``CENTCharge`` on a shard) runs now: on a one-rank shard the
    charges sum to the total charge 0. What still raises on a shard, wACSF
    (no halo table, in either package), names its reason, not a roadmap
    item (``tests/test_torch_partitioned_hdnnp.py`` holds the ported path
    against JAX)."""
    from gcnn_keras_tpu_torch.models import hdnnp2nd
    shard = _one_rank_shard(angles=True)
    model = hdnnp4th.make_model_behler(device="cpu", **ranks.dp_kw("hdnnp4th"))
    out = model(shard)
    assert torch.isfinite(out["output"]).all()
    assert abs(float(out["charge"].detach().sum())) < 1e-5
    q = model.cent_electrostatic.cent_charge(shard, torch.zeros(shard.n_node, 1))
    assert abs(float(q.sum())) < 1e-5
    with pytest.raises(NotImplementedError, match="reads no halo table, as in the JAX package"):
        hdnnp2nd.make_model(device="cpu")(shard)


def test_partitioned_charge_loss_and_other_pools_raise():
    from gcnn_keras_tpu_torch.models import schnet
    shard = _one_rank_shard()
    mesh = shard.part_axis
    # a charge weight on a model without charges adds nothing, as in JAX
    step = part.make_partitioned_train_step(schnet.make_model(device="cpu"), mesh,
                                            functools.partial(torch.optim.SGD, lr=1.0),
                                            w_charge=1.0)
    _, metrics, _ = step.grads(step.init_state(), shard, 0.0, torch.zeros(shard.n_node, 3))
    assert float(metrics["charge_loss"]) == 0.0
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(metrics["energy"]) ** 2 + float(metrics["force_loss"]),
                               rtol=1e-6)
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

