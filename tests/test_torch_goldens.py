"""The port against the executed-kgcnn goldens in ``tests/assets``, the
second oracle: the reference's outputs recorded with its own weights.

Each golden's weights are mapped into the JAX package's parameters by the
recipe of its JAX test (``tests/test_force_parity.py`` for
``ref_force_*.npz``, ``tests/test_reference_parity.py`` for
``ref_golden_*.npz``), carried into the port by ``params_from_jax``, and the
port's outputs are held to the recorded ones at that test's tolerances.
The SchNet force golden runs in each of SchNet's execution modes (one
parameter set), with the padding sweep of its JAX test; the fused chain
drops padding edges where the other modes sum them onto the dead node, so
real nodes agree.
"""
import numpy as np
import pytest
import torch

import jax

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models import hdnnp2nd as jhdnnp2nd
from gcnn_keras_tpu.models import hdnnp4th as jhdnnp4th
from gcnn_keras_tpu.models import schnet as jschnet
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import hdnnp2nd, hdnnp4th, schnet
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from tests.test_force_parity import HDNNP_KW, _check_forces, _load_force, _prep
from tests.test_reference_parity import (
    _apply_mapping, _load, broadcast_relational, hdnnp2nd_mapping, hdnnp4th_mapping,
    schnet_mapping)

torch.set_num_threads(1)

SCHNET_MODES = {"unfused": {}, "fused_aggregate": {"fused_aggregate": True},
                "accurate_cfconv": {"accurate_cfconv": True},
                "fused_chain": {"fused_chain": True}}
MLP32 = {"units": [32, 32, 1], "num_relations": 9, "activation": ["swish", "swish", "linear"]}


def _port(model, params):
    """``model`` holding the JAX parameters ``params``."""
    return params_from_jax(model, jax.tree_util.tree_map(np.asarray, params))


def _np(t):
    return t.detach().numpy()


def _golden_graphs(name):
    graphs, weights, ref = _load(name)
    for g in graphs:
        g["node_number"] = g.pop("z").astype(np.int64)
        g["node_coordinates"] = g["xyz"]
    return graphs, weights, ref


# ------------------------------------------------- ref_force_*.npz (forces)


@pytest.mark.parametrize("mode", list(SCHNET_MODES))
def test_schnet_force_golden(mode):
    graphs, weights, (ref_eng, ref_force) = _load_force("schnet")
    jb = jbatch_graphs(_prep(graphs))
    jfm = JEnergyForceModel(jschnet.make_model(depth=2), is_physical_force=False)
    params = _apply_mapping(jfm.init(jax.random.PRNGKey(0), jb), weights,
                            schnet_mapping(depth=2))
    model = _port(schnet.make_model(device="cpu", depth=2,
                                    interaction_args=SCHNET_MODES[mode]), params)
    fm = EnergyForceModel(model, is_physical_force=False, device="cpu")
    batch = batch_graphs(_prep(graphs), device="cpu")
    out = fm.apply(batch)
    np.testing.assert_allclose(_np(out["energy"])[:len(graphs)], ref_eng, rtol=1e-4, atol=2e-5)
    _check_forces(out["force"].numpy(), batch, graphs, ref_force, rtol=1e-4, atol=1e-4)
    big = batch_graphs(_prep(graphs), n_node_pad=256, n_edge_pad=batch.n_edge + 512,
                       device="cpu")
    _check_forces(fm.apply(big)["force"].numpy(), big, graphs, ref_force, rtol=1e-4, atol=1e-4)


def test_hdnnp2nd_force_golden():
    graphs, weights, (ref_eng, ref_force) = _load_force("hdnnp2nd")
    kw = dict(mlp_kwargs=MLP32, **HDNNP_KW)
    jb = jbatch_graphs(_prep(graphs, keep_angles=True))
    jfm = JEnergyForceModel(jhdnnp2nd.make_model_behler(**kw), is_physical_force=False)
    mapping, bcast = hdnnp2nd_mapping()
    params = _apply_mapping(jfm.init(jax.random.PRNGKey(0), jb, train=False),
                            broadcast_relational(weights, bcast), mapping)
    fm = EnergyForceModel(_port(hdnnp2nd.make_model_behler(device="cpu", **kw), params),
                          is_physical_force=False, device="cpu")
    batch = batch_graphs(_prep(graphs, keep_angles=True), device="cpu")
    out = fm.apply(batch)
    np.testing.assert_allclose(_np(out["energy"])[:len(graphs)], ref_eng, rtol=1e-4, atol=5e-5)
    _check_forces(out["force"].numpy(), batch, graphs, ref_force, rtol=1e-4, atol=2e-4)
    big = batch_graphs(_prep(graphs, keep_angles=True), n_node_pad=256,
                       n_edge_pad=batch.n_edge + 512, n_angle_pad=batch.angles.shape[0] + 1024,
                       device="cpu")
    _check_forces(fm.apply(big)["force"].numpy(), big, graphs, ref_force, rtol=1e-4, atol=2e-4)


def test_hdnnp4th_force_charge_esp_golden():
    graphs, weights, (ref_charge, ref_eng, ref_force) = _load_force("hdnnp4th")
    kw = dict(mlp_charge_kwargs=MLP32, mlp_local_kwargs=MLP32, **HDNNP_KW)
    prepared = _prep(graphs, keep_angles=True, keep_esp=True)
    jb = jbatch_graphs(prepared, global_keys=("total_charge",))
    jfm = JEnergyForceModel(jhdnnp4th.make_model_behler(**kw), use_esp_coupling=True,
                            is_physical_force=False)
    mapping, bcast = hdnnp4th_mapping()
    params = _apply_mapping(jfm.init(jax.random.PRNGKey(0), jb, train=False),
                            broadcast_relational(weights, bcast), mapping)
    fm = EnergyForceModel(_port(hdnnp4th.make_model_behler(device="cpu", **kw), params),
                          use_esp_coupling=True, is_physical_force=False, device="cpu")
    batch = batch_graphs(prepared, global_keys=("total_charge",), device="cpu")
    out = fm.apply(batch)
    np.testing.assert_allclose(_np(out["energy"])[:len(graphs)], ref_eng, rtol=1e-4, atol=5e-5)
    q, nm, gid = _np(out["charge"]), batch.node_mask.numpy(), batch.graph_id.numpy()
    for i, g in enumerate(graphs):
        np.testing.assert_allclose(q[nm & (gid == i)], ref_charge[i, :len(g["z"]), 0],
                                   rtol=1e-4, atol=5e-5)
    _check_forces(out["force"].numpy(), batch, graphs, ref_force, rtol=1e-4, atol=5e-4)
    big = batch_graphs(prepared, global_keys=("total_charge",), n_node_pad=256,
                       n_edge_pad=batch.n_edge + 512, n_angle_pad=batch.angles.shape[0] + 1024,
                       device="cpu")
    _check_forces(fm.apply(big)["force"].numpy(), big, graphs, ref_force, rtol=1e-4, atol=5e-4)


# ---------------------------------------------- ref_golden_*.npz (outputs)


def test_schnet_golden():
    graphs, weights, ref = _golden_graphs("schnet")
    jm = jschnet.make_model(depth=2)
    params = _apply_mapping(jm.init(jax.random.PRNGKey(0), jbatch_graphs(graphs)), weights,
                            schnet_mapping(depth=2))
    out = _port(schnet.make_model(device="cpu", depth=2), params)(
        batch_graphs(graphs, device="cpu"))["output"]
    np.testing.assert_allclose(_np(out)[:len(graphs)], ref, rtol=1e-4, atol=2e-5)


def test_schnet_crystal_golden():
    graphs, weights, ref = _load("schnet_crystal")
    prepared = [{"node_number": g["z"].astype(np.int64), "node_coordinates": g["xyz"],
                 "edge_indices": g["edge_indices"],
                 "range_image": g["edge_image"].astype(np.int64),
                 "graph_lattice": g["lattice"].astype(np.float32)} for g in graphs]
    jm = jschnet.make_crystal_model(depth=2)
    jb = jbatch_graphs(prepared, global_keys=("graph_lattice",))
    params = _apply_mapping(jm.init(jax.random.PRNGKey(0), jb), weights, schnet_mapping(depth=2))
    out = _port(schnet.make_crystal_model(device="cpu", depth=2), params)(
        batch_graphs(prepared, global_keys=("graph_lattice",), device="cpu"))["output"]
    np.testing.assert_allclose(_np(out)[:len(graphs)], ref, rtol=1e-4, atol=2e-5)


def test_hdnnp2nd_golden():
    graphs, weights, ref = _golden_graphs("hdnnp2nd")
    kw = dict(mlp_kwargs=MLP32, **HDNNP_KW)
    jm = jhdnnp2nd.make_model_behler(**kw)
    mapping, bcast = hdnnp2nd_mapping()
    params = _apply_mapping(jm.init(jax.random.PRNGKey(0), jbatch_graphs(graphs)),
                            broadcast_relational(weights, bcast), mapping)
    out = _port(hdnnp2nd.make_model_behler(device="cpu", **kw), params)(
        batch_graphs(graphs, device="cpu"))["output"]
    np.testing.assert_allclose(_np(out)[:len(graphs)], ref, rtol=1e-4, atol=5e-5)


def test_hdnnp4th_rep_golden():
    graphs, _, _ = _golden_graphs("hdnnp4th_rep")
    ref_rep = [g.pop("rep") for g in graphs]
    kw = {k: HDNNP_KW[k] for k in ("g2_kwargs", "g4_kwargs")}
    batch = batch_graphs(graphs, global_keys=("total_charge",), device="cpu")
    rep = _np(hdnnp4th.make_model_rep(device="cpu", **kw)(batch)["output"])
    gid, nm = batch.graph_id.numpy(), batch.node_mask.numpy()
    for i, r in enumerate(ref_rep):
        np.testing.assert_allclose(rep[nm & (gid == i)], r, rtol=1e-4, atol=1e-5)


def test_hdnnp4th_learn_golden():
    graphs, weights, ref = _golden_graphs("hdnnp4th_learn")
    kw = dict(mlp_charge_kwargs=MLP32, mlp_local_kwargs=MLP32)
    jm = jhdnnp4th.make_model_learn(**kw)
    jb = jbatch_graphs(graphs, global_keys=("total_charge",))
    # w6/w7 are the reference's physical hardness/sigma tables, built from
    # the same constants on both sides
    mapping = [f"{mlp}/rel_dense_{i}/{p}" for mlp in ("mlp_charge",) for i in range(3)
               for p in ("kernel", "bias")] + [None, None] + [
        f"mlp_local/rel_dense_{i}/{p}" for i in range(3) for p in ("kernel", "bias")]
    weights = list(weights)
    for i in (1, 3, 5, 9, 11, 13):
        weights[i] = np.broadcast_to(weights[i], (9,) + weights[i].shape).copy()
    params = _apply_mapping(jm.init(jax.random.PRNGKey(0), jb), weights, mapping)
    out = _port(hdnnp4th.make_model_learn(device="cpu", **kw), params)(
        batch_graphs(graphs, global_keys=("total_charge",), device="cpu"))["output"]
    np.testing.assert_allclose(_np(out)[:len(graphs)], ref, rtol=1e-4, atol=5e-5)
