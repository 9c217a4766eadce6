"""The port's HDNNP2nd (Behler mode) energy+force serving path against the
JAX package, on shared weights, on the CPU.

The JAX parameters come from ``init``, go through ``params_from_jax`` into
the port, and both packages run the same batch. Both compute in float32
and differ in the order of their sums (and the port's ACSF backward is the
closed-form VJP, the JAX one autodiff), so energies agree within
``1e-5 * max|reference|`` and forces within ``1e-4 * max|reference|``.
"""
import functools

import numpy as np
import pytest
import torch

import jax

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.layers.mlp import RelationalDense as JRelationalDense
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models.hdnnp2nd import make_model_behler as jmake_model_behler
from gcnn_keras_tpu.moldyn.base import MolDynamicsModelPredictor as JPredictor
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.graph.preprocess import set_angle, set_range
from gcnn_keras_tpu_torch.layers.mlp import RelationalDense
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models.hdnnp2nd import make_model_behler
from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
from gcnn_keras_tpu_torch.ops.cuda import acsf as kacsf
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

ELEMENTS = [1, 6, 7, 8, 9]
# the JAX package's bench configuration (bench.py bench_hdnnp2nd_model)
BENCH = dict(
    g2_kwargs={"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 4.0, "elements": ELEMENTS},
    g4_kwargs={"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "rc": 4.0,
               "zeta": [1.0, 8.0], "elements": ELEMENTS, "multiplicity": 2.0},
    mlp_kwargs={"units": [64, 64, 1], "num_relations": 10,
                "activation": ["swish", "swish", "linear"]})
E_TOL, F_TOL = 1e-5, 1e-4


def _frames(seed, n_mols, elements=ELEMENTS):
    rs = np.random.RandomState(seed)
    return [{"node_number": rs.choice(elements, size=n),
             "node_coordinates": (rs.randn(n, 3) * 1.6).astype(np.float32)}
            for n in rs.randint(5, 13, size=n_mols)]


def _graphs(seed, n_mols):
    graphs = []
    for g in _frames(seed, n_mols):
        g = jpre.set_range(g, max_distance=4.0, max_neighbours=25)
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(jpre.set_angle(g, range_indices="edge_indices"))
    return graphs


def _shared(kw, jb):
    """A JAX EnergyForceModel with init params and the port's model on the
    CPU holding the same weights."""
    jm = JEnergyForceModel(jmake_model_behler(**kw))
    params = jax.jit(lambda k, b: jm.init(k, b))(jax.random.PRNGKey(1), jb)
    tmodel = make_model_behler(device="cpu", **kw)
    params_from_jax(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, EnergyForceModel(tmodel, device="cpu")


def _close(out, ref, rel):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("fused", [None, False], ids=["kernel-functions", "plain-layers"])
def test_energy_force_matches_jax(fused):
    """fused=None runs the kernels' autograd Functions (their plain versions
    on the CPU), fused=False the layers' unfused path."""
    kw = dict(BENCH, g2_kwargs=dict(BENCH["g2_kwargs"], fused=fused),
              g4_kwargs=dict(BENCH["g4_kwargs"], fused=fused))
    graphs = _graphs(0, 7)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(kw, jb)
    ref = jm.apply(params, jb)
    before = dict(kacsf.launches)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    assert kacsf.launches == before  # nothing launches on the CPU
    _close(out["energy"], ref["energy"], E_TOL)
    _close(out["force"], ref["force"], F_TOL)


@pytest.mark.parametrize("extra", [
    {"use_output_mlp": True},
    {"const_normalize_kwargs": {"std": 2.0, "mean": 0.5}},
], ids=["output-mlp", "const-normalization"])
def test_options_match_jax(extra):
    kw = dict(BENCH, **extra)
    graphs = _graphs(8, 5)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(kw, jb)
    ref = jm.apply(params, jb)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    _close(out["energy"], ref["energy"], E_TOL)
    _close(out["force"], ref["force"], F_TOL)


def test_default_config_matches_jax():
    """The JAX package's defaults: elements H, C, S; 96 relations (the JAX
    RelationalDense gathers weights there instead of a one-hot product)."""
    frames = _frames(1, 4, elements=[1, 6, 16])
    graphs = []
    for g in frames:
        g = jpre.set_range(g, max_distance=4.0, max_neighbours=25)
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(jpre.set_angle(g, range_indices="edge_indices"))
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared({}, jb)
    ref = jm.apply(params, jb)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    _close(out["energy"], ref["energy"], E_TOL)
    _close(out["force"], ref["force"], F_TOL)


def test_predictor_matches_jax():
    frames = _frames(2, 6)
    jm, params, tm = _shared(BENCH, jbatch_graphs(_graphs(2, 6)))
    jpres = [functools.partial(jpre.set_range, max_distance=4.0, max_neighbours=25),
             jpre.set_angle]
    tpres = [functools.partial(set_range, max_distance=4.0, max_neighbours=25),
             set_angle]
    ref = JPredictor(model=jm, variables=params, graph_preprocessors=jpres)(frames)
    out = MolDynamicsModelPredictor(tm, graph_preprocessors=tpres, device="cpu")(frames)
    assert len(out) == len(ref) == 6
    for o, f in zip(out, frames):
        assert o["force"].shape == (len(f["node_number"]), 3)
        assert np.abs(o["force"].sum(axis=0)).max() < 1e-4
    for key, rel in (("energy", E_TOL), ("force", F_TOL)):
        _close(np.concatenate([o[key] for o in out]),
               np.concatenate([r[key] for r in ref]), rel)


def _edge_lists(seed):
    """Random edge lists with empty, one-neighbour and duplicate-sender
    centres, in unsorted receiver order."""
    rs = np.random.RandomState(seed)
    n = 12
    edges = [(0, 1)]  # centre 0: one neighbour, no angle
    for i in range(2, n):
        if i % 4 == 0:
            continue  # no neighbours at all
        for j in rs.choice(n, size=rs.randint(2, 6), replace=True):
            edges.append((i, int(j)))
    edges = np.asarray(edges, np.int64)
    return edges[rs.permutation(len(edges))]


@pytest.mark.parametrize("kw", [{}, {"allow_multi_edges": True}, {"max_angles": 25}],
                         ids=["default", "multi-edges", "max-angles"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_set_angle_is_bit_for_bit(seed, kw):
    g = {"range_indices": _edge_lists(seed)}
    ref = jpre.set_angle(dict(g), **kw)["angle_indices_nodes"]
    out = set_angle(dict(g), **kw)["angle_indices_nodes"]
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.array_equal(out, ref)
    empty = set_angle({"range_indices": np.zeros((0, 2), np.int64)})
    assert empty["angle_indices_nodes"].shape == (0, 3)


def test_set_angle_on_molecules_is_bit_for_bit():
    for g in _frames(3, 5):
        g = set_range(g, max_distance=3.0, max_neighbours=25)
        ref = jpre.set_angle(dict(g))["angle_indices_nodes"]
        assert np.array_equal(set_angle(dict(g))["angle_indices_nodes"], ref)


@pytest.mark.parametrize("num_relations", [4, 20], ids=["one-hot", "gathered"])
def test_relational_dense_matches_jax(num_relations):
    """Relation ids at or above num_relations give the activation of 0, as
    the JAX one-hot row does."""
    rs = np.random.RandomState(4)
    x = rs.randn(9, 5).astype(np.float32)
    rel = np.array([0, 1, 2, 3, 0, 3, 2, 1, 0], np.int32)
    if num_relations == 4:
        rel[[2, 7]] = [4, 9]  # outside [0, R)
    layer = JRelationalDense(units=3, num_relations=num_relations, activation="swish")
    params = layer.init(jax.random.PRNGKey(0), x, rel)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rs.randn(*a.shape).astype(np.float32) * 0.1, params)
    ref = np.asarray(layer.apply(params, x, rel))
    port = RelationalDense(5, 3, num_relations, activation="swish")
    with torch.no_grad():
        port.kernel.copy_(torch.from_numpy(params["params"]["kernel"]))
        port.bias.copy_(torch.from_numpy(params["params"]["bias"]))
    out = port(torch.from_numpy(x), torch.from_numpy(rel))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-6)
    if num_relations == 4:  # swish(0) = 0
        assert not out[[2, 7]].any()


@pytest.mark.parametrize("num_relations", [20, 96])
def test_relational_dense_grouped_matches_dense(num_relations):
    """Above the threshold only the relations present are multiplied; the
    values and input gradients equal the all-relations product, and ids
    outside [0, R) still give the activation of 0."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(40, 6, generator=gen, dtype=torch.float64, requires_grad=True)
    rel = torch.tensor([1, 7, 7, 3, num_relations, -1, 19, 1] * 5)
    grouped = RelationalDense(6, 4, num_relations, activation="swish",
                              generator=gen).double()
    dense = RelationalDense(6, 4, num_relations, activation="swish",
                            dense_relation_threshold=num_relations).double()
    with torch.no_grad():
        grouped.bias.copy_(torch.randn(num_relations, 4, generator=gen))
    dense.load_state_dict(grouped.state_dict())
    outs = [layer(x, rel) for layer in (grouped, dense)]
    grads = [torch.autograd.grad((o * o).sum(), x)[0] for o in outs]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-12, atol=1e-12)
    assert not outs[0][(rel < 0) | (rel >= num_relations)].any()


def test_params_from_jax_rejects_mismatch():
    jb = jbatch_graphs(_graphs(5, 2))
    jm = JEnergyForceModel(jmake_model_behler(**BENCH))
    params = jax.jit(lambda k, b: jm.init(k, b))(jax.random.PRNGKey(0), jb)
    tree = jax.tree_util.tree_map(np.asarray, params)
    two = dict(BENCH, mlp_kwargs=dict(BENCH["mlp_kwargs"], units=[64, 64],
                                      activation=["swish", "swish"]))
    with pytest.raises(KeyError):  # rel_dense_2 is left over
        params_from_jax(make_model_behler(device="cpu", **two), tree)
    wide = dict(BENCH, mlp_kwargs=dict(BENCH["mlp_kwargs"], num_relations=12))
    with pytest.raises(ValueError):  # relation counts differ
        params_from_jax(make_model_behler(device="cpu", **wide), tree)


def test_padding_leaves_real_outputs_unchanged():
    graphs = _graphs(6, 4)
    tm = EnergyForceModel(make_model_behler(device="cpu", **BENCH), device="cpu")
    base = tm.apply(batch_graphs(graphs, device="cpu"))
    n_real = sum(len(g["node_number"]) for g in graphs)
    b = batch_graphs(graphs, device="cpu", n_node_pad=256, n_edge_pad=2048,
                     n_angle_pad=8192, n_graph_pad=9)
    out = tm.apply(b)
    np.testing.assert_allclose(out["energy"][:4].detach().numpy(),
                               base["energy"][:4].detach().numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out["force"][:n_real].numpy(),
                               base["force"][:n_real].numpy(), rtol=1e-5, atol=1e-7)
    assert not out["force"][n_real:].any()


def test_make_model_seeded_generator_is_deterministic():
    a = make_model_behler(device="cpu", generator=torch.Generator().manual_seed(3), **BENCH)
    b = make_model_behler(device="cpu", generator=torch.Generator().manual_seed(3), **BENCH)
    c = make_model_behler(device="cpu", generator=torch.Generator().manual_seed(4), **BENCH)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert not torch.equal(a.atomic_mlp.rel_dense_0.kernel, c.atomic_mlp.rel_dense_0.kernel)
    assert [n for n, _ in a.named_parameters()] == [
        f"atomic_mlp.rel_dense_{i}.{p}" for i in range(3) for p in ("kernel", "bias")]
