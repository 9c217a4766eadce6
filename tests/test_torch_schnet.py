"""The port's SchNet energy+force serving path against the JAX package, on
shared weights.

The JAX parameters come from ``init``, go through ``params_from_jax`` into
the port, and both packages run the same batch on the CPU. They differ
only in float32 summation order, so energies and forces agree to
``rtol=1e-5`` and ``atol=1e-5 * max|reference|``.
"""
import functools

import numpy as np
import pytest
import torch

import jax

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.layers import geometry as jgeo
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models.schnet import make_model as jmake_model
from gcnn_keras_tpu.moldyn.base import MolDynamicsModelPredictor as JPredictor
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.graph.preprocess import set_range
from gcnn_keras_tpu_torch.layers import geometry
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models.schnet import make_crystal_model, make_model
from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

SMALL = dict(depth=2, interaction_args={"units": 32},
             gauss_args={"bins": 8, "distance_max": 4.0},
             input_embedding={"node": {"input_dim": 95, "output_dim": 16}},
             last_mlp={"units": [32, 16]}, output_mlp={"units": [16, 1]})


def _mols(seed, n_mols, with_esp=False):
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_mols):
        n = rs.randint(4, 13)
        g = {"node_number": rs.choice([1, 6, 7, 8, 9], size=n),
             "node_coordinates": (rs.randn(n, 3) * 1.5).astype(np.float32)}
        g = jpre.set_range(g, max_distance=4.0, max_neighbours=25)
        g["edge_indices"] = g.pop("range_indices")
        if with_esp:
            g["esp"] = (rs.randn(n) * 0.5).astype(np.float32)
            g["esp_grad"] = (rs.randn(n, 3) * 0.5).astype(np.float32)
        graphs.append(g)
    return graphs


def _crystals(seed, n_cryst):
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_cryst):
        n = rs.randint(2, 5)
        lat = np.diag(rs.uniform(3.0, 4.0, size=3)) + rs.randn(3, 3) * 0.1
        frac = rs.rand(n, 3)
        g = {"node_number": rs.choice([3, 8, 14], size=n),
             "node_coordinates": (frac @ lat).astype(np.float32),
             "graph_lattice": lat.astype(np.float32)}
        g = jpre.set_range_periodic(g, max_distance=3.5, backend="numpy")
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(g)
    return graphs


def _shared(kw, jb, crystal=False, **force_kw):
    """A JAX EnergyForceModel with init params and the port's model on the
    CPU holding the same weights."""
    jm = JEnergyForceModel(jmake_model(**kw), **force_kw)
    params = jax.jit(lambda k, b: jm.init(k, b))(jax.random.PRNGKey(1), jb)
    tmodel = (make_crystal_model if crystal else make_model)(device="cpu", **kw)
    params_from_jax(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, EnergyForceModel(tmodel, device="cpu", **force_kw)


def _close(out, ref, scale=None):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("depth", [1, 2])
def test_energy_force_matches_jax(depth):
    kw = dict(SMALL, depth=depth)
    graphs = _mols(0, 6)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(kw, jb)
    ref = jm.apply(params, jb)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    _close(out["energy"], ref["energy"])
    _close(out["force"], ref["force"])


def test_default_width_model_matches_jax():
    graphs = _mols(1, 3)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(dict(depth=1), jb)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    ref = jm.apply(params, jb)
    _close(out["energy"], ref["energy"])
    _close(out["force"], ref["force"])


def test_periodic_crystal_matches_jax():
    graphs = _crystals(2, 3)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(SMALL, jb, crystal=True)
    ref = jm.apply(params, jb)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    _close(out["energy"], ref["energy"])
    _close(out["force"], ref["force"])


def test_esp_coupling_matches_jax():
    graphs = _mols(3, 4, with_esp=True)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(SMALL, jb, use_esp_coupling=True)
    ref = jm.apply(params, jb)
    out = tm.apply(batch_graphs(graphs, device="cpu"))
    _close(out["force"], ref["force"])


def test_node_output_embedding_matches_jax():
    kw = dict(SMALL, output_embedding="node")
    graphs = _mols(4, 3)
    jb = jbatch_graphs(graphs)
    jm, params, tm = _shared(kw, jb)
    out = tm.energy_model(batch_graphs(graphs, device="cpu"))["output"]
    ref = jm.energy_model.apply(params, jb)["output"]
    # per-node outputs (~1e-3) are small differences of hidden terms of
    # ~0.1, so the summation-order noise scales with 0.1, not with them
    _close(out, ref, scale=0.1)


def test_predictor_matches_jax():
    graphs = _mols(5, 5)
    pre = functools.partial(jpre.set_range, max_distance=4.0, max_neighbours=25)
    tpre = functools.partial(set_range, max_distance=4.0, max_neighbours=25)
    frames = [{k: g[k] for k in ("node_number", "node_coordinates")} for g in graphs]
    jm, params, tm = _shared(SMALL, jbatch_graphs(graphs))
    ref = JPredictor(model=jm, variables=params, graph_preprocessors=[pre])(frames)
    out = MolDynamicsModelPredictor(tm, graph_preprocessors=[tpre],
                                    device="cpu")(frames)
    assert len(out) == len(ref) == 5
    for r, o, f in zip(ref, out, frames):
        assert o["force"].shape == (len(f["node_number"]), 3)
        assert np.abs(o["force"].sum(axis=0)).max() < 1e-4
    # one scale per batch, as in the batched tests
    for key in ("energy", "force"):
        _close(np.concatenate([o[key] for o in out]),
               np.concatenate([r[key] for r in ref]))


def test_padding_leaves_real_outputs_unchanged():
    graphs = _mols(6, 4)
    tm = EnergyForceModel(make_model(device="cpu", **SMALL), device="cpu")
    base = tm.apply(batch_graphs(graphs, device="cpu"))
    n_real = sum(len(g["node_number"]) for g in graphs)
    for pads in (dict(n_node_pad=256, n_edge_pad=1024),
                 dict(n_node_pad=130, n_graph_pad=9)):
        b = batch_graphs(graphs, device="cpu", **pads)
        out = tm.apply(b)
        np.testing.assert_allclose(out["energy"][:4].detach().numpy(),
                                   base["energy"][:4].detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["force"][:n_real].numpy(),
                                   base["force"][:n_real].numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert not out["force"][n_real:].any()


def test_geometry_matches_jax():
    graphs = _crystals(7, 2)
    jb = jbatch_graphs(graphs)
    tb = batch_graphs(graphs, device="cpu")
    _close(geometry.edge_vectors(tb), jgeo.edge_vectors(jb))
    d = geometry.edge_distances(tb)
    _close(d, jgeo.edge_distances(jb))
    _close(geometry.gauss_basis(d, bins=7, offset=0.2, sigma=0.3),
           jgeo.gauss_basis(jgeo.edge_distances(jb), bins=7, offset=0.2, sigma=0.3))


def test_params_from_jax_rejects_mismatch():
    graphs = _mols(9, 2)
    jm = JEnergyForceModel(jmake_model(**SMALL))
    params = jax.jit(lambda k, b: jm.init(k, b))(
        jax.random.PRNGKey(0), jbatch_graphs(graphs))
    tree = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(KeyError):  # depth 1 leaves interaction_1 unused
        params_from_jax(make_model(device="cpu", **dict(SMALL, depth=1)), tree)
    with pytest.raises(ValueError):  # widths differ
        params_from_jax(make_model(device="cpu", **dict(SMALL, interaction_args={"units": 8})), tree)


def test_make_model_seeded_generator_is_deterministic():
    a = make_model(device="cpu", generator=torch.Generator().manual_seed(3), **SMALL)
    b = make_model(device="cpu", generator=torch.Generator().manual_seed(3), **SMALL)
    c = make_model(device="cpu", generator=torch.Generator().manual_seed(4), **SMALL)
    for (na, pa), (_, pb), (_, pc) in zip(a.named_parameters(), b.named_parameters(),
                                          c.named_parameters()):
        assert torch.equal(pa, pb), na
    assert not torch.equal(a.interaction_0.pre.weight, c.interaction_0.pre.weight)
