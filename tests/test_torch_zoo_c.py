"""The port's third group of the model zoo (EGNN, Megnet, CGCNN, DimeNet++,
MXMNet), its spherical basis, initializer and angle-pair preprocessors,
against the JAX package on the CPU, and against the executed-kgcnn
goldens.

As in ``tests/test_torch_zoo.py``: small graphs from a numpy seed, the JAX
``init`` variables perturbed by seeded noise (the zero-initialised output
heads of DimeNet++ and MXMNet too, so that they carry the check) and
carried into the port by ``params_from_jax``; outputs within ``rtol=1e-5``,
``atol=1e-6`` (times the output's largest entry where that is above 1:
EGNN's node outputs reach 12, where float32 resolves 1e-6, and there both
packages lie 2-4e-6 from the float64 forward), gradients within ``1e-5``
of each tensor's largest entry.
The force models take ``EnergyForceModel`` on both sides: energies,
forces, and the parameter gradients of ``train_force``'s loss (energy MAE
+ 50 x force MAE), a derivative of the forces. The goldens take the
recipes and tolerances of ``tests/test_reference_parity.py`` and
``tests/test_crystal_parity.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.ops import initializers as jinit
from gcnn_keras_tpu.ops import polynom as jpoly
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.graph import preprocess as pre
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import cgcnn, dimenet_pp, egnn, megnet, mxmnet, registry
from gcnn_keras_tpu_torch.ops import initializers, polynom
from gcnn_keras_tpu_torch.training import losses
from gcnn_keras_tpu_torch.utils.convert import flax_leaf_names, params_from_jax
from tests.test_crystal_parity import _load as _crystal_load, _prepare
from tests.test_reference_parity import _apply_mapping, _load
from tests.test_torch_zoo import _close, _perturbed

torch.set_num_threads(1)

GRAD_TOL = 1e-5  # of each gradient tensor's largest entry
FORCE_WEIGHT = 50.0  # train_force's default --force-weight
NODE16 = {"node": {"input_dim": 20, "output_dim": 16}}
OUT = {"units": [16, 1], "activation": ["swish", "linear"]}


# --------------------------------------------------------- the polynomials

POINTS = np.array([1e-6, 1e-4, 1e-3, 0.01, 0.1, 0.5, 0.999, 1.0, 1.3, 1.75, 2.5, 3.0, 4.0,
                   5.5, 7.0, 9.9, 12.0, 15.0, 20.0], np.float32)


@pytest.mark.parametrize("order", range(7))
def test_spherical_bessel_and_its_derivatives_match_jax(order):
    """``j_l`` of every order 0-6 of ``spherical_bessel_jn_all(x, 7)`` (the
    default ``num_spherical``), its first and second derivatives, from
    1e-6 to 20: JAX's values, and finite."""
    def jf(v):
        return jpoly.spherical_bessel_jn_all(v, 7)[..., order]
    ref = [np.asarray(jax.vmap(f)(jnp.asarray(POINTS)))
           for f in (jf, jax.grad(jf), jax.grad(jax.grad(jf)))]
    x = torch.tensor(POINTS, requires_grad=True)
    y = polynom.spherical_bessel_jn_all(x, 7)[..., order]
    d1, = torch.autograd.grad(y.sum(), x, create_graph=True)
    d2, = torch.autograd.grad(d1.sum(), x)
    for got, want in zip((y, d1, d2), ref):
        assert torch.isfinite(got).all()
        scale = max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(polynom.spherical_bessel_jn(x, order).detach().numpy(),
                               np.asarray(jpoly.spherical_bessel_jn(jnp.asarray(POINTS), order)),
                               rtol=0, atol=2e-6)


def test_bessel_diagonal_is_each_order_at_its_own_row():
    x = np.abs(np.random.RandomState(1).randn(5, 7, 6).astype(np.float32)) * 6
    got = polynom.spherical_bessel_jn_diagonal(torch.from_numpy(x)).numpy()
    for l in range(7):
        ref = np.asarray(jpoly.spherical_bessel_jn_all(jnp.asarray(x[:, l, :]), 7)[..., l])
        np.testing.assert_allclose(got[:, l, :], ref, rtol=0, atol=2e-6)


def test_legendre_and_bessel_zeros_match_jax():
    c = np.linspace(-1, 1, 41).astype(np.float32)
    np.testing.assert_allclose(polynom.legendre_pn_all(torch.from_numpy(c), 7).numpy(),
                               np.asarray(jpoly.legendre_pn_all(jnp.asarray(c), 7)),
                               rtol=1e-6, atol=1e-6)
    for n in range(7):
        np.testing.assert_allclose(polynom.legendre_pn(torch.from_numpy(c), n).numpy(),
                                   np.asarray(jpoly.legendre_pn(jnp.asarray(c), n)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(polynom.spherical_bessel_zeros(7, 6),
                                  jpoly.spherical_bessel_zeros(7, 6))
    z, n = dimenet_pp._sbf_constants(7, 6)
    from gcnn_keras_tpu.models import dimenet_pp as jdime
    jz, jn = jdime._sbf_constants(7, 6)
    np.testing.assert_array_equal(z, jz)
    np.testing.assert_array_equal(n, jn)


@pytest.mark.parametrize("shape", [(8, 16), (16, 8), (12, 12), (128, 64)])
def test_glorot_orthogonal_draws_orthogonal_weights_of_glorot_variance(shape):
    """The flax kernel shape ``(in, out)``: the port's weight is its
    transpose; orthonormal rows or columns up to the rescale, and the
    variance ``2 / (in + out)`` as JAX's draw has it."""
    fan_in, fan_out = shape
    w = initializers.glorot_orthogonal_(torch.empty(fan_out, fan_in),
                                        torch.Generator().manual_seed(3))
    kernel = w.T.double().numpy()
    target = 2.0 / (fan_in + fan_out)
    np.testing.assert_allclose(kernel.var(), target, rtol=1e-5)
    gram = kernel.T @ kernel if fan_in >= fan_out else kernel @ kernel.T
    np.testing.assert_allclose(gram / gram[0, 0], np.eye(len(gram)), atol=1e-5)
    ref = np.asarray(jinit.glorot_orthogonal()(jax.random.PRNGKey(0), shape), np.float64)
    np.testing.assert_allclose(ref.var(), kernel.var(), rtol=1e-5)
    w2 = initializers.glorot_orthogonal_(torch.empty(fan_out, fan_in),
                                         torch.Generator().manual_seed(3))
    assert torch.equal(w, w2)
    with pytest.raises(ValueError, match="2D"):
        initializers.glorot_orthogonal_(torch.empty(3, 4, 5))


# --------------------------------------------------------- the preprocessors


def _random_edges(seed, n=9, k=30, self_loops=False):
    rs = np.random.RandomState(seed)
    pairs = rs.randint(0, n, size=(k, 2))
    if not self_loops:
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    # duplicates kept: the multi-edge flag sees them
    return {"node_number": rs.randint(1, 9, size=n), "edge_indices": pairs.astype(np.int64)}


GRAPH_CASES = {"random": lambda: _random_edges(1), "dense": lambda: _random_edges(2, 6, 40),
               "self loops": lambda: _random_edges(3, 7, 25, True),
               "empty": lambda: {"node_number": np.arange(3), "edge_indices":
                                 np.zeros((0, 2), np.int64)}}


@pytest.mark.parametrize("allow_backtrack", [False, True])
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_set_angle_edge_pairs_matches_jax_bit_for_bit(case, allow_backtrack):
    if case == "empty":
        g = GRAPH_CASES[case]()
        for mod in (pre, jpre):
            out = mod.set_angle_edge_pairs(g, range_indices="edge_indices",
                                           allow_backtrack=allow_backtrack)
            assert out["angle_indices"].shape == (0, 2)
        return
    g = GRAPH_CASES[case]()
    got = pre.set_angle_edge_pairs(g, range_indices="edge_indices",
                                   allow_backtrack=allow_backtrack)
    ref = jpre.set_angle_edge_pairs(g, range_indices="edge_indices",
                                    allow_backtrack=allow_backtrack)
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["angle_indices"], ref["angle_indices"])
    assert got["angle_indices"].dtype == ref["angle_indices"].dtype
    assert len(got["angle_indices"]) > 0


@pytest.mark.parametrize("flags", [(False, False, False), (True, False, False),
                                   (False, True, False), (False, False, True),
                                   (True, True, True)])
@pytest.mark.parametrize("pairing", ["jk", "ik", "kj", "ki"])
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_set_angle_pairs_kgcnn_matches_jax_bit_for_bit(case, pairing, flags):
    self_edges, multi, reverse = flags
    g = GRAPH_CASES[case]()
    kw = dict(range_indices="edge_indices", edge_pairing=pairing, out_key="pairs",
              allow_self_edges=self_edges, allow_multi_edges=multi,
              allow_reverse_edges=reverse)
    got, ref = pre.set_angle_pairs_kgcnn(g, **kw), jpre.set_angle_pairs_kgcnn(g, **kw)
    np.testing.assert_array_equal(got["pairs"], ref["pairs"])
    assert got["pairs"].dtype == ref["pairs"].dtype and got["pairs"].shape[1] == 2


def test_preprocessors_are_registered_and_refuse_a_pairing():
    g = GRAPH_CASES["random"]()
    for name, kw in (("set_angle_edge_pairs", dict(range_indices="edge_indices")),
                     ("set_angle_pairs_kgcnn", dict(edge_pairing="ik", out_key="a2"))):
        got = pre.get_preprocessor(name, **kw)(g)
        ref = jpre.get_preprocessor(name, **kw)(g)
        key = "a2" if "out_key" in kw else "angle_indices"
        np.testing.assert_array_equal(got[key], ref[key])
    for pairing in ("ij", "kk"):
        with pytest.raises(ValueError, match="edge_pairing"):
            pre.set_angle_pairs_kgcnn(g, edge_pairing=pairing)


# --------------------------------------------------------- the batches


def _mols(seed, n_graphs=5, cutoff=3.0, node_features=None, edge_features=None,
          graph_features=None):
    """Small molecules: 4-8 atoms of H, C, N, O at random positions, the
    edges within ``cutoff`` (``set_range``, at most 8 a node), a label, an
    energy and forces, optional float node, edge and graph features."""
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_graphs):
        n = rs.randint(4, 9)
        g = {"node_number": rs.choice([1, 6, 7, 8], size=n),
             "node_coordinates": (rs.randn(n, 3) * 1.2).astype(np.float32)}
        g = pre.set_range(g, max_distance=cutoff, max_neighbours=8)
        g["edge_indices"] = g.pop("range_indices")
        m = len(g["edge_indices"])
        g["graph_labels"] = rs.randn(1).astype(np.float32)
        g["energy"] = rs.randn(1).astype(np.float32)
        g["force"] = rs.randn(n, 3).astype(np.float32)
        if node_features:
            g["node_attributes"] = rs.randn(n, node_features).astype(np.float32)
        if edge_features:
            g["edge_attributes"] = rs.randn(m, edge_features).astype(np.float32)
        if graph_features:
            g["graph_attributes"] = rs.randn(graph_features).astype(np.float32)
        graphs.append(g)
    return graphs


def _with_angle_pairs(graphs):
    return [pre.set_angle_edge_pairs(g, range_indices="edge_indices") for g in graphs]


def _multiplex(graphs, local=2.5, range_cutoff=5.0, second=True):
    """MXMNet's inputs as ``train_force`` makes them: the local bond graph
    as ``edge_indices``, the range graph as ``range_indices``, the pairings
    ``jk`` and ``ik`` (with self pairs)."""
    out = []
    for g in graphs:
        g = pre.set_range(g, max_distance=local, max_neighbours=12)
        g["edge_indices"] = g.pop("range_indices")
        if second:
            g = pre.set_range(g, max_distance=range_cutoff, max_neighbours=25)
        g = pre.set_angle_pairs_kgcnn(g, range_indices="edge_indices", edge_pairing="jk",
                                      out_key="angle_indices_1")
        g = pre.set_angle_pairs_kgcnn(g, range_indices="edge_indices", edge_pairing="ik",
                                      allow_self_edges=True, out_key="angle_indices_2")
        out.append(g)
    return out


MXM_KEYS = dict(angle_edge_index_key="angle_indices_1",
                angle_edge_index_key_2="angle_indices_2")


def _crystals(name):
    """The periodic cells of a golden, ``(graphs, global keys)``: CGCNN's
    (fractional coordinates, 2 atoms) or Megnet's (with their state)."""
    if name == "cgcnn":
        graphs, _, _ = _load("cgcnn")
        return [{"node_number": g["z"].astype(np.int64),
                 "node_coordinates": (g["frac"] @ g["lattice"]).astype(np.float32),
                 "edge_indices": g["edge_indices"],
                 "range_image": g["cell_translations"].astype(np.int64),
                 "graph_lattice": g["lattice"].astype(np.float32)} for g in graphs], \
            ("graph_lattice",)
    graphs, _, _ = _crystal_load("megnet_crystal")
    return _prepare(graphs, with_state=True)


def _labelled(graphs, seed):
    rs = np.random.RandomState(seed)
    for g in graphs:
        g.setdefault("graph_labels", rs.randn(1).astype(np.float32))
    return graphs


# --------------------------------------------------------- the models

# name -> (module, builder, config, batch maker (graphs, batch keywords,
# global keys))
DIME_SMALL = dict(num_blocks=2, emb_size=16, out_emb_size=16, int_emb_size=8,
                  basis_emb_size=4, num_spherical=3, num_radial=4, num_dense_output=2,
                  input_embedding={"node": {"input_dim": 10, "output_dim": 16}})
MXM_SMALL = dict(depth=2, input_embedding={"node": {"input_dim": 10, "output_dim": 16}},
                 bessel_basis_local={"num_radial": 6, "cutoff": 5.0},
                 bessel_basis_global={"num_radial": 6, "cutoff": 6.0},
                 spherical_basis_local={"num_spherical": 3, "num_radial": 4, "cutoff": 5.0},
                 mlp_rbf_kwargs={"units": 16, "activation": "swish"},
                 mlp_sbf_kwargs={"units": 16, "activation": "swish"},
                 global_mp_kwargs={"units": 16},
                 local_mp_kwargs={"units": 16, "output_units": 1})
SMALL_MLP = {"units": [16, 16], "activation": ["swish", "linear"]}


def _mol_case(**kw):
    return lambda seed: (_mols(seed, **kw), {}, ("graph_labels",))


def _dime_case(seed):
    return _with_angle_pairs(_mols(seed)), dict(angle_edge_index_key="angle_indices"), \
        ("graph_labels",)


def _mxm_case(second=True, node_features=None, edge_features=None):
    def make(seed):
        graphs = _multiplex(_mols(seed, cutoff=3.0, node_features=node_features,
                                  edge_features=None), second=second)
        if edge_features:
            rs = np.random.RandomState(seed + 3)
            for g in graphs:
                g["edge_attributes"] = rs.randn(len(g["edge_indices"]),
                                                edge_features).astype(np.float32)
        return graphs, dict(MXM_KEYS, second_edge_index_key="range_indices" if second else None), \
            ("graph_labels",)
    return make


def _crystal_case(name, angles=False):
    def make(seed):
        graphs, keys = _crystals(name)
        graphs = _labelled(graphs, seed)
        kw = {}
        if angles:
            graphs = _with_angle_pairs(graphs)
            kw = dict(angle_edge_index_key="angle_indices")
        return graphs, kw, ("graph_labels",) + tuple(keys)
    return make


MODELS = {
    "EGNN": ("egnn", "make_model",
             dict(depth=2, input_embedding=NODE16, edge_mlp_kwargs=SMALL_MLP,
                  coord_mlp_kwargs={"units": [16, 1], "activation": ["swish", "linear"]},
                  node_mlp_kwargs=SMALL_MLP, output_mlp=OUT), _mol_case()),
    "EGNN-options": ("egnn", "make_model",
                     dict(depth=3, input_embedding=NODE16, edge_in_features=4,
                          node_mlp_initialize={"units": [16], "activation": ["swish"]},
                          edge_mlp_kwargs=SMALL_MLP, edge_attention_kwargs={"units": 1},
                          use_normalized_difference=True,
                          coord_mlp_kwargs={"units": [8, 1], "activation": ["swish", "linear"]},
                          pooling_coord_kwargs={"pooling_method": "sum"},
                          node_mlp_kwargs=SMALL_MLP,
                          node_pooling_kwargs={"pooling_method": "mean"}, output_mlp=OUT),
                     _mol_case(edge_features=4)),
    "EGNN-node": ("egnn", "make_model",
                  dict(depth=2, in_features=6, use_edge_attributes=False, use_skip=False,
                       edge_mlp_kwargs=SMALL_MLP,
                       coord_mlp_kwargs={"units": [16, 1], "activation": ["swish", "linear"]},
                       node_mlp_kwargs=SMALL_MLP, output_embedding="node", output_mlp=OUT),
                  _mol_case(node_features=6, edge_features=3)),
    "CGCNN": ("cgcnn", "make_model",
              dict(depth=2, input_embedding=NODE16,
                   gauss_args={"bins": 10, "distance_max": 4.0, "offset": 0.0, "sigma": 0.4},
                   conv_layer_args={"units": 16, "activation_s": "softplus",
                                    "activation_out": "softplus",
                                    "batch_normalization": True},
                   output_mlp={"units": [16, 1], "activation": ["softplus", "linear"]}),
              _mol_case()),
    "CGCNN-edges": ("cgcnn", "make_model",
                    dict(depth=2, in_features=6, make_distances=False, edge_in_features=4,
                         conv_layer_args={"units": 12, "activation_s": "swish",
                                          "activation_out": "swish",
                                          "batch_normalization": False},
                         node_pooling_args={"pooling_method": "sum"},
                         output_embedding="node", output_mlp=OUT),
                    _mol_case(node_features=6, edge_features=4)),
    "CGCNN-crystal": ("cgcnn", "make_crystal_model",
                      dict(depth=2,
                           gauss_args={"bins": 12, "distance_max": 8.0, "offset": 0.0,
                                       "sigma": 0.4},
                           conv_layer_args={"units": 16, "activation_s": "softplus",
                                            "activation_out": "softplus",
                                            "batch_normalization": True}),
                      _crystal_case("cgcnn")),
    "Megnet": ("megnet", "make_model",
               dict(nblocks=2, input_embedding=NODE16, graph_in_features=2,
                    gauss_args={"bins": 8, "distance_max": 4.0, "offset": 0.0, "sigma": 0.4},
                    meg_block_args={"node_embed": [16, 8, 8], "edge_embed": [16, 8, 8],
                                    "env_embed": [16, 8, 8], "activation": "softplus2"},
                    set2set_args={"channels": 6, "T": 2, "pooling_method": "sum",
                                  "init_qstar": "0"},
                    node_ff_args={"units": [16, 8], "activation": "softplus2"},
                    edge_ff_args={"units": [16, 8], "activation": "softplus2"},
                    state_ff_args={"units": [16, 8], "activation": "softplus2"},
                    output_mlp={"units": [8, 1], "activation": ["softplus2", "linear"]}),
               _mol_case(graph_features=2)),
    "Megnet-means": ("megnet", "make_model",
                     dict(nblocks=2, input_embedding=NODE16, use_set2set=False,
                          gauss_args={"bins": 8, "distance_max": 4.0, "offset": 0.0,
                                      "sigma": 0.4},
                          meg_block_args={"node_embed": [16, 8], "edge_embed": [16, 8],
                                          "env_embed": [16, 8], "activation": "softplus2"},
                          node_ff_args={"units": [16, 8], "activation": "softplus2"},
                          edge_ff_args={"units": [16, 8], "activation": "softplus2"},
                          state_ff_args={"units": [16, 8], "activation": "softplus2"},
                          output_mlp={"units": [8, 1], "activation": ["softplus2", "linear"]}),
                     _mol_case()),
    "Megnet-plain": ("megnet", "make_model",
                     dict(nblocks=3, in_features=6, has_ff=False, use_set2set=False,
                          make_distance=False, edge_in_features=3,
                          meg_block_args={"node_embed": [16, 8], "edge_embed": [16, 8],
                                          "env_embed": [16, 8], "activation": "swish"},
                          node_ff_args={"units": [8], "activation": "swish"},
                          edge_ff_args={"units": [8], "activation": "swish"},
                          state_ff_args={"units": [8], "activation": "swish"},
                          output_mlp={"units": [8, 1], "activation": ["swish", "linear"]}),
                     _mol_case(node_features=6, edge_features=3)),
    "Megnet-crystal": ("megnet", "make_crystal_model",
                       dict(nblocks=2, graph_in_features=1,
                            meg_block_args={"node_embed": [16, 8, 8],
                                            "edge_embed": [16, 8, 8],
                                            "env_embed": [16, 8, 8],
                                            "activation": "softplus2"},
                            set2set_args={"channels": 4, "T": 3, "pooling_method": "sum",
                                          "init_qstar": "0"},
                            node_ff_args={"units": [16, 8], "activation": "softplus2"},
                            edge_ff_args={"units": [16, 8], "activation": "softplus2"},
                            state_ff_args={"units": [16, 8], "activation": "softplus2"},
                            output_mlp={"units": [8, 1],
                                        "activation": ["softplus2", "linear"]}),
                       _crystal_case("megnet")),
    "DimeNetPP": ("dimenet_pp", "make_model",
                  dict(DIME_SMALL, output_mlp={"units": [8, 1], "activation": ["swish", "linear"],
                                               "use_bias": [True, False]}),
                  _dime_case),
    "DimeNetPP-wide": ("dimenet_pp", "make_model",
                       dict(DIME_SMALL, num_spherical=7, num_radial=6, num_blocks=1,
                            num_targets=2, extensive=False, output_init="glorot_orthogonal",
                            num_before_skip=2, num_after_skip=1),
                       _dime_case),
    "DimeNetPP-node": ("dimenet_pp", "make_model",
                       dict(DIME_SMALL, output_embedding="node"), _dime_case),
    "DimeNetPP-crystal": ("dimenet_pp", "make_crystal_model",
                          dict(DIME_SMALL, input_embedding={"node": {"input_dim": 95,
                                                                     "output_dim": 16}}),
                          _crystal_case("cgcnn", angles=True)),
    "MXMNet": ("mxmnet", "make_model", MXM_SMALL, _mxm_case()),
    "MXMNet-options": ("mxmnet", "make_model",
                       dict(MXM_SMALL, in_features=16, use_edge_attributes=True,
                            edge_in_features=3,
                            local_mp_kwargs={"units": 16, "output_units": 2,
                                             "pooling_method": "mean",
                                             "output_kernel_initializer": "glorot_uniform"},
                            output_embedding="node",
                            output_mlp={"use_bias": [False], "units": [1],
                                        "activation": ["linear"]}),
                       _mxm_case(node_features=16, edge_features=3)),
    "MXMNet-one-edge-set": ("mxmnet", "make_model",
                            dict(MXM_SMALL, use_output_mlp=False), _mxm_case(second=False)),
}

# Megnet without Set2Set: JAX's Set2Set gives NaN force-loss gradients
# (``test_megnet_set2set_force_loss_gradients_are_finite``)
FORCE_MODELS = ["EGNN", "Megnet-means", "DimeNetPP", "MXMNet"]


def _port_builder(name):
    mod, builder = MODELS[name][:2]
    return getattr(importlib.import_module(f"gcnn_keras_tpu_torch.models.{mod}"), builder)


def _case(name, seed=70):
    """The JAX model, its perturbed variables, the port model holding them,
    the graphs and the two batches."""
    mod, builder, kw, make = MODELS[name]
    graphs, bkw, keys = make(seed)
    jb = jbatch_graphs(graphs, global_keys=keys, **bkw)
    tb = batch_graphs(graphs, global_keys=keys, device="cpu", **bkw)
    jkw = {k: v for k, v in kw.items() if not k.endswith("in_features")}
    jm = getattr(importlib.import_module(f"gcnn_keras_tpu.models.{mod}"), builder)(**jkw)
    variables = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jb), seed + 1)
    if "batch_stats" in variables:  # running variances stay positive
        variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    model = params_from_jax(_port_builder(name)(device="cpu", **kw), variables)
    return jm, variables, model, jb, tb


def _ref_named(name, tree, variables):
    """A flax gradient tree by the port's parameter names (``variables``
    gives the running statistics the tree lacks)."""
    kw = MODELS[name][2]
    return {n: p.detach().numpy() for n, p in params_from_jax(
        _port_builder(name)(device="cpu", **kw),
        {**variables, "params": jax.tree_util.tree_map(np.asarray, tree)}).named_parameters()}


def _grads_close(names, grads, ref, exact):
    """Each gradient against JAX's ``ref`` by ``chip_smoke.check_grads`` at
    ``GRAD_TOL``: within it of each tensor's largest entry or, where not,
    by its float64 rules on ``exact()`` (the port's gradients of the same
    loss in float64, by name), as ``tests/test_torch_zoo_b.py`` holds the
    second group. A parameter that no output reads (Set2Set's recurrent
    kernel, EGNN's last ``coord_mlp``) has no gradient here and a zero one
    in JAX."""
    import chip_smoke
    assert sorted(ref) == sorted(names)
    for n, g in zip(names, grads):
        if g is None:
            assert not ref[n].any(), n
    chip_smoke.check_grads(
        "port against JAX", {n: g for n, g in zip(names, grads) if g is not None},
        {n: torch.as_tensor(r) for n, r in ref.items()}, GRAD_TOL, exact)


def _float64(loss_of, model, tb):
    """``exact`` for ``_grads_close``: ``loss_of(model, batch)``'s gradients
    with a float64 copy of the model and of the batch's floats."""
    import copy

    import chip_smoke
    return lambda: chip_smoke.float64_grads(copy.deepcopy(model), loss_of, tb)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    jm, variables, model, jb, tb = _case(name)
    out, ref = model(tb)["output"], jm.apply(variables, jb)["output"]
    assert torch.isfinite(out).all()
    _close(out, ref, 1e-5, 1e-6 * max(1.0, float(np.abs(np.asarray(ref)).max())))


def _mae(out, b, node, pkg):
    if node:
        return pkg.masked_node_mae(out, out * 0, b.node_mask)
    return pkg.masked_graph_mae(out, b.globals["graph_labels"], b.globals["graph_mask"])


@pytest.mark.parametrize("name", list(MODELS))
def test_model_loss_gradients_match_jax(name):
    """A masked graph MAE (a node MAE for node outputs) and its gradients
    along every parameter against ``jax.value_and_grad``."""
    jm, variables, model, jb, tb = _case(name)
    node = MODELS[name][2].get("output_embedding") == "node"

    def jloss(params):
        out = jm.apply({**variables, "params": params}, jb)["output"]
        return _mae(out, jb, node, jlosses)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    loss = _mae(model(tb)["output"], tb, node, losses)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    _grads_close(names, grads, _ref_named(name, ref_grads, variables),
                 _float64(lambda m, b: _mae(m(b)["output"], b, node, losses), model, tb))


def _force_loss(out, b, pkg):
    e = pkg.masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
    f = pkg.masked_node_mae(out["force"], b.nodes["force"], b.node_mask)
    return e + FORCE_WEIGHT * f


@pytest.mark.parametrize("name", FORCE_MODELS)
def test_force_model_matches_jax(name):
    """Energies, forces and the parameter gradients of ``train_force``'s
    loss through ``EnergyForceModel`` against the JAX package's."""
    mod, builder, kw, make = MODELS[name]
    graphs, bkw, keys = make(71)
    keys = keys + ("energy",)
    jb = jbatch_graphs(graphs, global_keys=keys, **bkw)
    tb = batch_graphs(graphs, global_keys=keys, device="cpu", **bkw)
    jkw = {k: v for k, v in kw.items() if not k.endswith("in_features")}
    jm = getattr(importlib.import_module(f"gcnn_keras_tpu.models.{mod}"), builder)(**jkw)
    jfm = JEnergyForceModel(jm)
    variables = _perturbed(jax.jit(jfm.init)(jax.random.PRNGKey(0), jb), 72)
    fm = EnergyForceModel(params_from_jax(_port_builder(name)(device="cpu", **kw), variables),
                          device="cpu")
    ref = jfm.apply(variables, jb)
    out = fm.apply(tb, create_graph=True)
    _close(out["energy"], ref["energy"])
    _close(out["force"], ref["force"], 1e-5, 1e-5 * np.abs(np.asarray(ref["force"])).max())
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: _force_loss(jfm.apply({"params": p}, jb), jb, jlosses)))(variables["params"])
    loss = _force_loss(out, tb, losses)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names, params = zip(*fm.energy_model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)

    def loss_of(model, b):
        return _force_loss(EnergyForceModel(model, device="cpu").apply(b, create_graph=True),
                           b, losses)
    _grads_close(names, grads, _ref_named(name, ref_grads, variables),
                 _float64(loss_of, fm.energy_model, tb))


def test_megnet_set2set_force_loss_gradients_are_finite():
    """With its ``Set2Set`` readouts (the default) JAX's Megnet gives
    finite energies and forces, and NaN parameter gradients of a force loss
    (a reference behaviour: the second derivative of its segment softmax's
    ``segment_max``). The port's energies and forces are JAX's; its
    force-loss gradients are finite and, in float64, agree with central
    differences of the loss along a random direction of the parameters."""
    mod, builder, kw, make = MODELS["Megnet"]
    graphs, bkw, keys = make(71)
    keys = keys + ("energy",)
    jb = jbatch_graphs(graphs, global_keys=keys, **bkw)
    tb = batch_graphs(graphs, global_keys=keys, device="cpu", **bkw)
    from gcnn_keras_tpu.models import megnet as jmegnet
    jfm = JEnergyForceModel(jmegnet.make_model(**{k: v for k, v in kw.items()
                                                  if not k.endswith("in_features")}))
    variables = _perturbed(jax.jit(jfm.init)(jax.random.PRNGKey(0), jb), 72)
    ref = jfm.apply(variables, jb)
    jgrads = jax.grad(lambda p: _force_loss(jfm.apply({"params": p}, jb), jb, jlosses))(
        variables["params"])
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree_util.tree_leaves(jgrads))
    model = params_from_jax(megnet.make_model(device="cpu", **kw), variables)
    out = EnergyForceModel(model, device="cpu").apply(tb, create_graph=True)
    _close(out["energy"], ref["energy"])
    _close(out["force"], ref["force"], 1e-5, 1e-5 * np.abs(np.asarray(ref["force"])).max())
    # Set2Set's recurrent kernels meet only the zero state, and the forces
    # do not see the last bias: those have no gradient
    grads = torch.autograd.grad(_force_loss(out, tb, losses), list(model.parameters()),
                                allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    assert sum(g is not None for g in grads) > len(grads) - 4

    model.double()
    b64 = tb._map(lambda v: v.double() if v.is_floating_point() else v)
    w = torch.randn(tb.n_node, 3, generator=torch.Generator().manual_seed(5), dtype=torch.float64)

    def smooth(m):  # a smooth force loss: finite differences see no kink
        return (EnergyForceModel(m, device="cpu").apply(b64, create_graph=True)["force"]
                * w).sum()
    params = list(model.parameters())
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, torch.autograd.grad(smooth(model), params,
                                                          allow_unused=True))]
    direction = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i),
                             dtype=torch.float64) for i, p in enumerate(params)]
    eps, values = 1e-6, []
    for sign in (1, -1):
        with torch.no_grad():
            for p, d in zip(params, direction):
                p.add_(sign * eps * d)
        values.append(smooth(model).item())
        with torch.no_grad():
            for p, d in zip(params, direction):
                p.sub_(sign * eps * d)
    numeric = (values[0] - values[1]) / (2 * eps)
    analytic = sum((g * d).sum().item() for g, d in zip(grads, direction))
    np.testing.assert_allclose(analytic, numeric, rtol=1e-6)


def test_cgcnn_batch_norm_in_training_matches_jax():
    """``train=True``: the masked batch statistics, and the running
    averages they move, as JAX's under ``mutable=["batch_stats"]``."""
    jm, variables, model, jb, tb = _case("CGCNN")
    ref, new_vars = jm.apply(variables, jb, train=True, mutable=["batch_stats"])
    _close(model(tb, train=True)["output"], ref["output"])
    stats = dict(params_from_jax(_port_builder("CGCNN")(device="cpu", **MODELS["CGCNN"][2]),
                                 {**variables, **jax.tree_util.tree_map(np.asarray, new_vars)}
                                 ).named_buffers())
    bufs = dict(model.named_buffers())
    assert sorted(stats) == sorted(bufs) and len(bufs) == 12
    for n, b in bufs.items():
        _close(b, stats[n].numpy())


@pytest.mark.parametrize("name", ["DimeNetPP", "MXMNet"])
def test_angle_models_need_their_pair_lists(name):
    """A batch without the pair lists raises ``ValueError`` (JAX: an
    assert), naming what builds them."""
    graphs = _mols(73)
    model = _port_builder(name)(device="cpu", **MODELS[name][2])
    with pytest.raises(ValueError, match="set_angle"):
        model(batch_graphs(graphs, device="cpu"))


@pytest.mark.parametrize("num_spherical", [2, 7])
@pytest.mark.parametrize("name", ["DimeNetPP", "MXMNet"])
def test_force_loss_gradients_are_finite_on_padded_batches(name, num_spherical):
    """``tests/test_models_potentials.py``'s NaN regression: padding pairs
    hold zero vectors at distance 1e-6, where the series' and recursion's
    unselected branches and the envelope's 1/d are extreme. The parameter
    and position gradients of an energy + force loss stay finite, at the
    default ``num_spherical`` 7 too, on a batch padded past its graphs."""
    mod, builder, kw, make = MODELS[name]
    kw = dict(kw)
    if name == "DimeNetPP":
        kw["num_spherical"] = num_spherical
    else:
        kw["spherical_basis_local"] = dict(kw["spherical_basis_local"],
                                           num_spherical=num_spherical)
    graphs, bkw, keys = make(74)
    tb = batch_graphs(graphs, global_keys=keys + ("energy",), device="cpu",
                      n_node_pad=64, n_edge_pad=512, **bkw)
    assert not tb.angle_edge_mask.all() and not tb.edge_mask.all()
    model = _port_builder(name)(device="cpu", **kw)
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    fm = EnergyForceModel(model, device="cpu")
    out = fm.apply(tb.replace_nodes(node_coordinates=pos), create_graph=True)
    gm = tb.globals["graph_mask"].float()
    loss = (out["energy"][:, 0].abs() * gm).sum() + \
        (out["force"].abs() * tb.node_mask[:, None].float()).sum()
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params + [pos], allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    assert torch.isfinite(out["force"]).all()


def test_default_zero_heads_build_and_run_as_jax():
    """At their default ``output_init`` / ``output_kernel_initializer``
    (zeros) a fresh DimeNet++ answers 0 and a fresh MXMNet its output
    MLP's bias: constants, as JAX's fresh models; a first step moves the
    heads."""
    graphs = _with_angle_pairs(_mols(75))
    tb = batch_graphs(graphs, angle_edge_index_key="angle_indices", device="cpu")
    model = dimenet_pp.make_model(device="cpu", num_blocks=1)
    out = model(tb)["output"]
    assert out.shape == (tb.n_graphs, 1) and not out.any()
    assert all(not model.get_submodule(f"output_{b}").out.weight.any() for b in range(2))
    jb = jbatch_graphs(graphs, angle_edge_index_key="angle_indices")
    from gcnn_keras_tpu.models import dimenet_pp as jdime
    jm = jdime.make_model(num_blocks=1)
    assert not np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0), jb), jb)["output"]).any()
    mgraphs = _multiplex(_mols(75))
    mb = batch_graphs(mgraphs, second_edge_index_key="range_indices", device="cpu", **MXM_KEYS)
    mxm = mxmnet.make_model(device="cpu", depth=1)
    mout = mxm(mb)["output"]
    assert torch.equal(mout, mxm.output_mlp.dense_0.bias.expand_as(mout))
    loss = mout.sum() + out.sum()
    grads = torch.autograd.grad(loss, [mxm.local_0.y_W.weight,
                                       model.output_1.out.weight])
    assert all(g.abs().max() > 0 for g in grads)


def test_shared_weights_load_into_one_parameter():
    """MXMNet's global track runs ``propagate`` twice on one ``x_edge_mlp``
    and one ``linear``; its local track's ``h_mlp`` serves the entry and
    the update: one flax leaf each, one port parameter each, loaded whole
    (no leaf left over)."""
    mgraphs = _multiplex(_mols(76))
    kw = dict(second_edge_index_key="range_indices", **MXM_KEYS)
    jb = jbatch_graphs(mgraphs, **kw)
    from gcnn_keras_tpu.models import mxmnet as jmxm
    variables = jmxm.make_model(**MXM_SMALL).init(jax.random.PRNGKey(0), jb)
    model = params_from_jax(mxmnet.make_model(device="cpu", **MXM_SMALL),
                            jax.tree_util.tree_map(np.asarray, variables))
    leaves = list(flax_leaf_names(model).values())
    assert len(leaves) == len(set(leaves)) == len(jax.tree_util.tree_leaves(variables))
    for shared in ("global_0/x_edge_mlp/Dense_0/kernel", "global_0/linear/Dense_0/kernel",
                   "local_0/h_mlp/Dense_0/kernel"):
        assert leaves.count(shared) == 1
    # EGNN keeps the last depth's coord_mlp (the kgcnn model prunes it)
    egnn_leaves = flax_leaf_names(egnn.make_model(device="cpu", depth=2)).values()
    assert "coord_mlp_1/dense_0/Dense_0/kernel" in egnn_leaves
    # DimeNet++'s Bessel frequencies are closed form, not parameters
    assert not any("freq" in n for n in flax_leaf_names(dimenet_pp.make_model(device="cpu")))


def test_fresh_models_draw_from_a_torch_generator():
    """A deliberate difference: the port's weights come from the builder's
    ``torch.Generator`` (the same seed, the same weights; not JAX's
    numbers)."""
    for make in (egnn.make_model, cgcnn.make_model, megnet.make_model,
                 dimenet_pp.make_model, mxmnet.make_model):
        a, b, c = (make(device="cpu", generator=torch.Generator().manual_seed(s))
                   for s in (1, 1, 2))
        for (n, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
            assert torch.equal(p, q), n
        assert any(not torch.equal(p, r) for p, r in zip(a.parameters(), c.parameters()))


def test_model_defaults_are_the_jax_ones():
    for mod in (egnn, cgcnn, megnet, dimenet_pp, mxmnet):
        jmod = importlib.import_module(f"gcnn_keras_tpu.models.{mod.__name__.split('.')[-1]}")
        ours = {k: v for k, v in mod.model_default.items() if not k.endswith("in_features")}
        assert ours == jmod.model_default, mod.__name__


def test_model_default_widths_build():
    """Each model at its ``model_default`` widths on a small batch of its
    kind: finite outputs of one per graph."""
    mols = _mols(77)
    for make, graphs, kw in (
            (egnn.make_model, mols, {}), (cgcnn.make_model, mols, {}),
            (megnet.make_model, mols, {}),
            (dimenet_pp.make_model, _with_angle_pairs(mols),
             dict(angle_edge_index_key="angle_indices")),
            (mxmnet.make_model, _multiplex(mols),
             dict(second_edge_index_key="range_indices", **MXM_KEYS))):
        tb = batch_graphs(graphs, device="cpu", **kw)
        out = make(device="cpu")(tb)["output"]
        assert out.shape == (tb.n_graphs, 1) and torch.isfinite(out).all()


@pytest.mark.parametrize("case", ["EGNN edges", "CGCNN edges", "Megnet edges", "Megnet state",
                                  "MXMNet nodes"])
def test_widths_at_build_are_checked(case):
    mols = _mols(78)
    make, kw, graphs, bkw, match = {
        "EGNN edges": (egnn.make_model, dict(edge_in_features=3), mols, {}, "edge_in_features"),
        "CGCNN edges": (cgcnn.make_model, dict(make_distances=False), mols, None,
                        "edge_in_features"),
        "Megnet edges": (megnet.make_model, dict(make_distance=False), mols, None,
                         "edge_in_features"),
        "Megnet state": (megnet.make_model, {}, _mols(78, graph_features=2), {},
                         "graph_in_features"),
        "MXMNet nodes": (mxmnet.make_model, {}, _multiplex(_mols(78, node_features=4)),
                         dict(second_edge_index_key="range_indices", **MXM_KEYS),
                         "in_features")}[case]
    with pytest.raises(ValueError, match=match):
        model = make(device="cpu", **kw)
        model(batch_graphs(graphs, device="cpu", **bkw))


@pytest.mark.parametrize("name", ["DimeNetPP", "Megnet", "CGCNN", "EGNN", "MXMNet",
                                  "kgcnn.literature.DimeNetPP", "gcnn_keras_tpu.models.cgcnn"])
def test_registry_resolves_the_group(name):
    short = name.split(".")[-1]
    module = {"cgcnn": "cgcnn", "DimeNetPP": "dimenet_pp", "Megnet": "megnet", "CGCNN": "cgcnn",
              "EGNN": "egnn", "MXMNet": "mxmnet"}[short]
    mod = importlib.import_module(f"gcnn_keras_tpu_torch.models.{module}")
    assert registry.get_model_class(name) is mod.make_model
    if module in ("cgcnn", "megnet", "dimenet_pp"):
        assert registry.get_model_class(name, "make_crystal_model") is mod.make_crystal_model


# --------------------------------------------------------- the kgcnn goldens


def _mol_golden(name, batch_kw=(), keys=()):
    graphs, weights, ref = _load(name)
    for g in graphs:
        g["node_number"] = g.pop("z").astype(np.int64)
        g["node_coordinates"] = g["xyz"]
    return graphs, list(weights), ref, dict(batch_kw), keys


def _dense(path):
    return [f"{path}/Dense_0/kernel", f"{path}/Dense_0/bias"]


def _mlp(path, depth):
    return [leaf for j in range(depth) for leaf in _dense(f"{path}/dense_{j}")]


def _egnn_golden():
    graphs, weights, ref, bkw, keys = _mol_golden("egnn")
    mapping = ["OptionalInputEmbedding_0/Embed_0/embedding"]
    for blk in ("edge_mlp_0", "coord_mlp_0", "node_mlp_0", "edge_mlp_1", "node_mlp_1",
                "out_mlp"):
        mapping += _mlp(blk, 2)
    return graphs, weights, ref, bkw, keys, "egnn", "make_model", dict(depth=2), \
        dict(edge_in_features=10), mapping


def _megnet_mapping():
    mapping = ["OptionalInputEmbedding_0/Embed_0/embedding"]
    for blk in ("node_ff_0", "edge_ff_0", "state_ff_0"):
        mapping += _mlp(blk, 2)
    for phi in ("node_mlp", "edge_mlp", "env_mlp"):
        mapping += _mlp(f"block_0/{phi}", 3)
    mapping += _dense("set2set_proj_nodes") + _dense("set2set_proj_edges")
    for s in ("set2set_nodes", "set2set_edges"):
        mapping += [f"{s}/kernel", f"{s}/recurrent_kernel", f"{s}/bias"]
    return mapping + _mlp("out_mlp", 3)


def _megnet_golden():
    graphs, weights, ref, bkw, keys = _mol_golden("megnet", keys=("graph_attributes",))
    return graphs, weights, ref, bkw, keys, "megnet", "make_model", dict(nblocks=1), \
        dict(graph_in_features=2), _megnet_mapping()


def _megnet_crystal_golden():
    graphs, weights, ref = _crystal_load("megnet_crystal")
    prepared, keys = _prepare(graphs, with_state=True)
    return prepared, list(weights), ref, {}, keys, "megnet", "make_crystal_model", \
        dict(nblocks=1), dict(graph_in_features=1), _megnet_mapping()


def _cgcnn_golden():
    graphs, keys = _crystals("cgcnn")
    _, weights, ref = _load("cgcnn")
    kw = dict(depth=1, gauss_args={"bins": 40, "distance_max": 8.0},
              conv_layer_args={"units": 64, "activation_s": "softplus",
                               "activation_out": "softplus", "batch_normalization": True},
              node_pooling_args={"pooling_method": "mean"},
              output_mlp={"units": [64, 1], "activation": ["softplus", "linear"],
                          "use_bias": [True, False]})
    mapping = ["OptionalInputEmbedding_0/Embed_0/embedding", *_dense("proj"),
               "conv_0/bn_f/scale", "conv_0/bn_f/bias", "conv_0/bn_s/scale", "conv_0/bn_s/bias",
               "conv_0/bn_out/scale", "conv_0/bn_out/bias", *_dense("conv_0/w_f"),
               *_dense("conv_0/w_s"), None, None, None, None, None, None,
               *_dense("out_mlp/dense_0"), "out_mlp/dense_1/Dense_0/kernel"]
    return graphs, list(weights), ref, {}, keys, "cgcnn", "make_crystal_model", kw, {}, mapping


DIME_GOLDEN_KW = dict(emb_size=32, out_emb_size=32, int_emb_size=16, basis_emb_size=4,
                      num_spherical=4, num_radial=5, num_targets=8,
                      output_init="glorot_uniform",
                      input_embedding={"node": {"input_dim": 96, "output_dim": 32}},
                      output_mlp={"units": [16, 1], "activation": ["swish", "linear"],
                                  "use_bias": [True, False]})


def _dime_output(ob):
    return [f"{ob}/rbf/Dense_0/kernel", f"{ob}/up/Dense_0/kernel",
            *_mlp(ob, 3), f"{ob}/out/Dense_0/kernel"]


def _dime_golden(name, blocks):
    graphs, weights, ref, bkw, keys = _mol_golden(
        name, batch_kw=dict(angle_edge_index_key="angle_indices"))
    np.testing.assert_allclose(weights[1], np.arange(1, 6) * np.pi, rtol=1e-6)
    mapping = ["embed_z/embedding", None, *_dense("embed_rbf"), *_dense("embed_out")]
    for b in range(blocks):
        p = f"interaction_{b}"
        mapping += [f"{p}/{d}/Dense_0/kernel" for d in ("rbf_1", "rbf_2", "sbf_1", "sbf_2")]
        mapping += _dense(f"{p}/ji") + _dense(f"{p}/kj")
        mapping += [f"{p}/down/Dense_0/kernel", f"{p}/up/Dense_0/kernel"]
        mapping += _dense(f"{p}/res_before_0/dense_1") + _dense(f"{p}/res_before_0/dense_2")
        mapping += _dense(f"{p}/skip")
        for r in range(2):
            mapping += _dense(f"{p}/res_after_{r}/dense_1") + _dense(f"{p}/res_after_{r}/dense_2")
    for ob in range(blocks + 1):
        mapping += _dime_output(f"output_{ob}")
    mapping += _dense("output_mlp/dense_0") + ["output_mlp/dense_1/Dense_0/kernel"]
    return graphs, weights, ref, bkw, keys, "dimenet_pp", "make_model", \
        dict(DIME_GOLDEN_KW, num_blocks=blocks), {}, mapping


def _mxmnet_golden():
    graphs, weights, ref, bkw, keys = _mol_golden(
        "mxmnet", batch_kw=dict(MXM_KEYS, second_edge_index_key="range_indices"))
    kw = dict(depth=2, input_embedding={"node": {"input_dim": 95, "output_dim": 32}},
              bessel_basis_local={"num_radial": 8, "cutoff": 5.0, "envelope_exponent": 5},
              bessel_basis_global={"num_radial": 8, "cutoff": 6.0, "envelope_exponent": 5},
              spherical_basis_local={"num_spherical": 3, "num_radial": 4, "cutoff": 5.0,
                                     "envelope_exponent": 5},
              mlp_rbf_kwargs={"units": 32, "activation": "swish"},
              mlp_sbf_kwargs={"units": 32, "activation": "swish"},
              global_mp_kwargs={"units": 32},
              local_mp_kwargs={"units": 32, "output_units": 1,
                               "output_kernel_initializer": "glorot_uniform"},
              output_mlp={"use_bias": [True], "units": [1], "activation": ["linear"]})
    np.testing.assert_allclose(weights[0], np.arange(1, 9) * np.pi, rtol=1e-6)
    np.testing.assert_allclose(weights[4], np.arange(1, 9) * np.pi, rtol=1e-6)

    def res(p):
        return _dense(f"{p}/dense_1") + _dense(f"{p}/dense_2")

    def gmp(p):
        return (_dense(f"{p}/h_mlp") + res(f"{p}/res1") + res(f"{p}/res2") + res(f"{p}/res3")
                + _dense(f"{p}/mlp") + _dense(f"{p}/x_edge_mlp") + [f"{p}/linear/Dense_0/kernel"])

    def lmp(p):
        return (_dense(f"{p}/mlp_kj") + _dense(f"{p}/mlp_ji_1") + _dense(f"{p}/mlp_ji_2")
                + _dense(f"{p}/mlp_jj") + _mlp(f"{p}/mlp_sbf1", 2) + _mlp(f"{p}/mlp_sbf2", 2)
                + [f"{p}/lin_rbf1/Dense_0/kernel", f"{p}/lin_rbf2/Dense_0/kernel"]
                + res(f"{p}/res1") + res(f"{p}/res2") + res(f"{p}/res3")
                + [f"{p}/lin_rbf_out/Dense_0/kernel"] + _dense(f"{p}/h_mlp")
                + _mlp(f"{p}/y_mlp", 3) + _dense(f"{p}/y_W"))
    mapping = ([None, "embed_z/embedding"] + _mlp("mlp_rbf_g", 1) + [None] + gmp("global_0")
               + _mlp("mlp_rbf_l", 1) + _mlp("mlp_sbf_1", 1) + _mlp("mlp_sbf_2", 1)
               + lmp("local_0") + gmp("global_1") + lmp("local_1") + _mlp("output_mlp", 1))
    # the port's pair lists are the reference's, as sets
    for g in graphs:
        for pairing, self_edges, key in (("jk", False, "angle_indices_1"),
                                         ("ik", True, "angle_indices_2")):
            mine = pre.set_angle_pairs_kgcnn(
                {"edge_indices": g["edge_indices"], "node_number": g["node_number"]},
                range_indices="edge_indices", edge_pairing=pairing,
                allow_self_edges=self_edges, out_key="ai")["ai"]
            assert {tuple(r) for r in mine.tolist()} == \
                {tuple(r) for r in np.asarray(g[key]).tolist()}
    return graphs, weights, ref, bkw, keys, "mxmnet", "make_model", kw, {}, mapping


# name -> (recipe, rtol, atol) at the JAX tests' tolerances
GOLDENS = {"egnn": (_egnn_golden, 1e-4, 2e-5), "megnet": (_megnet_golden, 1e-4, 2e-5),
           "megnet_crystal": (_megnet_crystal_golden, 1e-4, 2e-5),
           "cgcnn": (_cgcnn_golden, 1e-4, 2e-5),
           "dimenetpp": (lambda: _dime_golden("dimenetpp", 1), 2e-4, 1e-4),
           "dimenetpp_b0": (lambda: _dime_golden("dimenetpp_b0", 0), 2e-4, 1e-4),
           "mxmnet": (_mxmnet_golden, 2e-4, 1e-4)}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_zoo_c_golden(name):
    """The reference's weights mapped into the JAX variables by the recipe,
    carried into the port; the port's graph outputs against the recorded
    ones. The crystals also on a second, padded batch shape (the padding
    sweep of ``tests/test_crystal_parity.py``)."""
    recipe, rtol, atol = GOLDENS[name]
    graphs, weights, ref, bkw, keys, mod, builder, kw, widths, mapping = recipe()
    jb = jbatch_graphs(graphs, global_keys=keys, **bkw)
    jmake = getattr(importlib.import_module(f"gcnn_keras_tpu.models.{mod}"), builder)
    variables = _apply_mapping(jmake(**kw).init(jax.random.PRNGKey(0), jb), weights, mapping)
    make = getattr(importlib.import_module(f"gcnn_keras_tpu_torch.models.{mod}"), builder)
    model = params_from_jax(make(device="cpu", **kw, **widths),
                            jax.tree_util.tree_map(np.asarray, variables))
    pads = [{}] + ([dict(n_node_pad=512, n_edge_pad=2048)] if "graph_lattice" in keys else [])
    outs = []
    for pad in pads:
        tb = batch_graphs(graphs, global_keys=keys, device="cpu", **bkw, **pad)
        outs.append(model(tb)["output"].detach().numpy()[:len(ref)])
    np.testing.assert_allclose(outs[0], ref, rtol=rtol, atol=atol)
    for out in outs[1:]:
        np.testing.assert_allclose(out, outs[0], rtol=1e-6, atol=1e-7)
