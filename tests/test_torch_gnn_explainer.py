"""The port's GNNExplainer (``xai/gnn_explainer.py``, ``models/gnnexplain.py``)
against the JAX package's on the CPU.

The two recipes of ``tests/test_model_zoo2.py``: SchNet explained through
its integer ``node_number`` for 10 epochs, and the GCN's full surface (the
node mask, ``feature_mask_norm_ord=2.0``, 15 epochs, ``output_to_explain``)
on a 10-node ring. The models carry the JAX ``init`` weights
(``params_from_jax``); the loss history, the three masks and the
``__call__`` importances agree within ``ATOL`` in float32 (the two packages
sum in other orders) and within ``ATOL64`` in float64, where a mask entry
whose gradient were float32 noise against an exact 0 (Adam would move it by
about one learning rate in either direction) agrees too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph.preprocess import set_range
from gcnn_keras_tpu.models import gcn as jgcn
from gcnn_keras_tpu.models import schnet as jschnet
from gcnn_keras_tpu.xai.gnn_explainer import GNNExplainer as JGNNExplainer
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.models import gcn, gnnexplain, registry, schnet
from gcnn_keras_tpu_torch.training.hyper import HyperParameter
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from gcnn_keras_tpu_torch.xai import GNNExplainer

torch.set_num_threads(1)

ATOL = 1e-6  # masks and importances (sigmoids near 0.99), float32
LOSS_RTOL = 1e-5
ATOL64 = 1e-12

SCHNET_KW = dict(depth=1, interaction_args={"units": 8},
                 gauss_args={"bins": 8, "distance_max": 5.0},
                 last_mlp={"units": [8], "activation": ["shifted_softplus"]},
                 output_mlp={"units": [1], "activation": ["linear"]})
SCHNET_EXPLAINER = dict(epochs=10, node_feature_key="node_number")
N_RING, F_RING, C_RING = 10, 6, 3
GCN_KW = dict(depth=1, gcn_args={"units": 8, "activation": "relu"}, output_embedding="node",
              output_mlp={"units": [8, C_RING], "activation": ["relu", "linear"]})
GCN_EXPLAINER = dict(epochs=15, node_mask_loss_weight=1e-3, edge_mask_norm_ord=1.0,
                     feature_mask_norm_ord=2.0)


def mol_graphs(seed=0):
    """``tests/test_model_zoo.py`` ``make_mol_batch``'s two molecules."""
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(2):
        n = rs.randint(4, 7)
        g = {"node_number": rs.choice([1, 6, 8], size=n),
             "node_coordinates": (rs.randn(n, 3) * 1.5).astype(np.float32),
             "graph_labels": np.array([rs.randn()], dtype=np.float32)}
        g = set_range(g, max_distance=6.0, max_neighbours=8)
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(g)
    return graphs


def ring_graph():
    rs = np.random.RandomState(0)
    n = N_RING
    return {"node_attributes": rs.randn(n, F_RING).astype(np.float32),
            "edge_indices": np.array([[i, (i + 1) % n] for i in range(n)]
                                     + [[(i + 1) % n, i] for i in range(n)]),
            "edge_weights": np.ones(2 * n, dtype=np.float32)}


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def as64(a):
    a = np.asarray(a)
    return jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a)


def to_np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def schnet_case():
    graphs = mol_graphs()
    pad = dict(n_node_pad=16, n_edge_pad=128, compute_reverse_edges=True)
    jb = jbatch_graphs(graphs, **pad)
    jm = jschnet.make_model(**SCHNET_KW)
    params = jm.init(jax.random.PRNGKey(0), jb)
    apply = lambda v, b: jm.apply(v, b)  # noqa: E731
    jex = JGNNExplainer(**SCHNET_EXPLAINER)
    ref = {**as_np(jex.explain(apply, params, jb)),
           "call": as_np(jex(apply, params, jb))}
    model = params_from_jax(schnet.make_model(device="cpu", **SCHNET_KW), as_np(params))
    tb = batch_graphs(graphs, device="cpu", **pad)
    ex = GNNExplainer(**SCHNET_EXPLAINER)
    got = {**{k: to_np(v) for k, v in ex.explain(model, tb).items()},
           "call": tuple(to_np(v) for v in ex(model, tb))}
    return got, ref, tb


def gcn_case(float64):
    g = ring_graph()
    jb = jbatch_graphs([g])
    jm = jgcn.make_model(**GCN_KW)
    params = jm.init(jax.random.PRNGKey(0), jb)
    model = params_from_jax(gcn.make_model(device="cpu", in_features=F_RING, **GCN_KW),
                            as_np(params))
    tb = batch_graphs([g], device="cpu")
    default = torch.get_default_dtype()
    try:
        if float64:
            model = model.double()
            tb = tb._map(lambda v: v.double() if v.is_floating_point() else v)
            torch.set_default_dtype(torch.float64)
        with jax.enable_x64(float64):
            if float64:
                params = jax.tree_util.tree_map(as64, params)
                jb = jax.tree_util.tree_map(as64, jb)
            apply = lambda v, b: jm.apply(v, b)  # noqa: E731
            base = jm.apply(params, jb)["output"]
            target = base.at[:, 0].set(base[:, 0] + 1.0)
            jex = JGNNExplainer(**GCN_EXPLAINER)
            ref = {**as_np(jex.explain(apply, params, jb)),
                   "call": as_np(jex(apply, params, jb, output_to_explain=target))}
        ex = GNNExplainer(**GCN_EXPLAINER)
        got = {**{k: to_np(v) for k, v in ex.explain(model, tb).items()},
               "call": tuple(to_np(v) for v in ex(model, tb,
                                                  output_to_explain=torch.tensor(
                                                      np.asarray(target))))}
    finally:
        torch.set_default_dtype(default)
    return got, ref, tb


@pytest.fixture(scope="module")
def gcn32():
    return gcn_case(False)


@pytest.fixture(scope="module")
def gcn64():
    return gcn_case(True)


def check(got, ref, atol, loss_rtol):
    for key in ("edge_mask", "feature_mask", "node_mask"):
        assert got[key].shape == ref[key].shape, key
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=atol, err_msg=key)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=loss_rtol, atol=0)
    for name, g, r in zip(("node_importances", "edge_importances"), got["call"], ref["call"]):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)


def test_schnet_recipe_matches_jax(schnet_case):
    """10 epochs through SchNet's integer ``node_number``: the feature mask
    (F = 1) takes only its penalty; the edge mask scales the batch's
    distances, which SchNet computes again from the coordinates."""
    got, ref, tb = schnet_case
    check(got, ref, ATOL, LOSS_RTOL)
    assert got["losses"].shape == (10,)
    assert got["call"][0].shape == (tb.n_node,) and got["call"][1].shape == (tb.n_edge,)
    assert np.isfinite(got["call"][0]).all()


def test_gcn_full_surface_matches_jax(gcn32):
    """Three masks with their norms, the loss history falling from the
    first epoch to the last, and ``output_to_explain``."""
    got, ref, tb = gcn32
    check(got, ref, ATOL, LOSS_RTOL)
    assert got["feature_mask"].shape == (F_RING,)
    assert got["node_mask"].shape == (tb.n_node,) and got["losses"].shape == (15,)
    assert got["losses"][-1] <= got["losses"][0]
    assert np.isfinite(got["call"][1]).all()


def test_gcn_full_surface_matches_jax_in_float64(gcn64):
    got, ref, _ = gcn64
    assert got["edge_mask"].dtype == np.float64
    check(got, ref, ATOL64, 1e-12)


def test_gnnexplain_resolves_to_the_port():
    """``get_model_class`` by short name, by the JAX file's path and by the
    reference's, and ``HyperParameter``, which passes ``device``."""
    for name in ("GNNExplain", "gcnn_keras_tpu.models.gnnexplain",
                 "kgcnn.literature.GNNExplain"):
        assert registry.get_model_class(name) is gnnexplain.make_model
    hyper = HyperParameter({"model": {"module_name": "GNNExplain",
                                      "config": {"epochs": 4, "learning_rate": 0.05}}})
    explainer = hyper.make_model(device="cpu")
    assert isinstance(explainer, GNNExplainer)
    assert (explainer.epochs, explainer.learning_rate) == (4, 0.05)
    assert explainer.device == torch.device("cpu")


def test_explainer_device_moves_the_batch(gcn32):
    """``device`` is where the explanation runs: a batch given on another
    device is moved there (here: the CPU, named), and the masks live
    there; the explanation is the one of the batch's own device."""
    _, _, tb = gcn32
    model = gcn.make_model(device="cpu", in_features=F_RING, **GCN_KW)
    a = GNNExplainer(epochs=2, device="cpu").explain(model, tb)
    b = GNNExplainer(epochs=2).explain(model, tb)
    for key in a:
        assert a[key].device == torch.device("cpu")
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
