"""The port's GCN against the JAX package, on the CPU.

The host-side preprocessing (the uniform and the symmetrically normalized
edge weights) and the synthetic citation graph are numpy on both sides and
must be equal bit for bit. The models run on shared weights (the JAX
``init`` params, perturbed by seeded noise so that every bias matters,
carried by ``params_from_jax``): outputs agree to ``rtol=1e-5`` and
``atol=1e-5 * max|reference|``, the masked cross-entropy and its parameter
gradients as ``test_torch_training.py`` holds them (loss ``rtol 1e-5``,
each gradient within ``1e-4`` of that tensor's largest entry).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.data.datasets.synthetic import SyntheticCitationDataset as JCitation
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.layers.conv.gcn import GCNConv as JGCNConv
from gcnn_keras_tpu.models import gcn as jgcn
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticCitationDataset
from gcnn_keras_tpu_torch.graph import preprocess
from gcnn_keras_tpu_torch.layers.conv.gcn import GCNConv
from gcnn_keras_tpu_torch.models import gcn
from gcnn_keras_tpu_torch.training import losses
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

SMALL = dict(depth=2, gcn_args={"units": 24, "activation": "relu", "pooling_method": "sum"},
             input_embedding={"node": {"input_dim": 95, "output_dim": 16}},
             output_mlp={"units": [16, 1], "activation": ["relu", "linear"],
                         "use_bias": [True, False]})


def _graphs(seed, n_graphs, features=None):
    """Random undirected graphs with integer node numbers, or ``features``
    float columns, and normalized uniform edge weights; node weights for
    ``GCNWeighted``."""
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_graphs):
        n = rs.randint(3, 11)
        pairs = rs.randint(0, n, size=(2 * n, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        g = {"edge_indices": np.unique(np.concatenate([pairs, pairs[:, ::-1]]), axis=0)}
        if features is None:
            g["node_number"] = rs.randint(1, 20, size=n)
        else:
            g["node_attributes"] = rs.randn(n, features).astype(np.float32)
        g["node_weights"] = rs.rand(n, 1).astype(np.float32)
        graphs.append(jpre.normalize_edge_weights_symmetric(jpre.set_edge_weights_uniform(g)))
    return graphs


def _perturbed(params, seed, scale=0.1):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rs.randn(*np.shape(x))).astype(np.float32), params)


def _shared(jmake, make, kw, jb, seed, in_features=None):
    jm = jmake(**kw)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jb), seed)
    model = params_from_jax(make(device="cpu", in_features=in_features, **kw), params)
    return jm, params, model


def _close(out, ref, scale=None):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * scale)


def _equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# ------------------------------------------------------------ host side


@pytest.mark.parametrize("case", ["node numbers", "no node arrays", "given weights"])
def test_edge_weights_equal_jax_bit_for_bit(case):
    rs = np.random.RandomState(2)
    ei = rs.randint(0, 12, size=(40, 2))
    g = {"edge_indices": ei}
    if case == "node numbers":
        g["node_number"] = np.arange(15)  # isolated nodes past the largest id
    if case == "given weights":
        g["edge_weights"] = rs.rand(40, 1).astype(np.float32)
        _equal(preprocess.normalize_edge_weights_symmetric(g),
               jpre.normalize_edge_weights_symmetric(g))
        return
    _equal(preprocess.set_edge_weights_uniform(g, value=0.5),
           jpre.set_edge_weights_uniform(g, value=0.5))
    _equal(preprocess.normalize_edge_weights_symmetric(g), jpre.normalize_edge_weights_symmetric(g))
    uniform = preprocess.set_edge_weights_uniform(g)
    _equal(preprocess.normalize_edge_weights_symmetric(uniform),
           jpre.normalize_edge_weights_symmetric(jpre.set_edge_weights_uniform(g)))


def test_synthetic_citation_graph_equals_jax_bit_for_bit():
    kw = dict(num_nodes=300, num_classes=7, feature_dim=16, avg_degree=4, seed=3)
    ours, ref = SyntheticCitationDataset(**kw), JCitation(**kw)
    assert len(ours) == len(ref) == 1
    _equal(ours[0], dict(ref[0]))
    # the bench applies the weights a second time; the result is the same
    again = preprocess.normalize_edge_weights_symmetric(preprocess.set_edge_weights_uniform(ours[0]))
    np.testing.assert_array_equal(again["edge_weights"], ours[0]["edge_weights"])


# ------------------------------------------------------------ modules


@pytest.mark.parametrize("normalize", [False, True])
def test_gcn_conv_matches_jax(normalize):
    graphs = _graphs(4, 5, features=12)
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    x = np.random.RandomState(5).randn(tb.n_node, 12).astype(np.float32)
    ew = np.array(jb.edges["edge_weights"])
    jconv = JGCNConv(units=8, normalize_by_weights=normalize)
    params = _perturbed(jconv.init(jax.random.PRNGKey(0), jb, jnp.asarray(x), jnp.asarray(ew)), 6)
    conv = params_from_jax(GCNConv(12, 8, normalize_by_weights=normalize), params)
    _close(conv(tb, torch.from_numpy(x), torch.from_numpy(ew)),
           jconv.apply(params, jb, jnp.asarray(x), jnp.asarray(ew)))


@pytest.mark.parametrize("features", [None, 12])
@pytest.mark.parametrize("output_embedding", ["graph", "node"])
def test_gcn_matches_jax(features, output_embedding):
    graphs = _graphs(7, 6, features=features)
    kw = dict(SMALL, output_embedding=output_embedding)
    jm, params, model = _shared(jgcn.make_model, gcn.make_model, kw, jbatch_graphs(graphs), 8,
                                in_features=features)
    _close(model(batch_graphs(graphs, device="cpu"))["output"],
           jm.apply(params, jbatch_graphs(graphs))["output"])


@pytest.mark.parametrize("output_embedding", ["graph", "node"])
def test_gcn_weighted_matches_jax(output_embedding):
    graphs = _graphs(9, 6, features=10)
    kw = dict(SMALL, output_embedding=output_embedding)
    jm, params, model = _shared(jgcn.make_model_weighted, gcn.make_model_weighted, kw,
                                jbatch_graphs(graphs), 10, in_features=10)
    _close(model(batch_graphs(graphs, device="cpu"))["output"],
           jm.apply(params, jbatch_graphs(graphs))["output"])


def test_masked_cross_entropy_gradients_match_jax():
    """``bench.py`` ``sec_gcn_cora``'s loss at a small size: a citation graph
    (200 nodes, 16 features, 5 classes), node logits, the masked
    categorical cross-entropy over the real nodes; the loss and
    ``jax.value_and_grad`` of it on shared weights."""
    g = SyntheticCitationDataset(num_nodes=200, num_classes=5, feature_dim=16, seed=11)[0]
    jb, tb = jbatch_graphs([g]), batch_graphs([g], device="cpu")
    labels = np.pad(g["node_labels"], (0, tb.n_node - 200))
    kw = dict(depth=3, gcn_args={"units": 20}, output_embedding="node",
              output_mlp={"units": [5], "activation": ["linear"]})
    jm, params, model = _shared(jgcn.make_model, gcn.make_model, kw, jb, 12, in_features=16)

    def jloss(p):
        return jlosses.masked_categorical_crossentropy(jm.apply(p, jb)["output"],
                                                       jnp.asarray(labels), jb.node_mask)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = losses.masked_categorical_crossentropy(model(tb)["output"], tb.nodes["node_labels"],
                                                  tb.node_mask)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    ref = dict(params_from_jax(gcn.make_model(device="cpu", in_features=16, **kw),
                               jax.tree_util.tree_map(np.asarray, ref_grads)).named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(grads) == len(ref) == 2 + 2 * 3 + 2
    for n, grad in zip(names, grads):
        r = ref[n].detach().numpy()
        assert np.abs(grad.numpy() - r).max() <= 1e-4 * np.abs(r).max(), n


def test_float_input_gcn_takes_the_flax_tree_whole():
    """A GCN built with the feature width holds no embedding table, so the
    flax tree of a float-input GCN fills it with nothing left over; a GCN
    built for node numbers names the width it lacks."""
    graphs = _graphs(13, 3, features=12)
    jb = jbatch_graphs(graphs)
    jm, params, model = _shared(jgcn.make_model, gcn.make_model, SMALL, jb, 14, in_features=12)
    assert model.embedding is None
    assert not any("embedding" in n for n, _ in model.named_parameters())
    assert "OptionalInputEmbedding_0" not in params["params"]
    with pytest.raises(KeyError, match="Embed_0"):
        params_from_jax(gcn.make_model(device="cpu", **SMALL), params)
    with pytest.raises(ValueError, match="in_features"):
        gcn.make_model(device="cpu", **SMALL)(batch_graphs(graphs, device="cpu"))
    with pytest.raises(ValueError, match="width 12"):
        model(batch_graphs(_graphs(13, 3, features=5), device="cpu"))


# ------------------------------------------------------------ chip_smoke.py


def test_chip_smoke_gcn_cora_is_the_bench_configuration():
    """``chip_smoke.py``'s ``gcn_cora_train`` builds ``bench.py``
    ``sec_gcn_cora``'s model and batch (at 300 nodes here)."""
    ref = jgcn.make_model(depth=3, gcn_args={"units": 140}, output_embedding="node",
                          output_mlp={"units": [70], "activation": ["linear"]}).config
    ours = gcn.make_model(device="cpu", **chip_smoke.GCN_CORA_KW).config
    assert {k: v for k, v in ours.items() if k != "in_features"} == ref
    assert ours["in_features"] == 1433
    g = JCitation(num_nodes=300, num_classes=70, feature_dim=1433, avg_degree=4, seed=3)[0]
    jb = jbatch_graphs([jpre.normalize_edge_weights_symmetric(jpre.set_edge_weights_uniform(g))])
    tb = chip_smoke.citation_batch(3, 300, "cpu")
    for name in ("senders", "receivers", "node_mask", "edge_mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    for key in ("node_attributes", "node_labels"):
        np.testing.assert_array_equal(tb.nodes[key].numpy(), np.asarray(jb.nodes[key]))
    np.testing.assert_array_equal(tb.edges["edge_weights"].numpy(),
                                  np.asarray(jb.edges["edge_weights"]))
