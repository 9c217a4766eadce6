"""The port's first group of the model zoo (GIN, GraphSAGE, GAT, GATv2,
RGCN, GNN-FiLM, INorp), its layers and pools, against the JAX package on
the CPU, and against the executed-kgcnn goldens.

Inputs are small graphs made from a numpy seed; weights are the JAX
``init`` parameters perturbed by seeded noise (so that every bias and
running statistic matters), carried into the port by ``params_from_jax``.
The JAX side runs as its own tests run it on the CPU, where the Pallas
gate routes every sum to XLA; the port runs the segment-sum kernel's plain
version. Outputs agree to ``rtol=1e-5``, ``atol=1e-6``; a masked graph
MAE's parameter gradients within ``1e-5`` of each tensor's largest entry.
The goldens take the recipes and tolerances of
``tests/test_reference_parity.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.layers import aggr as jaggr
from gcnn_keras_tpu.layers.conv import basic as jbasic
from gcnn_keras_tpu.models import gat as jgat
from gcnn_keras_tpu.models import gatv2 as jgatv2
from gcnn_keras_tpu.models import gin as jgin
from gcnn_keras_tpu.models import gnnfilm as jgnnfilm
from gcnn_keras_tpu.models import inorp as jinorp
from gcnn_keras_tpu.models import rgcn as jrgcn
from gcnn_keras_tpu.models import sage as jsage
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers import aggr
from gcnn_keras_tpu_torch.layers.conv import basic
from gcnn_keras_tpu_torch.layers.pool import Set2Set
from gcnn_keras_tpu_torch.models import gat, gatv2, gin, gnnfilm, inorp, registry, rgcn, sage
from gcnn_keras_tpu_torch.training import losses
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from tests.test_reference_parity import _apply_mapping, _load

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5  # of each gradient tensor's largest entry
GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 2e-5

NODE16 = {"node": {"input_dim": 20, "output_dim": 16}}
EDGE8 = {"input_dim": 5, "output_dim": 8}
HEAD = {"units": 16, "use_edge_features": True, "use_bias": True,
        "use_final_activation": False, "activation": "leaky_relu"}
OUT = {"units": [16, 1], "activation": ["relu", "linear"]}


def _graphs(seed, n_graphs=8, node_features=None, edge_features=None, edge_classes=5,
            relations=None, graph_features=None):
    """``n_graphs`` random directed graphs of 3-10 nodes: integer node
    numbers (or ``node_features`` float columns), integer edge attributes
    below ``edge_classes`` (or ``edge_features`` float columns; 0: none),
    edge weights, relations below ``relations``, ``graph_features`` float
    graph attributes, and a graph label."""
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_graphs):
        n = rs.randint(3, 11)
        pairs = rs.randint(0, n, size=(3 * n, 2))
        ei = np.unique(pairs[pairs[:, 0] != pairs[:, 1]], axis=0)
        m = len(ei)
        g = {"edge_indices": ei, "edge_weights": rs.rand(m, 1).astype(np.float32),
             "graph_labels": rs.randn(1).astype(np.float32)}
        if node_features is None:
            g["node_number"] = rs.randint(1, 20, size=n)
        else:
            g["node_attributes"] = rs.randn(n, node_features).astype(np.float32)
        if edge_features is None:
            g["edge_attributes"] = rs.randint(0, edge_classes, size=m)
        elif edge_features:
            g["edge_attributes"] = rs.randn(m, edge_features).astype(np.float32)
        if relations:
            g["edge_relations"] = rs.randint(0, relations, size=m)
        if graph_features:
            g["graph_attributes"] = rs.randn(graph_features).astype(np.float32)
        graphs.append(g)
    return graphs


def _perturbed(tree, seed, scale=0.1):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rs.randn(*np.shape(x))).astype(np.float32), tree)


def _close(out, ref, rtol=RTOL, atol=ATOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


def _batches(graphs, keys=()):
    return (jbatch_graphs(graphs, global_keys=keys),
            batch_graphs(graphs, global_keys=keys, device="cpu"))


# --------------------------------------------------------- the pools


def _pool_inputs(seed=3):
    graphs = _graphs(seed, relations=4)
    jb, tb = _batches(graphs)
    rs = np.random.RandomState(seed + 1)
    vals = rs.randn(tb.n_edge, 6).astype(np.float32)
    logits = rs.randn(tb.n_edge, 1).astype(np.float32)
    return jb, tb, vals, logits


def test_gather_state_matches_jax():
    jb, tb, _, _ = _pool_inputs()
    state = np.random.RandomState(5).randn(tb.n_graphs, 3).astype(np.float32)
    _close(aggr.gather_state(torch.from_numpy(state), tb),
           jaggr.gather_state(jnp.asarray(state), jb), rtol=0, atol=0)


def test_pool_edges_to_nodes_attention_matches_jax():
    jb, tb, vals, logits = _pool_inputs()
    _close(aggr.pool_edges_to_nodes_attention(tb, torch.from_numpy(vals),
                                              torch.from_numpy(logits)),
           jaggr.pool_edges_to_nodes_attention(jb, jnp.asarray(vals), jnp.asarray(logits)))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_relational_pool_edges_to_nodes_matches_jax(mode):
    jb, tb, vals, _ = _pool_inputs()
    rel = np.asarray(tb.edges["edge_relations"])
    _close(aggr.relational_pool_edges_to_nodes(tb, torch.from_numpy(vals),
                                               torch.from_numpy(rel), 4, mode=mode),
           jaggr.relational_pool_edges_to_nodes(jb, jnp.asarray(vals), jnp.asarray(rel), 4,
                                                mode=mode))


def test_pool_nodes_to_graph_attention_matches_jax():
    jb, tb, _, _ = _pool_inputs()
    rs = np.random.RandomState(7)
    vals = rs.randn(tb.n_node, 5).astype(np.float32)
    logits = rs.randn(tb.n_node, 1).astype(np.float32)
    _close(aggr.pool_nodes_to_graph_attention(tb, torch.from_numpy(vals),
                                              torch.from_numpy(logits)),
           jaggr.pool_nodes_to_graph_attention(jb, jnp.asarray(vals), jnp.asarray(logits)))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_pool_edges_to_graph_matches_jax(mode):
    jb, tb, vals, _ = _pool_inputs()
    _close(aggr.pool_edges_to_graph(tb, torch.from_numpy(vals), mode=mode),
           jaggr.pool_edges_to_graph(jb, jnp.asarray(vals), mode=mode))


def test_attention_pools_sum_on_the_kernel():
    """The attention pools' weighted sums are sorted segment-sums (kernel
    #1); the relational and edge-to-graph pools take ``index_add_``, as JAX
    takes XLA's scatter for their unsorted ids."""
    jb, tb, vals, logits = _pool_inputs()
    with chip_smoke.captured_calls() as calls:
        aggr.pool_edges_to_nodes_attention(tb, torch.from_numpy(vals), torch.from_numpy(logits))
        aggr.pool_nodes_to_graph_attention(tb, torch.ones(tb.n_node, 2), torch.ones(tb.n_node, 1))
        aggr.relational_pool_edges_to_nodes(tb, torch.from_numpy(vals),
                                            tb.edges["edge_relations"], 4)
        aggr.pool_edges_to_graph(tb, torch.from_numpy(vals))
    assert {k: len(v) for k, v in calls.items() if v} == {"sorted_segment_sum": 2}


# --------------------------------------------------------- the convolutions


def _conv_case(name):
    """(JAX module, port module, extra call args) of each conv at 12
    features in, 8 out; the heads also see 4 edge features."""
    f, u, e = 12, 8, 4
    if name == "GIN":
        return jbasic.GIN(epsilon_learnable=True), basic.GIN(epsilon_learnable=True), False
    if name == "GINE":
        return (jbasic.GINE(epsilon_learnable=True), basic.GINE(epsilon_learnable=True), True)
    if name == "GAT":
        return (jbasic.AttentionHeadGAT(u, use_edge_features=True),
                basic.AttentionHeadGAT(f, u, e, use_edge_features=True), True)
    if name == "GATv2":
        return (jbasic.AttentionHeadGATV2(u, use_edge_features=True),
                basic.AttentionHeadGATV2(f, u, e, use_edge_features=True), True)
    if name == "MultiHeadGATV2":
        return (jbasic.MultiHeadGATV2(u, num_heads=3, concat_heads=True),
                basic.MultiHeadGATV2(f, u, num_heads=3, edge_features=e), True)
    if name == "MultiHeadGATV2-mean":
        return (jbasic.MultiHeadGATV2(u, num_heads=2, concat_heads=False),
                basic.MultiHeadGATV2(f, u, num_heads=2, edge_features=e, concat_heads=False),
                True)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["GIN", "GINE", "GAT", "GATv2", "MultiHeadGATV2",
                                  "MultiHeadGATV2-mean"])
def test_conv_matches_jax(name):
    jb, tb = _batches(_graphs(11, edge_features=0))
    rs = np.random.RandomState(12)
    x = rs.randn(tb.n_node, 12).astype(np.float32)
    width = 12 if name.startswith("GIN") else 4
    ed = rs.randn(tb.n_edge, width).astype(np.float32)
    jmod, mod, with_edges = _conv_case(name)
    args = (jnp.asarray(x), jnp.asarray(ed)) if with_edges else (jnp.asarray(x),)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jb, *args), 13)
    params_from_jax(mod, params)
    targs = (torch.from_numpy(x), torch.from_numpy(ed)) if with_edges else (torch.from_numpy(x),)
    _close(mod(tb, *targs), jmod.apply(params, jb, *args))


@pytest.mark.parametrize("relations", [5, 20])
@pytest.mark.parametrize("weights", [False, True])
def test_relational_gcn_conv_matches_jax(relations, weights):
    """Both of ``RelationalDense``'s paths: one matmul (5 relations) and
    the per-relation loop past its threshold of 16 (20)."""
    jb, tb = _batches(_graphs(14, relations=relations, edge_features=0))
    x = np.random.RandomState(15).randn(tb.n_node, 12).astype(np.float32)
    rel = np.asarray(tb.edges["edge_relations"])
    ew = np.asarray(tb.edges["edge_weights"]) if weights else None
    jconv = jbasic.RelationalGCNConv(units=8, num_relations=relations)
    jargs = (jnp.asarray(x), jnp.asarray(rel), None if ew is None else jnp.asarray(ew))
    params = _perturbed(jconv.init(jax.random.PRNGKey(0), jb, *jargs), 16)
    conv = params_from_jax(basic.RelationalGCNConv(12, 8, relations), params)
    _close(conv(tb, torch.from_numpy(x), torch.from_numpy(rel),
                None if ew is None else torch.from_numpy(ew)),
           jconv.apply(params, jb, *jargs))


def test_matmul_messages_matches_jax():
    rs = np.random.RandomState(17)
    trafo, edges = rs.randn(9, 5, 4).astype(np.float32), rs.randn(9, 4).astype(np.float32)
    _close(basic.matmul_messages(torch.from_numpy(trafo), torch.from_numpy(edges)),
           jbasic.matmul_messages(jnp.asarray(trafo), jnp.asarray(edges)))


# --------------------------------------------------------- the models

# name -> (JAX builder, port builder, small config, _graphs kwargs, global keys)
MODELS = {
    "GIN": (jgin.make_model, gin.make_model,
            dict(depth=2, input_embedding=NODE16,
                 gin_mlp={"units": [16, 16], "activation": ["relu", "linear"],
                          "use_normalization": True, "normalization_technique": "graph_batch"},
                 last_mlp={"units": [16, 16], "activation": ["relu", "linear"]}),
            dict(edge_features=0), ()),
    "GIN-edge": (jgin.make_model_edge, gin.make_model_edge,
                 dict(depth=2, input_embedding=NODE16, edge_in_features=6,
                      gin_args={"pooling_method": "sum", "epsilon_learnable": True},
                      gin_mlp={"units": [16, 16], "activation": ["relu", "linear"]},
                      last_mlp={"units": [16], "activation": ["relu"]}),
                 dict(edge_features=6), ()),
    "GIN-node": (jgin.make_model, gin.make_model,
                 dict(depth=2, in_features=10, output_embedding="node",
                      gin_mlp={"units": [16, 16], "activation": ["relu", "linear"]},
                      last_mlp={"units": [16], "activation": ["relu"]}),
                 dict(node_features=10, edge_features=0), ()),
    "GraphSAGE": (jsage.make_model, sage.make_model,
                  dict(depth=2, input_embedding={**NODE16, "edge": EDGE8},
                       node_mlp_args={"units": [24, 16], "activation": ["relu", "linear"]},
                       edge_mlp_args={"units": 24, "activation": "relu"}, output_mlp=OUT),
                  {}, ()),
    "GraphSAGE-float": (jsage.make_model, sage.make_model,
                        dict(depth=2, in_features=10, edge_in_features=3,
                             node_mlp_args={"units": [24, 16], "activation": ["relu", "linear"]},
                             edge_mlp_args={"units": 24, "activation": "relu"},
                             pooling_args={"pooling_method": "sum"}, output_mlp=OUT),
                        dict(node_features=10, edge_features=3), ()),
    "GAT": (jgat.make_model, gat.make_model,
            dict(depth=2, input_embedding={**NODE16, "edge": EDGE8}, attention_args=HEAD,
                 attention_heads_num=2, output_mlp=OUT),
            {}, ()),
    "GAT-concat": (jgat.make_model, gat.make_model,
                   dict(depth=2, input_embedding=NODE16, edge_in_features=0,
                        attention_args={**HEAD, "use_final_activation": True},
                        attention_heads_num=2, attention_heads_concat=True, output_mlp=OUT),
                   dict(edge_features=0), ()),
    "GATv2": (jgatv2.make_model, gatv2.make_model,
              dict(depth=2, input_embedding={**NODE16, "edge": EDGE8}, attention_args=HEAD,
                   attention_heads_num=2, output_mlp=OUT),
              {}, ()),
    "RGCN": (jrgcn.make_model, rgcn.make_model,
             dict(depth=2, input_embedding=NODE16,
                  dense_relation_kwargs={"units": 16, "num_relations": 20}, output_mlp=OUT),
             dict(relations=20, edge_features=0), ()),
    "RGCN-5": (jrgcn.make_model, rgcn.make_model,
               dict(depth=2, input_embedding=NODE16,
                    dense_relation_kwargs={"units": 16, "num_relations": 5}, output_mlp=OUT),
               dict(relations=5, edge_features=0), ()),
    "GNNFilm": (jgnnfilm.make_model, gnnfilm.make_model,
                dict(depth=2, input_embedding=NODE16,
                     dense_relation_kwargs={"units": 16, "num_relations": 20},
                     dense_modulation_kwargs={"units": 16, "num_relations": 20,
                                              "activation": "sigmoid"},
                     output_mlp=OUT),
                dict(relations=20, edge_features=0), ()),
    "INorp": (jinorp.make_model, inorp.make_model,
              dict(depth=2, input_embedding={**NODE16, "edge": {"input_dim": 15, "output_dim": 8}},
                   node_mlp_args={"units": [24, 16], "activation": ["relu", "linear"]},
                   edge_mlp_args={"units": [24, 24, 16], "activation": "relu"},
                   graph_in_features=3, output_mlp=OUT),
              dict(edge_classes=15, graph_features=3), ("graph_attributes",)),
    "INorp-bare": (jinorp.make_model, inorp.make_model,
                   dict(depth=2, input_embedding=NODE16, edge_in_features=0,
                        node_mlp_args={"units": [24, 16], "activation": ["relu", "linear"]},
                        edge_mlp_args={"units": [24, 16], "activation": "relu"},
                        pooling_args={"pooling_method": "mean"}, output_mlp=OUT),
                   dict(edge_features=0), ()),
}


def _shared(name, seed=21, train=False):
    """The JAX model, its perturbed variables, the port model holding them,
    and the two batches of the case's graphs."""
    jmake, make, kw, gkw, keys = MODELS[name]
    graphs = _graphs(seed, **gkw)
    jb, tb = _batches(graphs, ("graph_labels",) + keys)
    jkw = {k: v for k, v in kw.items() if not k.endswith("in_features")}
    jm = jmake(**jkw)
    variables = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jb), seed + 1)
    if "batch_stats" in variables:  # running variances stay positive
        variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    model = params_from_jax(make(device="cpu", **kw), variables)
    return jm, variables, model, jb, tb


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    jm, variables, model, jb, tb = _shared(name)
    _close(model(tb)["output"], jm.apply(variables, jb)["output"])


@pytest.mark.parametrize("name", list(MODELS))
def test_model_loss_gradients_match_jax(name):
    """A masked graph MAE (a node MAE for node outputs) and its gradients
    along every parameter against ``jax.value_and_grad``."""
    jm, variables, model, jb, tb = _shared(name)
    node = MODELS[name][2].get("output_embedding") == "node"

    def jloss(params):
        out = jm.apply({**variables, "params": params}, jb)["output"]
        if node:
            return jlosses.masked_node_mae(out, jnp.zeros_like(out), jb.node_mask)
        return jlosses.masked_graph_mae(out, jb.globals["graph_labels"], jb.globals["graph_mask"])
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    out = model(tb)["output"]
    loss = losses.masked_node_mae(out, torch.zeros_like(out), tb.node_mask) if node else \
        losses.masked_graph_mae(out, tb.globals["graph_labels"], tb.globals["graph_mask"])
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    ref = dict(params_from_jax(MODELS[name][1](device="cpu", **MODELS[name][2]),
                               {**variables, "params": jax.tree_util.tree_map(
                                   np.asarray, ref_grads)}).named_parameters())
    assert sorted(ref) == sorted(names)
    for n, g in zip(names, grads):
        r = ref[n].detach().numpy()
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * np.abs(r).max(), n


@pytest.mark.parametrize("name", ["GIN", "GIN-edge"])
def test_gin_batch_norm_in_training_matches_jax(name):
    """``train=True``: the output by the masked batch statistics, and the
    running averages it leaves, against JAX's ``mutable=["batch_stats"]``."""
    jm, variables, model, jb, tb = _shared(name)
    kw = MODELS[name][2]
    if not kw["gin_mlp"].get("use_normalization"):
        kw = dict(kw, gin_mlp=dict(kw["gin_mlp"], use_normalization=True))
        jm = MODELS[name][0](**{k: v for k, v in kw.items() if not k.endswith("in_features")})
        variables = _perturbed(jm.init(jax.random.PRNGKey(0), jb), 22)
        variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
        model = params_from_jax(MODELS[name][1](device="cpu", **kw), variables)
    ref, updates = jm.apply(variables, jb, train=True, mutable=["batch_stats"])
    _close(model(tb, train=True)["output"], ref["output"])
    stats = {n: b for n, b in model.named_buffers()}
    flat = jax.tree_util.tree_flatten_with_path(updates["batch_stats"])[0]
    assert len(flat) == len(stats) > 0
    for path, value in flat:
        key = ".".join(p.key for p in path)
        _close(stats[key], value)


def test_model_defaults_are_the_jax_ones():
    """Each module's ``model_default`` is the JAX one, with the port's input
    widths beside it."""
    pairs = [(gin, jgin), (sage, jsage), (gat, jgat), (rgcn, jrgcn), (gnnfilm, jgnnfilm),
             (inorp, jinorp)]
    for mod, jmod in pairs:
        ours = {k: v for k, v in mod.model_default.items() if not k.endswith("in_features")}
        assert ours == jmod.model_default, mod.__name__
    assert gatv2.make_model is gat.make_model_v2 and gatv2.model_default is gat.model_default


def test_model_default_widths_build():
    """Every model at its ``model_default`` widths on a small batch of
    integer node numbers, integer edge attributes and relations."""
    graphs = _graphs(30, edge_classes=5, relations=20)
    tb = batch_graphs(graphs, device="cpu")
    for make in (gin.make_model, sage.make_model, gat.make_model, gatv2.make_model,
                 rgcn.make_model, gnnfilm.make_model):
        out = make(device="cpu")(tb)["output"]
        assert out.shape == (tb.n_graphs, 1) and torch.isfinite(out).all()
    out = inorp.make_model(device="cpu")(batch_graphs(_graphs(30, edge_classes=15),
                                                      device="cpu"))["output"]
    assert torch.isfinite(out).all()


# --------------------------------------------------------- what raises


@pytest.mark.parametrize("name", ["GIN", "GAT", "GATv2", "GraphSAGE", "RGCN", "GNNFilm",
                                  "INorp", "gcnn_keras_tpu.models.sage",
                                  "kgcnn.literature.GNNFilm", "DMPNN", "CMPNN", "NMPN",
                                  "AttentiveFP", "HamNet", "MEGAN",
                                  "gcnn_keras_tpu.models.cmpnn", "kgcnn.literature.MEGAN"])
def test_registry_resolves_the_group(name):
    """The zoo's first and second groups (short names and module
    paths)."""
    from gcnn_keras_tpu_torch.models import attentivefp, cmpnn, dmpnn, hamnet, megan, nmpn
    mods = {"GIN": gin, "GAT": gat, "GATv2": gatv2, "GraphSAGE": sage, "RGCN": rgcn,
            "GNNFilm": gnnfilm, "INorp": inorp, "gcnn_keras_tpu.models.sage": sage,
            "kgcnn.literature.GNNFilm": gnnfilm, "DMPNN": dmpnn, "CMPNN": cmpnn,
            "NMPN": nmpn, "AttentiveFP": attentivefp, "HamNet": hamnet, "MEGAN": megan,
            "gcnn_keras_tpu.models.cmpnn": cmpnn, "kgcnn.literature.MEGAN": megan}
    assert registry.get_model_class(name) is mods[name].make_model


# the JAX table's three names the zoo's groups left: name -> file
REST_OF_THE_ZOO = {"GNNExplain": "gnnexplain", "MAT": "mat", "Unet": "unet"}


@pytest.mark.parametrize("name", sorted(REST_OF_THE_ZOO))
def test_registry_still_raises_on_the_rest_of_the_zoo(name):
    """MAT and Unet (slice 15) and GNNExplain (slice 19) resolve to the
    port's modules, by short name and by file: none raises any more."""
    import importlib
    path = f"gcnn_keras_tpu.models.{REST_OF_THE_ZOO[name]}"
    mod = importlib.import_module(f"gcnn_keras_tpu_torch.models.{REST_OF_THE_ZOO[name]}")
    assert registry.get_model_class(name) is mod.make_model
    assert registry.get_model_class(path) is mod.make_model


def test_inorp_set2set_raises_when_built():
    """``use_set2set=True`` builds Set2Set where the nodes are as wide as its
    channels, and then matches JAX; at the defaults (50 against 32) it
    raises ``ValueError`` when built, where the JAX model fails at its first
    call. A node output builds no readout."""
    with pytest.raises(ValueError, match="channels"):
        inorp.make_model(device="cpu", use_set2set=True)
    inorp.make_model(device="cpu", use_set2set=True, output_embedding="node")
    kw = dict(depth=2, input_embedding={**NODE16, "edge": {"input_dim": 15, "output_dim": 8}},
              node_mlp_args={"units": [24, 8], "activation": ["relu", "linear"]},
              edge_mlp_args={"units": [24, 16], "activation": "relu"}, use_set2set=True,
              set2set_args={"channels": 8, "T": 2}, output_mlp=OUT)
    jb, tb = _batches(_graphs(32, edge_classes=15))
    jm = jinorp.make_model(**kw)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jb), 33)
    model = params_from_jax(inorp.make_model(device="cpu", **kw), variables)
    assert isinstance(model.set2set, Set2Set)
    _close(model(tb)["output"], jm.apply(variables, jb)["output"])


@pytest.mark.parametrize("case", ["float nodes to an embedding", "integer nodes, width given",
                                  "edges missing", "edges unexpected", "graph width"])
def test_widths_at_build_are_checked(case):
    graphs = _graphs(31, edge_classes=5)
    if case == "float nodes to an embedding":
        model, graphs = sage.make_model(device="cpu"), _graphs(31, node_features=4)
    elif case == "integer nodes, width given":
        model = sage.make_model(device="cpu", in_features=4)
    elif case == "edges missing":
        model, graphs = gat.make_model(device="cpu"), _graphs(31, edge_features=0)
    elif case == "edges unexpected":
        model = gat.make_model(device="cpu", edge_in_features=0)
    else:
        model = inorp.make_model(device="cpu", graph_in_features=2)
    with pytest.raises(ValueError, match="in_features"):
        model(batch_graphs(graphs, device="cpu"))


def test_gin_edge_needs_float_edge_width():
    with pytest.raises(ValueError, match="edge_in_features"):
        gin.make_model_edge(device="cpu", edge_in_features=None)


# --------------------------------------------------------- the kgcnn goldens


def _golden(name, keys=()):
    graphs, weights, ref = _load(name)
    for g in graphs:
        g.pop("z")
        g.pop("xyz")
        if name == "gin":
            g.pop("edge_attributes", None)
    return graphs, list(weights), ref, jbatch_graphs(graphs, global_keys=keys), \
        batch_graphs(graphs, global_keys=keys, device="cpu")


def _gin_golden():
    graphs, weights, ref, jb, tb = _golden("gin")
    kw = dict(depth=2, output_mlp={"units": [1], "activation": ["linear"]})
    mapping = ["embed_to_units/Dense_0/kernel", "embed_to_units/Dense_0/bias"]
    for i in range(2):
        np.testing.assert_allclose(weights[2 + 13 * i], 0.0)  # epsilon_k, not learned
        mapping += [None, f"gin_mlp_{i}/dense_0/Dense_0/kernel",
                    f"gin_mlp_{i}/dense_0/Dense_0/bias",
                    f"gin_mlp_{i}/dense_1/Dense_0/kernel", f"gin_mlp_{i}/dense_1/Dense_0/bias",
                    f"gin_mlp_{i}/norm_0/scale", f"gin_mlp_{i}/norm_0/bias",
                    f"gin_mlp_{i}/norm_1/scale", f"gin_mlp_{i}/norm_1/bias",
                    None, None, None, None]  # the running statistics, 0 and 1 at start
    for i in range(3):
        for j in range(3):
            mapping += [f"out_mlp_{i}/dense_{j}/Dense_0/kernel",
                        f"out_mlp_{i}/dense_{j}/Dense_0/bias"]
    mapping += ["final/dense_0/Dense_0/kernel", "final/dense_0/Dense_0/bias"]
    return jgin.make_model, gin.make_model, kw, dict(in_features=8), mapping, weights, ref, jb, tb


def _gat_golden(name):
    graphs, weights, ref, jb, tb = _golden(name)
    jmake, make = (jgat.make_model, gat.make_model) if name == "gat" else \
        (jgatv2.make_model, gatv2.make_model)
    kw = dict(depth=1, attention_heads_num=2, attention_heads_concat=False,
              attention_args={"units": 32, "use_edge_features": True, "use_bias": True,
                              "activation": "relu", "use_final_activation": False},
              output_mlp={"units": [32, 1], "activation": ["relu", "linear"]})
    mapping = ["embed_to_units/Dense_0/kernel", "embed_to_units/Dense_0/bias"]
    for k in range(2):
        mapping += [f"head_0_{k}/linear_trafo/Dense_0/kernel",
                    f"head_0_{k}/linear_trafo/Dense_0/bias"]
        if name == "gatv2":
            mapping += [f"head_0_{k}/alpha_activation/Dense_0/kernel",
                        f"head_0_{k}/alpha_activation/Dense_0/bias"]
        mapping += [f"head_0_{k}/alpha/Dense_0/kernel"]
    mapping += ["out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
                "out_mlp/dense_1/Dense_0/kernel", "out_mlp/dense_1/Dense_0/bias"]
    return jmake, make, kw, dict(in_features=8, edge_in_features=5), mapping, weights, ref, jb, tb


def _sage_golden():
    graphs, weights, ref, jb, tb = _golden("graphsage")
    kw = dict(depth=2, use_edge_features=True,
              node_mlp_args={"units": [100, 50], "activation": ["relu", "linear"]},
              edge_mlp_args={"units": [100, 50], "activation": ["relu", "linear"]},
              pooling_args={"pooling_method": "mean"},
              pooling_nodes_args={"pooling_method": "mean"},
              output_mlp={"units": [25, 10, 1], "activation": ["relu", "relu", "sigmoid"],
                          "use_bias": [True, True, False]})
    mapping = []
    for i in range(2):
        mapping += [f"edge_mlp_{i}/dense_0/Dense_0/kernel", f"edge_mlp_{i}/dense_0/Dense_0/bias",
                    f"edge_mlp_{i}/dense_1/Dense_0/kernel", f"edge_mlp_{i}/dense_1/Dense_0/bias",
                    f"node_mlp_{i}/dense_0/Dense_0/kernel", f"node_mlp_{i}/dense_0/Dense_0/bias",
                    f"node_mlp_{i}/dense_1/Dense_0/kernel", f"node_mlp_{i}/dense_1/Dense_0/bias",
                    f"norm_{i}/LayerNorm_0/scale", f"norm_{i}/LayerNorm_0/bias"]
    mapping += ["out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
                "out_mlp/dense_1/Dense_0/kernel", "out_mlp/dense_1/Dense_0/bias",
                "out_mlp/dense_2/Dense_0/kernel"]
    return jsage.make_model, sage.make_model, kw, dict(in_features=8, edge_in_features=5), \
        mapping, weights, ref, jb, tb


def _inorp_golden():
    graphs, weights, ref, jb, tb = _golden("inorp", ("graph_attributes",))
    kw = dict(depth=2, use_set2set=False,
              node_mlp_args={"units": [100, 50], "activation": ["relu", "linear"]},
              edge_mlp_args={"units": [100, 100, 100, 100, 50],
                             "activation": ["relu", "relu", "relu", "relu", "linear"]},
              pooling_args={"pooling_method": "mean"},
              output_mlp={"units": [25, 10, 1], "activation": ["relu", "relu", "sigmoid"],
                          "use_bias": [True, True, False]})
    mapping = []
    for i in range(2):
        for j in range(5):
            mapping += [f"edge_mlp_{i}/dense_{j}/Dense_0/kernel",
                        f"edge_mlp_{i}/dense_{j}/Dense_0/bias"]
        for j in range(2):
            mapping += [f"node_mlp_{i}/dense_{j}/Dense_0/kernel",
                        f"node_mlp_{i}/dense_{j}/Dense_0/bias"]
    mapping += ["out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
                "out_mlp/dense_1/Dense_0/kernel", "out_mlp/dense_1/Dense_0/bias",
                "out_mlp/dense_2/Dense_0/kernel"]
    return jinorp.make_model, inorp.make_model, kw, \
        dict(in_features=8, edge_in_features=5, graph_in_features=4), mapping, weights, ref, jb, tb


def _relational_golden(name):
    graphs, weights, ref, jb, tb = _golden(name)
    out = {"units": [32, 1], "activation": ["relu", "linear"]}
    rel = {"units": 64, "num_relations": 5}
    if name == "rgcn":
        kw, shared = dict(depth=2, dense_relation_kwargs=rel, output_mlp=out), (1, 5)
        mapping = []
        for i in range(2):
            mapping += [f"rgcn_{i}/rel_dense/kernel", f"rgcn_{i}/rel_dense/bias",
                        f"rgcn_{i}/self_dense/Dense_0/kernel", f"rgcn_{i}/self_dense/Dense_0/bias"]
        makes = (jrgcn.make_model, rgcn.make_model)
    else:
        kw = dict(depth=2, dense_relation_kwargs=rel, dense_modulation_kwargs=rel, output_mlp=out)
        shared, mapping = (1, 3, 5, 7, 9, 11), []
        for i in range(2):
            mapping += [f"w_rel_{i}/kernel", f"w_rel_{i}/bias", f"gamma_{i}/kernel",
                        f"gamma_{i}/bias", f"beta_{i}/kernel", f"beta_{i}/bias"]
        makes = (jgnnfilm.make_model, gnnfilm.make_model)
    for i in shared:  # the reference's shared relational bias, per relation
        weights[i] = np.broadcast_to(weights[i], (5,) + weights[i].shape).copy()
    mapping += ["out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
                "out_mlp/dense_1/Dense_0/kernel", "out_mlp/dense_1/Dense_0/bias"]
    return (*makes, kw, dict(in_features=8), mapping, weights, ref, jb, tb)


GOLDENS = {"gin": _gin_golden, "graphsage": _sage_golden,
           "gat": lambda: _gat_golden("gat"), "gatv2": lambda: _gat_golden("gatv2"),
           "rgcn": lambda: _relational_golden("rgcn"),
           "gnnfilm": lambda: _relational_golden("gnnfilm"), "inorp": _inorp_golden}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_zoo_golden(name):
    """The reference's weights mapped into the JAX parameters by the recipe
    of ``tests/test_reference_parity.py``, carried into the port, the port's
    graph outputs against the recorded ones."""
    jmake, make, kw, widths, mapping, weights, ref, jb, tb = GOLDENS[name]()
    variables = _apply_mapping(jmake(**kw).init(jax.random.PRNGKey(0), jb), weights, mapping)
    model = params_from_jax(make(device="cpu", **kw, **widths),
                            jax.tree_util.tree_map(np.asarray, variables))
    out = model(tb)["output"].detach().numpy()[:len(ref)]
    np.testing.assert_allclose(out, ref, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
