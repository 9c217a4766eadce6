"""The port's kgcnn compatibility layer (``layers/pooling.py``,
``gather.py``, ``casting.py``, ``modules.py``, ``message.py``,
``layers/pool/lstm.py``, ``pool/topk.py``, ``ops/scatter.py``,
``partition.py``, ``axis.py``) against the JAX package's functions on the
CPU: each case of ``tests/test_compat_api.py`` held against the JAX
function's values on the same inputs, not only its shapes. Sums agree
within float32 summation order (``rtol=1e-5``, ``atol=1e-6``); gathers,
casts, masks and integer results exactly. ``PoolingLocalEdgesLSTM`` and
``PoolingTopK`` run on flax's weights (``params_from_jax``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph.preprocess import set_angle, set_range
from gcnn_keras_tpu.layers import casting as jcasting
from gcnn_keras_tpu.layers import gather as jgather
from gcnn_keras_tpu.layers import message as jmessage
from gcnn_keras_tpu.layers import modules as jmodules
from gcnn_keras_tpu.layers import pooling as jpooling
from gcnn_keras_tpu.layers.pool import lstm as jlstm
from gcnn_keras_tpu.layers.pool import topk as jtopk
from gcnn_keras_tpu.ops import axis as jaxis
from gcnn_keras_tpu.ops import partition as jpartition
from gcnn_keras_tpu.ops import scatter as jscatter
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers import casting, gather, message, modules, pooling
from gcnn_keras_tpu_torch.layers.pool import (AdjacencyPower, PoolingLocalEdgesLSTM,
                                              PoolingTopK, UnPoolingTopK)
from gcnn_keras_tpu_torch.ops import axis, partition, scatter
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_zoo import _close

torch.set_num_threads(1)


def _mol_graphs(with_angles=False, with_edge_attr=False, seed=0, n_graphs=2):
    """``tests/test_model_zoo.py``'s ``make_mol_batch`` graphs, draw for
    draw (more of them with ``n_graphs``)."""
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_graphs):
        n = rs.randint(4, 7)
        g = {"node_number": rs.choice([1, 6, 8], size=n),
             "node_coordinates": (rs.randn(n, 3) * 1.5).astype(np.float32),
             "graph_labels": np.array([rs.randn()], dtype=np.float32)}
        g = set_range(g, max_distance=6.0, max_neighbours=8)
        g["edge_indices"] = g.pop("range_indices")
        if with_angles:
            g = set_angle(g, range_indices="edge_indices")
        if with_edge_attr:
            m = g["edge_indices"].shape[0]
            g["edge_attributes"] = rs.randn(m, 8).astype(np.float32)
            g["edge_relations"] = rs.randint(0, 3, size=m)
            g["edge_weights"] = np.ones((m, 1), dtype=np.float32)
        graphs.append(g)
    return graphs


def _batches(with_angles=False, with_edge_attr=False, seed=0, n_graphs=2):
    """The JAX and the port batch of ``make_mol_batch``'s graphs, padded as
    it pads them."""
    graphs = _mol_graphs(with_angles, with_edge_attr, seed, n_graphs)
    kw = dict(n_node_pad=16 * n_graphs // 2, n_edge_pad=128 * n_graphs // 2,
              n_angle_pad=256 if with_angles else None, compute_reverse_edges=True)
    return jbatch_graphs(graphs, **kw), batch_graphs(graphs, device="cpu", **kw)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _exact(out, ref):
    np.testing.assert_array_equal(out.detach().numpy() if torch.is_tensor(out)
                                  else np.asarray(out), np.asarray(ref))


# ------------------------------------------------------------- pooling

def _pool_values(jb, seed=4):
    rs = np.random.RandomState(seed)
    return {"ev": rs.randn(jb.n_edge, 8).astype(np.float32),
            "nv": rs.randn(jb.n_node, 4).astype(np.float32),
            "w": rs.rand(jb.n_edge, 1).astype(np.float32),
            "logits": rs.randn(jb.n_edge, 1).astype(np.float32),
            "node_logits": rs.randn(jb.n_node, 1).astype(np.float32)}


POOLS = {
    "PoolingLocalEdges-segment_sum": (lambda m: m.PoolingLocalEdges("segment_sum"), ("ev",)),
    "PoolingLocalEdges-mean": (lambda m: m.PoolingLocalEdges("mean"), ("ev",)),
    "PoolingLocalEdges-max": (lambda m: m.PoolingLocalEdges("segment_max"), ("ev",)),
    "PoolingLocalMessages": (lambda m: m.PoolingLocalMessages("sum"), ("ev",)),
    "PoolingWeightedLocalEdges": (lambda m: m.PoolingWeightedLocalEdges("sum"), ("ev", "w")),
    "PoolingWeightedLocalEdges-normalized": (
        lambda m: m.PoolingWeightedLocalEdges("sum", normalize_by_weights=True), ("ev", "w")),
    "PoolingLocalEdgesAttention": (lambda m: m.PoolingLocalEdgesAttention(), ("ev", "logits")),
    "RelationalPoolingLocalEdges": (lambda m: m.RelationalPoolingLocalEdges(3),
                                    ("ev", "edge_relations")),
    "PoolingNodes-sum": (lambda m: m.PoolingNodes("sum"), ("nv",)),
    "PoolingNodes-mean": (lambda m: m.PoolingNodes("mean"), ("nv",)),
    "PoolingEmbedding": (lambda m: m.PoolingEmbedding("segment_mean"), ("nv",)),
    "PoolingNodesAttention": (lambda m: m.PoolingNodesAttention(), ("nv", "node_logits")),
    "PoolingEmbeddingAttention": (lambda m: m.PoolingEmbeddingAttention(),
                                  ("nv", "node_logits")),
    "PoolingGlobalEdges": (lambda m: m.PoolingGlobalEdges("sum"), ("ev",)),
}


@pytest.mark.parametrize("name", list(POOLS))
def test_pooling_compat_names_match_jax(name):
    """``test_pooling_compat_names``' pools, and the rest of the kgcnn
    pooling names, against the JAX functions' values."""
    jb, tb = _batches(with_edge_attr=True)
    vals = dict(_pool_values(jb), edge_relations=np.asarray(jb.edges["edge_relations"]))
    make, args = POOLS[name]
    out = make(pooling)(tb, *[_t(vals[a]) for a in args])
    ref = make(jpooling)(jb, *[jnp.asarray(vals[a]) for a in args])
    _close(out, ref)


def test_pooling_compat_shapes_as_jax_test():
    """``test_pooling_compat_names``' own inputs: the batch's edge
    attributes and weights, ones on the nodes."""
    jb, tb = _batches(with_edge_attr=True)
    ev, w = tb.edges["edge_attributes"], tb.edges["edge_weights"]
    jev, jw = jb.edges["edge_attributes"], jb.edges["edge_weights"]
    _close(pooling.PoolingLocalEdges("segment_sum")(tb, ev),
           jpooling.PoolingLocalEdges("segment_sum")(jb, jev))
    _close(pooling.PoolingWeightedLocalEdges("sum")(tb, ev, w),
           jpooling.PoolingWeightedLocalEdges("sum")(jb, jev, jw))
    _close(pooling.PoolingNodes("mean")(tb, torch.ones(tb.n_node, 4)),
           jpooling.PoolingNodes("mean")(jb, jnp.ones((jb.n_node, 4))))
    _close(pooling.PoolingGlobalEdges("sum")(tb, ev), jpooling.PoolingGlobalEdges("sum")(jb, jev))


# ------------------------------------------------------------- gathers

@pytest.mark.parametrize("name", ["GatherNodes", "GatherNodes-list", "GatherNodes-reversed",
                                  "GatherNodesIngoing", "GatherNodesOutgoing", "GatherState"])
def test_gather_compat_names_match_jax(name):
    jb, tb = _batches()
    nv = np.random.RandomState(0).randn(tb.n_node, 8).astype(np.float32)
    st = np.random.RandomState(1).randn(tb.n_graphs, 4).astype(np.float32)
    make = {"GatherNodes": lambda m: m.GatherNodes(),
            "GatherNodes-list": lambda m: m.GatherNodes(concat_axis=None),
            "GatherNodes-reversed": lambda m: m.GatherNodes(split_indices=(1, 0)),
            "GatherNodesIngoing": lambda m: m.GatherNodesIngoing(),
            "GatherNodesOutgoing": lambda m: m.GatherNodesOutgoing(),
            "GatherState": lambda m: m.GatherState()}[name]
    x = st if name == "GatherState" else nv
    out, ref = make(gather)(tb, _t(x)), make(jgather)(jb, jnp.asarray(x))
    if isinstance(ref, list):
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            _exact(o, r)
    else:
        _exact(out, ref)


def test_gather_nodes_selection_dispatch_matches_jax():
    """``test_gather_nodes_selection_dispatch``'s selections: edge pairs
    stay on edges, angle-needing selections take the angle columns for
    every entry, an explicit source overrides; each the JAX result."""
    g = {"node_number": np.array([1, 6, 8, 1]),
         "node_coordinates": np.eye(4, 3, dtype=np.float32),
         "edge_indices": np.array([[0, 1], [1, 0], [2, 3], [3, 2]]),
         "angle_indices_nodes": np.array([[0, 1, 2], [1, 2, 3]])}
    jb, tb = jbatch_graphs([g]), batch_graphs([g], device="cpu")
    nodes = np.arange(tb.n_node, dtype=np.float32)[:, None]
    for sel, src in (([0, 1], None), ([0, 1, 2], None), ([0, 2], None), ([0, 1], "edges"),
                     (2, None), ([1], "angles")):
        out = gather.GatherNodesSelection(sel, index_source=src)(tb, _t(nodes))
        ref = jgather.GatherNodesSelection(sel, index_source=src)(jb, jnp.asarray(nodes))
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            _exact(o, r)
    no_angles = batch_graphs([{k: v for k, v in g.items() if k != "angle_indices_nodes"}],
                             device="cpu")
    with pytest.raises(ValueError, match="angles"):
        gather.GatherNodesSelection([0], index_source="angles")(no_angles, _t(nodes))


# ------------------------------------------------------------- partitions

@pytest.mark.parametrize("src,dst", [("row_length", "row_splits"), ("row_splits", "row_length"),
                                     ("row_length", "value_rowids"),
                                     ("row_splits", "row_limits"), ("row_splits", "row_starts"),
                                     ("row_length", "row_starts"), ("row_splits", "row_splits")])
def test_partition_conversions_match_jax(src, dst):
    lengths = np.array([3, 0, 2, 4])
    part = {"row_length": lengths, "row_splits": np.array([0, 3, 3, 5, 9])}[src]
    _exact(partition.change_partition_by_name(_t(part), src, dst),
           jpartition.change_partition_by_name(jnp.asarray(part), src, dst))


def test_partition_ops_match_jax():
    """``test_partition_ops``: lengths to splits and back, per-sample edge
    indices shifted to disjoint ones (by value rowids and by lengths), the
    row ids' lengths; the JAX values."""
    lengths = np.array([3, 2, 4])
    splits = partition.change_partition_by_name(_t(lengths), "row_length", "row_splits")
    assert splits.tolist() == [0, 3, 5, 9]
    idx, rowids = np.array([0, 1, 0, 1, 2, 0]), np.array([0, 0, 1, 1, 1, 2])
    shifted = partition.partition_row_indexing(_t(idx), splits, _t(rowids))
    assert shifted.tolist() == [0, 1, 3, 4, 5, 5]
    _exact(shifted, jpartition.partition_row_indexing(
        jnp.asarray(idx), jnp.asarray([0, 3, 5, 9]), jnp.asarray(rowids)))
    pairs = np.array([[0, 1], [1, 0], [0, 1], [1, 2], [2, 0], [0, 0]])
    _exact(partition.partition_row_indexing(_t(pairs), _t(lengths), _t(np.array([2, 3, 1])),
                                            partition_type_target="row_length",
                                            partition_type_index="row_length"),
           jpartition.partition_row_indexing(jnp.asarray(pairs), jnp.asarray(lengths),
                                             jnp.asarray([2, 3, 1]),
                                             partition_type_target="row_length",
                                             partition_type_index="row_length"))
    _exact(partition.value_rowids_to_lengths(_t(rowids), 4),
           jpartition.value_rowids_to_lengths(jnp.asarray(rowids), 4))
    with pytest.raises(ValueError, match="num_rows"):
        partition.change_partition_by_name(_t(rowids), "value_rowids", "row_splits")


@pytest.mark.parametrize("ax,rank", [(0, 3), (-1, 3), (-3, 3), (2, 3)])
def test_get_positive_axis_matches_jax(ax, rank):
    assert axis.get_positive_axis(ax, rank) == jaxis.get_positive_axis(ax, rank)


def test_get_positive_axis_raises_out_of_range():
    for ax in (3, -4):
        with pytest.raises(ValueError, match="out of range"):
            axis.get_positive_axis(ax, 3)


# ------------------------------------------------------------- casting

def test_casting_matches_jax():
    """``test_casting_dense_adjacency``'s adjacency (symmetric, as the
    fixture's edges) and the other casts, each the JAX value."""
    jb, tb = _batches(with_edge_attr=True)
    adj = casting.cast_edges_to_dense_adjacency(tb)
    assert adj.shape[0] == tb.n_graphs
    assert torch.equal(adj, adj.transpose(1, 2))
    _exact(adj, jcasting.cast_edges_to_dense_adjacency(jb))
    ev = np.random.RandomState(3).randn(tb.n_edge, 2).astype(np.float32)
    _close(casting.cast_edges_to_dense_adjacency(tb, _t(ev)),
           jcasting.cast_edges_to_dense_adjacency(jb, jnp.asarray(ev)))
    nv = np.random.RandomState(4).randn(tb.n_node, 3).astype(np.float32)
    padded, mask = casting.cast_flat_to_padded(tb, _t(nv), fill=-1.0)
    jpadded, jmask = jcasting.cast_flat_to_padded(jb, jnp.asarray(nv), fill=-1.0)
    _exact(padded, jpadded)
    _exact(mask, jmask)
    _exact(casting.cast_padded_to_flat(tb, padded), jcasting.cast_padded_to_flat(jb, jpadded))
    for out, ref in zip(casting.cast_edges_to_coo(tb), jcasting.cast_edges_to_coo(jb)):
        _exact(out, ref)


# ------------------------------------------------------------- scatter

@pytest.mark.parametrize("op", ["add", "scatter_add", "max", "tensor_scatter_nd_max", "min",
                                "scatter_min", "update"])
@pytest.mark.parametrize("k", [1, 2])
def test_scatter_by_name_matches_jax(op, k):
    """``test_scatter_by_name``'s add, and max, min and update, by one or two
    index columns, with duplicate indices (but for update) and untouched
    entries; JAX's ``.at[]`` values."""
    rs = np.random.RandomState(5)
    target = rs.randn(4, 3, 2).astype(np.float32)
    rows = 4 * 3 if k == 2 else 4
    if op == "update":
        flat = rs.choice(rows, size=3, replace=False)
    else:
        flat = rs.randint(0, rows, size=7)
    indices = np.stack(np.unravel_index(flat, (4, 3)), -1) if k == 2 else flat[:, None]
    upd_shape = (len(indices),) + target.shape[k:]
    updates = rs.randn(*upd_shape).astype(np.float32)
    out = scatter.tensor_scatter_nd_ops_by_name(op, _t(target), _t(indices), _t(updates))
    ref = jscatter.tensor_scatter_nd_ops_by_name(op, jnp.asarray(target), jnp.asarray(indices),
                                                 jnp.asarray(updates))
    _close(out, ref)


def test_scatter_by_name_as_jax_test():
    out = scatter.tensor_scatter_nd_ops_by_name(
        "add", torch.zeros(4, 2), torch.tensor([[0], [2], [0]]),
        torch.tensor([[1.0, 1], [2, 2], [3, 3]]))
    assert out[0].tolist() == [4, 4] and out[2].tolist() == [2, 2]
    with pytest.raises(ValueError, match="unknown scatter op"):
        scatter.tensor_scatter_nd_ops_by_name("mul", torch.zeros(2), torch.tensor([[0]]),
                                              torch.ones(1))


# ------------------------------------------------------------- modules

@pytest.mark.parametrize("name", ["LazyAdd", "LazySubtract", "LazyMultiply", "LazyAverage",
                                  "LazyConcatenate", "ExpandDims", "ZerosLike", "Activation"])
def test_modules_match_jax(name):
    rs = np.random.RandomState(6)
    xs = [rs.randn(5, 3).astype(np.float32) for _ in range(3)]
    single = name in ("ExpandDims", "ZerosLike", "Activation")
    make = {"LazyConcatenate": lambda m: m.LazyConcatenate(axis=0),
            "ExpandDims": lambda m: m.ExpandDims(axis=1),
            "Activation": lambda m: m.Activation("swish")}.get(name, lambda m: getattr(m, name)())
    out = make(modules)(_t(xs[0]) if single else [_t(x) for x in xs])
    ref = make(jmodules)(jnp.asarray(xs[0]) if single else [jnp.asarray(x) for x in xs])
    _close(out, ref)


def test_modules_dense_and_embedding_are_the_ports():
    from gcnn_keras_tpu_torch.layers.mlp import Dense
    from gcnn_keras_tpu_torch.models.common import OptionalInputEmbedding
    assert modules.Dense is Dense and modules.DenseEmbedding is Dense
    assert modules.OptionalInputEmbedding is OptionalInputEmbedding


# ------------------------------------------------------------- message passing

class _TorchMessages(message.MessagePassing):
    def message_function(self, x_i, x_j, edge_attr):
        return x_j * edge_attr + 0.5 * x_i

    def update_nodes(self, nodes, aggregated):
        return nodes + torch.tanh(aggregated)


class _JaxMessages(jmessage.MessagePassing):
    def message_function(self, x_i, x_j, edge_attr):
        return x_j * edge_attr + 0.5 * x_i

    def update_nodes(self, nodes, aggregated):
        return nodes + jnp.tanh(aggregated)


@pytest.mark.parametrize("pooling_method", ["sum", "mean", "max"])
def test_message_passing_template_matches_jax(pooling_method):
    jb, tb = _batches(with_edge_attr=True)
    nv = np.random.RandomState(7).randn(tb.n_node, 8).astype(np.float32)
    out = _TorchMessages(pooling_method)(tb, _t(nv), tb.edges["edge_attributes"])
    jm = _JaxMessages(pooling_method=pooling_method)
    ref = jm.apply({}, jb, jnp.asarray(nv), jb.edges["edge_attributes"])
    _close(out, ref)
    with pytest.raises(NotImplementedError):
        message.MessagePassing()(tb, _t(nv))


# ------------------------------------------------------------- LSTM pool

@pytest.mark.parametrize("units,max_neighbors", [(8, 16), (5, 3)])
def test_lstm_pooling_matches_jax_on_flax_weights(units, max_neighbors):
    """``test_lstm_pooling``'s layer (8 units, 16 slots) against JAX's, on
    flax's initial weights carried over; and one whose slots clip (3 for up
    to 8 neighbours: which clipped edge lands in slot 2 is unspecified in
    either package), finite."""
    jb, tb = _batches(with_edge_attr=True)
    ev = tb.edges["edge_attributes"]
    jl = jlstm.PoolingLocalEdgesLSTM(units=units, max_neighbors=max_neighbors)
    variables = jl.init(jax.random.PRNGKey(0), jb, jb.edges["edge_attributes"])
    layer = params_from_jax(PoolingLocalEdgesLSTM(8, units, max_neighbors),
                            jax.tree_util.tree_map(np.asarray, variables))
    out = layer(tb, ev)
    assert out.shape == (tb.n_node, units) and torch.isfinite(out).all()
    if max_neighbors >= 8:
        _close(out, jl.apply(variables, jb, jb.edges["edge_attributes"]))


def test_lstm_pooling_needs_edge_slots():
    graphs = _mol_graphs(with_edge_attr=True)
    tb = batch_graphs(graphs, device="cpu", sort_edges_by_receiver=False)
    with pytest.raises(ValueError, match="edge_slot"):
        PoolingLocalEdgesLSTM(8, 4)(tb, tb.edges["edge_attributes"])


# ------------------------------------------------------------- top-k pools

def _topk_graphs():
    rs = np.random.RandomState(0)
    graphs = []
    for n in (5, 7):
        ei = np.array([[i, j] for i in range(n) for j in range(n) if i != j])
        graphs.append({"node_attributes": rs.randn(n, 4).astype(np.float32),
                       "edge_indices": ei, "edge_weights": rs.rand(len(ei), 1).astype(np.float32)})
    return graphs


def test_pooling_topk_reference_semantics_match_jax():
    """``test_pooling_topk_reference_semantics``: the round(k N) lowest
    scores removed, the survivors gated by sigmoid(score); the port's gated
    nodes, keep mask and scores are JAX's on the same kernel, and a second
    pool stacked on the first's mask too."""
    graphs = _topk_graphs()
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    jl = jtopk.PoolingTopK(k=0.3)
    feats = jb.nodes["node_attributes"]
    variables = jl.init(jax.random.PRNGKey(1), jb, feats)
    layer = params_from_jax(PoolingTopK(4, k=0.3), jax.tree_util.tree_map(np.asarray, variables))
    got = layer(tb, tb.nodes["node_attributes"])
    ref = jl.apply(variables, jb, feats)
    _close(got[0], ref[0])
    _exact(got[1], ref[1])
    _close(got[2], ref[2])
    p = np.asarray(variables["params"]["score_kernel"])[0]
    score = np.asarray(feats) @ (p / np.linalg.norm(p))
    keep, off = got[1].numpy(), 0
    for g in graphs:
        n = len(g["node_attributes"])
        removed = np.argsort(score[off:off + n])[:int(np.round(0.3 * n))]
        want = np.ones(n, bool)
        want[removed] = False
        np.testing.assert_array_equal(keep[off:off + n], want)
        off += n
    assert not keep[off:].any()
    again = layer(tb, got[0], mask=got[1])
    jagain = jl.apply(variables, jb, ref[0], mask=ref[1])
    _exact(again[1], jagain[1])
    _close(again[0], jagain[0])


def test_pooling_topk_breaks_ties_by_node_index():
    """Equal scores: the lower index goes first, as JAX."""
    graphs = [{"node_attributes": np.ones((5, 2), np.float32),
               "edge_indices": np.array([[0, 1], [1, 0]])}]
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    layer = PoolingTopK(2, k=0.4, kernel_initializer="ones")
    _, keep, _ = layer(tb, tb.nodes["node_attributes"])
    assert keep[:5].tolist() == [False, False, True, True, True]
    jl = jtopk.PoolingTopK(k=0.4, kernel_initializer=jax.nn.initializers.ones)
    variables = jl.init(jax.random.PRNGKey(0), jb, jb.nodes["node_attributes"])
    _exact(keep, jl.apply(variables, jb, jb.nodes["node_attributes"])[1])


def test_unpooling_topk_matches_jax():
    rs = np.random.RandomState(8)
    orig, pooled = rs.randn(9, 3).astype(np.float32), rs.randn(9, 3).astype(np.float32)
    keep = rs.rand(9) > 0.5
    _exact(UnPoolingTopK()(_t(orig), _t(pooled), _t(keep)),
           jtopk.UnPoolingTopK().apply({}, jnp.asarray(orig), jnp.asarray(pooled),
                                       jnp.asarray(keep)))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_adjacency_power_matches_jax(n):
    graphs = _topk_graphs()
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    out = AdjacencyPower(n)(tb, tb.edges["edge_weights"])
    ref = jtopk.AdjacencyPower(n=n).apply({}, jb, jb.edges["edge_weights"])
    assert out.shape == (tb.n_edge, 1)
    _close(out, ref)


def test_flax_module_trees_hold_no_unused_port_parameters():
    """The LSTM pool's and the top-k pool's parameters are exactly the flax
    leaves (``params_from_jax`` raises on one left over either way)."""
    jb, _ = _batches(with_edge_attr=True)
    variables = jlstm.PoolingLocalEdgesLSTM(units=4).init(
        jax.random.PRNGKey(0), jb, jb.edges["edge_attributes"])
    names = {n for n, _ in PoolingLocalEdgesLSTM(8, 4).named_parameters()}
    assert names == {f"lstm.cell.{g}.{leaf}" for g in ("ii", "if", "ig", "io")
                     for leaf in ("kernel",)} | {f"lstm.cell.{g}.{leaf}"
                                                  for g in ("hi", "hf", "hg", "ho")
                                                  for leaf in ("kernel", "bias")}
    params_from_jax(PoolingLocalEdgesLSTM(8, 4), jax.tree_util.tree_map(np.asarray, variables))


# ------------------------------------------------ chip_smoke phase 25 on the CPU

from tests.test_torch_zoo_scripts import _Everything, counted_kernels  # noqa: E402,F401


def test_chip_smoke_phase_25_compat_runs_on_the_cpu(counted_kernels):
    """Phase 25's compatibility layer on 16 molecules: every output against
    the CPU's, 3 segment-sum calls a pass (``COMPAT_LAUNCHES``), each
    against the plain version."""
    cs = counted_kernels
    paths, recs = cs.phase_compat("cpu", _Everything(), device="cpu", n_mols=16)
    assert paths["compat_pools"] == cs.launch_counts(sorted_segment_sum=cs.COMPAT_LAUNCHES)
    assert len(recs) == cs.COMPAT_LAUNCHES


def test_check_top_k_takes_a_near_tie_and_refuses_a_flip():
    """``chip_smoke.check_top_k``: a "card" selection that swaps two nodes
    of a graph whose scores it has within its rounding passes (the gated
    nodes compared where the masks agree); a swap of distant scores
    raises."""
    import chip_smoke as cs
    graphs = _topk_graphs()
    tb = batch_graphs(graphs, device="cpu")
    layer = PoolingTopK(4, k=0.3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = layer(tb, tb.nodes["node_attributes"])
    gated, keep, score = (t.clone() for t in ref)
    assert cs.check_top_k((gated, keep, score), ref, tb.graph_id)["nodes_differing"] == 0
    idx = torch.arange(len(keep))
    first = (tb.graph_id == 0) & tb.node_mask
    i = idx[first & keep][score[first & keep].argmin()]
    j = idx[first & ~keep][score[first & ~keep].argmax()]
    # a planted near tie: j just below i on the CPU, just above on the "card"
    ref_score = score.clone()
    ref_score[j] = score[i] - 1e-7
    near_score = ref_score.clone()
    near_score[j] = score[i] + 1e-7
    near = keep.clone()
    near[i], near[j] = False, True
    rec = cs.check_top_k((gated, near, near_score), (gated, keep, ref_score), tb.graph_id)
    assert rec["nodes_differing"] == 2 and rec["max_gap"] <= 2 * rec["score_spread"]
    far = keep.clone()
    far[idx[first & keep][score[first & keep].argmax()]], far[j] = False, True
    with pytest.raises(AssertionError, match="beyond a near tie"):
        cs.check_top_k((gated, far, score), ref, tb.graph_id)
