"""The port's batching and neighbour list against the JAX package's.

``gcnn_keras_tpu_torch.batch.batch_graphs(device="cpu")`` must equal
``gcnn_keras_tpu.batch.batch_graphs(np_out=True)`` bit for bit on every
field; ``set_range`` must give the same neighbour lists.
"""
import dataclasses

import numpy as np
import pytest
import torch

from gcnn_keras_tpu import batch as jbatch
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu_torch import batch as tbatch
from gcnn_keras_tpu_torch.graph import preprocess as tpre

torch.set_num_threads(1)


def _mols(seed, n_mols, n_min=3, n_max=12, angles=False):
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_mols):
        n = rs.randint(n_min, n_max)
        g = {"node_number": rs.choice([1, 6, 7, 8, 9], size=n),
             "node_coordinates": (rs.randn(n, 3) * 1.5).astype(np.float32),
             "energy": np.array([rs.randn()], dtype=np.float32)}
        g = jpre.set_range(g, max_distance=4.0, max_neighbours=25)
        g["edge_indices"] = g.pop("range_indices")
        g["force"] = (rs.randn(n, 3) * 0.1).astype(np.float32)
        if angles:
            g = jpre.set_angle(g, range_indices="edge_indices")
            g = jpre.set_angle_edge_pairs(g, range_indices="edge_indices")
            g["total_charge"] = np.zeros((1,), dtype=np.float32)
        graphs.append(g)
    return graphs


def _assert_same(jb, tb):
    for f in dataclasses.fields(tb):
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), f.name
            for k in a:
                _assert_array_same(a[k], b[k], f"{f.name}[{k}]")
        elif isinstance(b, torch.Tensor) or b is None or a is None:
            assert (a is None) == (b is None), f.name
            if a is not None:
                _assert_array_same(a, b, f.name)
        else:
            assert a == b, (f.name, a, b)


def _assert_array_same(a, b, name):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", ["default", "explicit_pads", "angles",
                                  "reverse_edges", "unsorted", "big_graph"])
def test_batch_graphs_bit_for_bit(case):
    kw = {}
    graphs = _mols(0, 5)
    if case == "explicit_pads":
        kw = dict(n_node_pad=300, n_edge_pad=2000, n_graph_pad=9, max_nodes=40)
    elif case == "angles":
        graphs = _mols(1, 4, angles=True)
        kw = dict(global_keys=("total_charge",))
    elif case == "reverse_edges":
        kw = dict(compute_reverse_edges=True)
    elif case == "unsorted":
        kw = dict(sort_edges_by_receiver=False)
    elif case == "big_graph":
        # max_nodes > 128 takes the measured window-locality branch
        graphs = _mols(2, 2, n_min=140, n_max=160)
    jb = jbatch.batch_graphs(graphs, np_out=True, **kw)
    tb = tbatch.batch_graphs(graphs, device="cpu", **kw)
    _assert_same(jb, tb)
    if case != "unsorted":
        assert "sender_perm" in tb.edges and "edge_slot" in tb.edges


def test_batch_second_edge_set():
    graphs = _mols(3, 3)
    for g in graphs:
        g["range2_indices"] = g["edge_indices"][::2].copy()
    kw = dict(second_edge_index_key="range2_indices")
    jb = jbatch.batch_graphs(graphs, np_out=True, **kw)
    tb = tbatch.batch_graphs(graphs, device="cpu", **kw)
    _assert_same(jb, tb)
    assert tb.senders2 is not None


def test_batch_to_device_and_replace():
    tb = tbatch.batch_graphs(_mols(0, 2), device="cpu")
    moved = tb.to("cpu")
    assert moved.n_node == tb.n_node and moved.n_edge == tb.n_edge
    assert torch.equal(moved.edge_graph_id, tb.graph_id[tb.receivers])
    new = tb.replace_nodes(extra=torch.zeros(tb.n_node))
    assert "extra" in new.nodes and "extra" not in tb.nodes


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 700, 1024, 1025, 8164, 54696])
def test_bucket_size(n):
    assert tbatch.bucket_size(n) == jbatch.bucket_size(n)
    assert tbatch.bucket_size(n, multiple=256, min_size=64) == \
        jbatch.bucket_size(n, multiple=256, min_size=64)


@pytest.mark.parametrize("pad", [dict(n_node_pad=10), dict(n_edge_pad=4),
                                 dict(n_graph_pad=3), dict(max_nodes=2)])
def test_batch_too_small_pad_raises(pad):
    graphs = _mols(0, 3)
    with pytest.raises(ValueError):
        jbatch.batch_graphs(graphs, np_out=True, **pad)
    with pytest.raises(ValueError):
        tbatch.batch_graphs(graphs, device="cpu", **pad)


def test_batch_empty_raises():
    with pytest.raises(ValueError):
        tbatch.batch_graphs([], device="cpu")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_distance=2.5, max_neighbours=3),
    dict(max_neighbours=None),
    dict(do_invert_distance=True),
    dict(self_loops=True),
    dict(exclusive=False, max_neighbours=4),
    dict(backend="numpy"),
])
def test_set_range_matches(kw):
    rs = np.random.RandomState(4)
    for n in (1, 2, 9, 30):
        g = {"node_coordinates": (rs.randn(n, 3) * 1.7).astype(np.float32)}
        a, b = jpre.set_range(g, **kw), tpre.set_range(g, **kw)
        for key in ("range_indices", "range_attributes"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_set_range_native_raises(monkeypatch):
    """``backend="native"`` gives the JAX dense lists through the C++ cell
    list, and raises ``RuntimeError`` only where no library loads."""
    from gcnn_keras_tpu_torch import native
    rs = np.random.RandomState(5)
    g = {"node_coordinates": (rs.randn(30, 3) * 1.7).astype(np.float32)}
    kw = dict(max_distance=3.0, max_neighbours=8)
    got, ref = tpre.set_range(g, backend="native", **kw), jpre.set_range(g, backend="numpy", **kw)
    for key in ("range_indices", "range_attributes"):
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        tpre.set_range(g, backend="native")


@pytest.mark.parametrize("pads", [{}, dict(n_node_pad=512, n_graph_pad=9, max_nodes=14)],
                         ids=["default", "padding-beyond-max-nodes"])
@pytest.mark.parametrize("trailing", [(), (3,)], ids=["scalar", "vector"])
def test_flat_padded_round_trip_matches_jax(pads, trailing):
    """Padding nodes of the padding graph beyond M fall into the dropped
    scratch row; ``graph_psum`` is the identity on whole graphs."""
    import jax.numpy as jnp
    graphs = _mols(7, 5)
    jb = jbatch.batch_graphs(graphs, **pads)
    tb = tbatch.batch_graphs(graphs, device="cpu", **pads)
    vals = np.random.RandomState(8).randn(jb.n_node, *trailing).astype(np.float32)
    ref = np.asarray(jbatch.flat_to_padded(jnp.asarray(vals), jb, fill=-1.0))
    out = tbatch.flat_to_padded(torch.from_numpy(vals), tb, fill=-1.0)
    assert out.shape == ref.shape and np.array_equal(out.numpy(), ref)
    back = tbatch.padded_to_flat(out, tb)
    assert np.array_equal(back.numpy(),
                          np.asarray(jbatch.padded_to_flat(jnp.asarray(ref), jb)))
    mask = tb.node_mask.numpy()
    assert np.array_equal(back.numpy()[mask], vals[mask]) and not back.numpy()[~mask].any()
    assert tbatch.graph_psum(tb, out) is out
