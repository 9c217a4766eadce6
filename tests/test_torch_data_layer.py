"""The port's data layer against the JAX package, on the CPU.

Everything here is host numpy on both sides and must agree bit for bit:
the splits (``kfold_swapped_val``, ``kfold_indices``, ``idx_generator``),
``SyntheticMDDataset`` and ``SyntheticQM9Dataset``, ``MemoryGraphDataset``
indexing, ``map_list`` through the preprocessor registry,
``batch_shape_hint``, ``to_batch``/``to_batches``, pickle ``save``/``load``,
the extensive label scaler (fit, transform, inverse, ``scaler.json``) and
``GraphBatchLoader``'s batches against the JAX loader's ``np_out`` batches,
field by field, over two epochs.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from gcnn_keras_tpu.data import scalers as jscalers
from gcnn_keras_tpu.data.dataset import MemoryGraphDataset as JDataset
from gcnn_keras_tpu.data.datasets import synthetic as jsynthetic
from gcnn_keras_tpu.data.graph_dict import GraphDict as JGraphDict
from gcnn_keras_tpu.data.loader import GraphBatchLoader as JLoader
from gcnn_keras_tpu.utils import data_splitter as jsplit
from gcnn_keras_tpu_torch.batch import GraphBatch
from gcnn_keras_tpu_torch.data import scalers
from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset, MemoryGraphList
from gcnn_keras_tpu_torch.data.datasets import synthetic
from gcnn_keras_tpu_torch.data.graph_dict import GraphDict
from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
from gcnn_keras_tpu_torch.graph import preprocess
from gcnn_keras_tpu_torch.utils import data_splitter

torch.set_num_threads(1)


def _assert_graphs_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]), err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k


def _assert_batches_equal(tb, jb):
    """Every field of the port's batch equals the JAX ``np_out`` batch's."""
    for f in dataclasses.fields(GraphBatch):
        got, ref = getattr(tb, f.name), getattr(jb, f.name)
        if isinstance(ref, dict):
            assert sorted(got) == sorted(ref), f.name
            for k in ref:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                              err_msg=f"{f.name}[{k}]")
        elif ref is None or isinstance(ref, (int, bool)):
            assert got == ref, f.name
        else:
            assert got.dtype == torch.as_tensor(np.asarray(ref)).dtype, f.name
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f.name)


def _md(frames=24, seed=5, esp=False, angles=True):
    """The engine's synthetic trajectory in both packages, neighbour lists
    (and angles) added through ``map_list``."""
    out = []
    for mod in (synthetic, jsynthetic):
        ds = mod.SyntheticMDDataset(num_frames=frames, seed=seed)
        if esp:
            rs = np.random.RandomState(seed)
            for g in ds:
                g["charge"] = (rs.randn(len(g["node_number"])) * 0.1).astype(np.float32)
                g["total_charge"] = np.array([g["charge"].sum()], dtype=np.float32)
        ds.map_list("set_range", max_distance=4.0, max_neighbours=6)
        if angles:
            ds.map_list("set_angle")
        for g in ds:
            g["edge_indices"] = g["range_indices"]
        out.append(ds)
    return out


# ------------------------------------------------------------- splits


@pytest.mark.parametrize("n,k,seed", [(64, 3, 42), (10, 2, 0), (7, 5, 3)])
def test_kfold_swapped_val_matches_jax(n, k, seed):
    got = list(data_splitter.kfold_swapped_val(n, k=k, seed=seed))
    ref = list(jsplit.kfold_swapped_val(n, k=k, seed=seed))
    assert len(got) == len(ref) == k
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


def test_kfold_indices_and_idx_generator_match_jax():
    for g, r in zip(data_splitter.kfold_indices(23, k=4, seed=1),
                    jsplit.kfold_indices(23, k=4, seed=1)):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(data_splitter.idx_generator(50, 0.2, 0.1, seed=9),
                    jsplit.idx_generator(50, 0.2, 0.1, seed=9)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- datasets


@pytest.mark.parametrize("frames,atoms,seed", [(16, 9, 42), (5, 21, 7)])
def test_synthetic_md_dataset_matches_jax(frames, atoms, seed):
    got = synthetic.SyntheticMDDataset(num_frames=frames, num_atoms=atoms, seed=seed)
    ref = jsynthetic.SyntheticMDDataset(num_frames=frames, num_atoms=atoms, seed=seed)
    assert isinstance(got, MemoryGraphDataset) and got.dataset_name == ref.dataset_name
    _assert_graphs_equal(got, ref)


def test_synthetic_qm9_dataset_matches_jax():
    got = synthetic.SyntheticQM9Dataset(num_molecules=12, seed=3).set_ranges()
    ref = jsynthetic.SyntheticQM9Dataset(num_molecules=12, seed=3).set_ranges()
    _assert_graphs_equal(got, ref)


def test_citation_dataset_is_a_memory_graph_dataset():
    got = synthetic.SyntheticCitationDataset(num_nodes=60, seed=2)
    assert isinstance(got, MemoryGraphDataset) and isinstance(got[0], GraphDict)
    _assert_graphs_equal(got, jsynthetic.SyntheticCitationDataset(num_nodes=60, seed=2))


@pytest.mark.parametrize("index", ["slice", "array", "list"])
def test_indexing_matches_jax_and_copies_the_dicts(index):
    ds, jds = _md(frames=10)
    idx = {"slice": slice(2, 9, 3), "array": np.array([7, 1, 4]), "list": [0, 0, 5]}[index]
    got, ref = ds[idx], jds[idx]
    assert type(got) is MemoryGraphList
    _assert_graphs_equal(got, ref)
    # a split is relabelled in place; the dataset keeps its arrays
    before = [dict(g) for g in ds]
    for g in got:
        g["energy"] = g["energy"] * 2.0
        g["extra"] = np.zeros(1)
    _assert_graphs_equal(ds, before)
    assert isinstance(ds[3], GraphDict) and ds[3] is ds[3]


def test_map_list_set_range_set_angle_match_jax():
    ds, jds = _md(frames=8)
    _assert_graphs_equal(ds, jds)
    assert all(len(g["angle_indices_nodes"]) for g in ds)


def test_graph_dict_api_matches_jax():
    g = {"node_number": np.array([1, 6, 8]), "node_coordinates": np.eye(3, dtype=np.float32),
         "node_attr_x": np.ones(3), "edge_indices": np.array([[0, 1], [1, 0]])}
    got, ref = GraphDict(g), JGraphDict(g)
    for keys in ("node_", ["edge", "node_c"], "node_[a-z]+"):
        assert got.search_properties(keys) == ref.search_properties(keys)
    assert got._num_nodes() == ref._num_nodes() == 3
    got.apply_preprocessor("set_range", max_distance=2.0)
    ref.apply_preprocessor("set_range", max_distance=2.0)
    _assert_graphs_equal([got], [ref])
    assert preprocess.get_preprocessor("set_angle").get_config() == {}
    assert preprocess.get_preprocessor("set_range_periodic").get_config() == {}
    with pytest.raises(KeyError):
        preprocess.get_preprocessor("set_range_nowhere")


@pytest.mark.parametrize("batch_size", [1, 4, 16])
def test_batch_shape_hint_matches_jax(batch_size):
    ds, jds = _md(frames=20)
    assert ds.batch_shape_hint(batch_size) == jds.batch_shape_hint(batch_size)
    ds2, jds2 = _md(frames=20, angles=False)
    assert ds2.batch_shape_hint(batch_size) == jds2.batch_shape_hint(batch_size)


def test_to_batch_and_to_batches_match_jax():
    ds, jds = _md(frames=11, esp=True)
    keys = ("energy", "total_charge")
    _assert_batches_equal(ds.to_batch(global_keys=keys, device="cpu"),
                          jds.to_batch(global_keys=keys, np_out=True))
    got = ds.to_batches(4, shuffle=True, seed=3, global_keys=keys, device="cpu")
    ref = jds.to_batches(4, shuffle=True, seed=3, global_keys=keys, np_out=True)
    assert len(got) == len(ref) == 3
    for tb, jb in zip(got, ref):
        _assert_batches_equal(tb, jb)


def test_save_load_round_trip_reads_the_jax_pickle(tmp_path):
    ds, jds = _md(frames=6)
    jds.save(str(tmp_path / "jax.pickle"))
    _assert_graphs_equal(MemoryGraphDataset().load(str(tmp_path / "jax.pickle")), jds)
    ds.save(str(tmp_path / "port.pickle"))
    _assert_graphs_equal(JDataset().load(str(tmp_path / "port.pickle")), ds)


# -------------------------------------------------------------- scaler


def test_scaler_fit_transform_inverse_and_json_match_jax(tmp_path):
    qm = synthetic.SyntheticQM9Dataset(num_molecules=30, seed=4)
    for g in qm:
        g["force"] = np.random.RandomState(len(g["node_number"])).randn(
            len(g["node_number"]), 3).astype(np.float32)
    jqm = jsynthetic.SyntheticQM9Dataset(num_molecules=30, seed=4)
    for jg, g in zip(jqm, qm):
        jg["force"] = g["force"]
    s, js = scalers.EnergyForceExtensiveLabelScaler(), jscalers.EnergyForceExtensiveLabelScaler()
    s.fit_dataset(qm[:20])
    js.fit_dataset(jqm[:20])
    np.testing.assert_array_equal(s.ridge_coef_, js.ridge_coef_)
    np.testing.assert_array_equal(s.scale_, js.scale_)
    y = np.array([g["energy"][0] for g in qm])
    z = [g["node_number"] for g in qm]
    np.testing.assert_array_equal(s.transform(y, z), js.transform(y, z))
    np.testing.assert_array_equal(s.inverse_transform(y, z), js.inverse_transform(y, z))
    _assert_graphs_equal(s.transform_dataset(qm[20:]), js.transform_dataset(jqm[20:]))
    _assert_graphs_equal(s.inverse_transform_dataset(s.transform_dataset(qm[5:9])),
                         js.inverse_transform_dataset(js.transform_dataset(jqm[5:9])))
    s.save(str(tmp_path / "port.json"))
    js.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    loaded = scalers.EnergyForceExtensiveLabelScaler().load(str(tmp_path / "jax.json"))
    np.testing.assert_array_equal(loaded.transform(y, z), js.transform(y, z))
    assert json.loads((tmp_path / "port.json").read_text())["alpha"] == 1e-9


# -------------------------------------------------------------- loader


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_batches_match_jax_over_two_epochs(shuffle, drop_last):
    ds, jds = _md(frames=23, esp=True)
    keys = ("energy", "total_charge")
    hint = ds.batch_shape_hint(5)
    loader = GraphBatchLoader(list(ds), 5, shuffle=shuffle, seed=11, drop_last=drop_last,
                              device="cpu", global_keys=keys, **hint)
    jloader = JLoader(list(jds), 5, shuffle=shuffle, seed=11, drop_last=drop_last,
                      device_put=False, global_keys=keys, **hint)
    assert len(loader) == len(jloader) == (4 if drop_last else 5)
    for _ in range(2):
        got, ref = list(loader), list(jloader)
        assert len(got) == len(ref) == len(loader)
        for tb, jb in zip(got, ref):
            _assert_batches_equal(tb, jb)


def test_loader_raises_the_producers_error_and_stops_early():
    ds, _ = _md(frames=9)
    bad = GraphBatchLoader(list(ds), 3, device="cpu", n_node_pad=4)
    with pytest.raises(ValueError, match="n_node_pad=4 too small"):
        list(bad)
    loader = GraphBatchLoader(list(ds), 3, shuffle=False, device="cpu")
    it = iter(loader)
    first = next(it)
    it.close()  # the producer stops; a new epoch starts afresh
    again = next(iter(loader))
    assert first.n_graphs == again.n_graphs == 4


def test_loader_and_to_batch_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, _ = _md(frames=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphBatchLoader(list(ds), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.to_batch()
    GraphBatchLoader(list(ds), 2, device="cpu")
