"""The host side of the port's slice 17 against the JAX package, on the CPU:
the data methods, ``GraphDict.to_networkx``, ``GraphBatch.replace_globals``,
the five geometry functions, the preprocessors with
``set_range_periodic``, the crystal graph builder, the molecular file
readers, the visual-graph datasets and ``MockImportanceModel``, and
periodic ``ScannedMD``.

Host numpy code must match bit for bit (JAX's ``backend="numpy"`` where it
has a native path); the geometry functions on tensors within rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.crystal import graph_builder as jgb
from gcnn_keras_tpu.data import dataset as jdataset
from gcnn_keras_tpu.data import serial as jserial
from gcnn_keras_tpu.data.datasets import synthetic as jsynthetic
from gcnn_keras_tpu.data.datasets import vgd as jvgd
from gcnn_keras_tpu.data.graph_dict import GraphDict as JGraphDict
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.layers import geometry as jgeo
from gcnn_keras_tpu.mol import io as jio
from gcnn_keras_tpu.models import registry as jregistry
from gcnn_keras_tpu.moldyn.trajectory import ScannedMD as JScannedMD
from gcnn_keras_tpu.models.schnet import make_model as jmake_schnet
from gcnn_keras_tpu.training.callbacks import TrainingTimer as JTrainingTimer
from gcnn_keras_tpu.xai import testing as jxai
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.crystal import graph_builder as gb
from gcnn_keras_tpu_torch.data import dataset, serial
from gcnn_keras_tpu_torch.data.datasets import synthetic, vgd
from gcnn_keras_tpu_torch.data.graph_dict import GraphDict
from gcnn_keras_tpu_torch.graph import preprocess as pre
from gcnn_keras_tpu_torch.layers import geometry as geo
from gcnn_keras_tpu_torch.mol import io
from gcnn_keras_tpu_torch.models import registry
from gcnn_keras_tpu_torch.models.schnet import make_model as make_schnet
from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
from gcnn_keras_tpu_torch.training.callbacks import TrainingTimer
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from gcnn_keras_tpu_torch.xai import testing as xai

torch.set_num_threads(1)


def _same(a, b):
    """Two graph dicts (or lists of them) with the same keys and the same
    arrays, dtypes included."""
    if isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert sorted(a) == sorted(b)
    for k in b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# --------------------------------------------------------- the data layer


def _graphs(n=5, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        m = rs.randint(2, 6)
        out.append({"node_number": rs.randint(1, 9, size=m),
                    "node_coordinates": rs.randn(m, 3).astype(np.float32),
                    "edge_indices": np.array([[0, 1], [1, 0]]),
                    "graph_labels": np.array([float(i)], dtype=np.float32)})
    return out


def test_list_property_methods_match_jax():
    ours, ref = dataset.MemoryGraphList(_graphs()), jdataset.MemoryGraphList(_graphs())
    values = [np.arange(i + 1) for i in range(5)]
    values[2] = None  # left as it is
    ours.assign_property("extra", values)
    ref.assign_property("extra", values)
    got, want = ours.obtain_property("extra"), ref.obtain_property("extra")
    assert [v is None for v in got] == [v is None for v in want] == [False, False, True,
                                                                     False, False]
    for x, y in zip(got, want):
        if y is not None:
            np.testing.assert_array_equal(x, y)
    assert ours.obtain_property("absent") == ref.obtain_property("absent") == [None] * 5
    with pytest.raises(ValueError, match="assign_property"):
        ours.assign_property("extra", [1, 2])
    with pytest.raises(AssertionError):
        ref.assign_property("extra", [1, 2])


def test_clean_and_assert_valid_model_input_match_jax():
    graphs = _graphs(6)
    graphs[1]["force"] = np.zeros((0, 3))   # empty: dropped
    graphs[3]["force"] = None               # None: dropped
    for g in graphs[:1] + graphs[2:3] + graphs[4:]:
        g["force"] = np.ones((len(g["node_number"]), 3))
    ours, ref = dataset.MemoryGraphDataset(graphs=graphs), \
        jdataset.MemoryGraphDataset(graphs=graphs)
    with pytest.raises(ValueError, match=r"\['absent'\]"):
        ours.assert_valid_model_input(["node_number", "absent"])
    with pytest.raises(ValueError, match=r"\['absent'\]"):
        ref.assert_valid_model_input(["node_number", "absent"])
    kept = ours.clean(["node_number", "force"])
    np.testing.assert_array_equal(kept, ref.clean(["node_number", "force"]))
    np.testing.assert_array_equal(kept, [0, 2, 4, 5])
    _same([dict(g) for g in ours], [dict(g) for g in ref])
    ours.assert_valid_model_input(["node_number", "force"])


def test_read_in_table_file_matches_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    path = tmp_path / "labels.csv"
    path.write_text("index,energy,name\n0,-1.5,a\n1,2.25,b\n2,0.0,c\n")
    ours = dataset.MemoryGraphDataset(data_directory=str(tmp_path), file_name="labels.csv")
    ref = jdataset.MemoryGraphDataset(data_directory=str(tmp_path), file_name="labels.csv")
    pd.testing.assert_frame_equal(ours.read_in_table_file().data_frame,
                                  ref.read_in_table_file().data_frame)
    pd.testing.assert_frame_equal(
        ours.read_in_table_file(str(path), index_col=0).data_frame,
        ref.read_in_table_file(str(path), index_col=0).data_frame)


def test_to_networkx_matches_jax():
    nx = pytest.importorskip("networkx")
    g = {"node_number": np.array([1, 6, 8]), "node_coordinates": np.eye(3, dtype=np.float32),
         "node_mask_x": np.ones(3), "node_short": np.ones(2),
         "edge_indices": np.array([[0, 1], [1, 0], [2, 1]])}
    ours, ref = GraphDict(g).to_networkx(), JGraphDict(g).to_networkx()
    assert isinstance(ours, nx.DiGraph)
    assert sorted(ours.edges) == sorted(ref.edges) == [(0, 1), (1, 0), (1, 2)]
    assert list(ours.nodes) == list(ref.nodes)
    for i in ours.nodes:
        assert sorted(ours.nodes[i]) == sorted(ref.nodes[i]) == [
            "node_coordinates", "node_mask_x", "node_number"]
        for k in ref.nodes[i]:
            np.testing.assert_array_equal(ours.nodes[i][k], ref.nodes[i][k])


def test_replace_globals_matches_jax():
    graphs = _graphs(3)
    ours = batch_graphs(graphs, global_keys=("graph_labels",), device="cpu")
    ref = jbatch_graphs(graphs, global_keys=("graph_labels",))
    new = torch.arange(4, dtype=torch.float32)[:, None]
    got = ours.replace_globals(graph_labels=new, extra=new * 2)
    want = ref.replace_globals(graph_labels=jnp.asarray(new.numpy()),
                               extra=jnp.asarray(new.numpy() * 2))
    assert sorted(got.globals) == sorted(want.globals)
    for k in want.globals:
        np.testing.assert_array_equal(got.globals[k].numpy(), np.asarray(want.globals[k]))
    np.testing.assert_array_equal(ours.globals["graph_labels"].numpy(),
                                  np.asarray(ref.globals["graph_labels"]))
    assert got.nodes is ours.nodes


def test_synthetic_qm9_host_methods_and_timer_and_register_model():
    ds = synthetic.SyntheticQM9Dataset(num_molecules=3, seed=5)
    assert ds.prepare_data() is ds and ds.read_in_memory() is ds
    ref = jsynthetic.SyntheticQM9Dataset(num_molecules=3, seed=5)
    _same([dict(g) for g in ds.prepare_data().read_in_memory()],
          [dict(g) for g in ref.prepare_data().read_in_memory()])
    ours, theirs = TrainingTimer(), JTrainingTimer()
    assert ours.mean_epoch_time == theirs.mean_epoch_time == 0.0
    ours.epoch_times = theirs.epoch_times = [0.5, 1.0, 2.25]
    assert ours.mean_epoch_time == theirs.mean_epoch_time == pytest.approx(3.75 / 3)

    def builder():
        return "built"
    assert registry.register_model("Mine")(builder) is builder
    assert jregistry.register_model("Mine")(builder) is builder
    assert registry._REGISTRY["Mine"] is jregistry._REGISTRY["Mine"] is builder


# --------------------------------------------------------- geometry


def _periodic_graphs():
    rs = np.random.RandomState(2)
    out = []
    for lat in (np.eye(3) * 4.0, np.array([[4.0, 0, 0], [1.2, 3.8, 0], [0.7, 0.9, 4.2]])):
        frac = rs.rand(4, 3)
        g = {"node_number": rs.randint(1, 9, size=4),
             "node_coordinates": (frac @ lat).astype(np.float32),
             "graph_lattice": lat.astype(np.float32)}
        g = pre.set_range_periodic(g, max_distance=3.0)
        g["edge_indices"] = g.pop("range_indices")
        g = pre.set_angle(g, range_indices="edge_indices")
        out.append(g)
    return out


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def test_geometry_functions_match_jax():
    graphs = _periodic_graphs()
    ours, ref = batch_graphs(graphs, device="cpu"), jbatch_graphs(graphs)
    # the padding graph's lattice is zeros; real_to_frac inverts every graph's
    lat = np.asarray(ref.globals["graph_lattice"]).copy()
    lat[-1] = np.eye(3)
    ours = ours.replace_globals(graph_lattice=torch.as_tensor(lat))
    ref = ref.replace_globals(graph_lattice=jnp.asarray(lat))
    rs = np.random.RandomState(3)
    d = rs.rand(50, 1).astype(np.float32) * 5
    for bins, dmax in ((20, 4.0), (7, 5.5)):
        _close(geo.fourier_basis(torch.as_tensor(d), bins, dmax),
               jgeo.fourier_basis(jnp.asarray(d), bins, dmax))
    frac = rs.rand(ours.n_node, 3).astype(np.float32)
    _close(geo.frac_to_real_coordinates(ours, torch.as_tensor(frac)),
           jgeo.frac_to_real_coordinates(ref, jnp.asarray(frac)))
    _close(geo.frac_to_real_coordinates(ours), jgeo.frac_to_real_coordinates(ref))
    _close(geo.real_to_frac_coordinates(ours), jgeo.real_to_frac_coordinates(ref))
    _close(geo.real_to_frac_coordinates(ours, torch.as_tensor(frac)),
           jgeo.real_to_frac_coordinates(ref, jnp.asarray(frac)))
    _close(geo.displacement_vectors_unit_cell(ours), jgeo.displacement_vectors_unit_cell(ref))
    pos = rs.randn(ours.n_node, 3).astype(np.float32)
    pos[1] = pos[0]  # a zero-length leg
    for args in ((), (pos,)):
        got = geo.angle_triples(ours, *(torch.as_tensor(a) for a in args))
        want = jgeo.angle_triples(ref, *(jnp.asarray(a) for a in args))
        for g, w in zip(got, want):
            _close(g, w)


def test_angle_triples_needs_angles():
    g = dict(_graphs(1)[0])
    with pytest.raises(ValueError, match="no angle triples"):
        geo.angle_triples(batch_graphs([g], device="cpu"))


# --------------------------------------------------------- preprocessors

CELLS = {
    "cubic": (np.eye(3) * 3.0, np.array([[0.0, 0, 0], [0.5, 0.5, 0.5]])),
    "skewed": (np.array([[4.0, 0, 0], [1.2, 3.8, 0], [0.7, 0.9, 4.2]]),
               np.random.RandomState(0).rand(5, 3)),
    "one_atom": (np.eye(3) * 2.5, np.zeros((1, 3))),
}


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("kw", [dict(max_distance=4.0), dict(max_distance=5.0, max_neighbours=6),
                                dict(max_distance=3.0, exclusive=False)],
                         ids=["cutoff", "capped", "all"])
def test_set_range_periodic_matches_jax_bit_for_bit(cell, kw):
    lat, frac = CELLS[cell]
    g = {"node_number": np.arange(len(frac)) + 1, "node_coordinates": frac @ lat,
         "graph_lattice": lat}
    for backend in ("auto", "numpy"):
        _same(pre.set_range_periodic(dict(g), backend=backend, **kw),
              jpre.set_range_periodic(dict(g), backend="numpy", **kw))
    assert pre.get_preprocessor("set_range_periodic", **kw)(dict(g)).keys() == \
        jpre.get_preprocessor("set_range_periodic", **kw)(dict(g)).keys()
    # the C++ cell list: the same lists; where the cap cuts through the cubic
    # cell's exact ties it may keep other images of the same sender and
    # distance
    native_out = pre.set_range_periodic(dict(g), backend="native", **kw)
    ref = jpre.set_range_periodic(dict(g), backend="numpy", **kw)
    if cell == "cubic" and "max_neighbours" in kw:
        native_out["range_image"] = ref["range_image"]
    _same(native_out, ref)


def _molecule():
    rs = np.random.RandomState(4)
    return {"node_number": rs.randint(1, 9, size=6),
            "node_coordinates": rs.randn(6, 3).astype(np.float32),
            "edge_indices": np.array([[0, 1], [1, 2], [2, 1], [3, 0], [5, 4], [1, 0], [3, 3]]),
            "edge_attributes": np.arange(7, dtype=np.float32)[:, None],
            "range_attributes": rs.rand(7, 1).astype(np.float32) * 4,
            "graph_lattice": np.array([[3.0, 0, 0], [0.4, 2.8, 0], [0, 0.3, 3.3]])}


PREPROCESSORS = [
    ("make_undirected_edges", {}), ("add_edge_self_loops", {}),
    ("sort_edge_indices", {}), ("sort_edge_indices", {"edge_attributes": ["edge_attributes",
                                                                         "absent"]}),
    ("set_edge_indices_reverse", {}), ("count_nodes_and_edges", {}),
    ("pad_property", {"key": "node_number", "pad_width": (0, 3), "value": 9}),
    ("shift_to_unit_cell", {}), ("expand_distance_gauss_basis", {}),
    ("expand_distance_gauss_basis", {"bins": 5, "distance": 3.0, "sigma": 0.7, "offset": 0.5}),
    ("set_range", {"max_distance": 2.0, "backend": "numpy"}),
    ("set_angle", {"range_indices": "edge_indices"}),
    ("set_edge_weights_uniform", {"value": 0.5}), ("normalize_edge_weights_symmetric", {}),
]


@pytest.mark.parametrize("name,kw", PREPROCESSORS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(PREPROCESSORS)])
def test_preprocessors_match_jax_bit_for_bit(name, kw):
    g = _molecule()
    ours, ref = pre.get_preprocessor(name, **kw), jpre.get_preprocessor(name, **kw)
    assert ours.get_config() == ref.get_config()
    _same(ours(dict(g)), ref(dict(g)))
    _same(GraphDict(g).apply_preprocessor(name, **kw), JGraphDict(g).apply_preprocessor(name, **kw))


def test_preprocessor_registry_is_the_jax_registry():
    assert sorted(pre._PREPROCESSORS) == sorted(jpre._PREPROCESSORS)
    for name, fn in pre._PREPROCESSORS.items():
        assert fn.__name__ == jpre._PREPROCESSORS[name].__name__
    empty = {"node_number": np.arange(3), "edge_indices": np.zeros((0, 2), dtype=np.int64)}
    for name in ("make_undirected_edges", "add_edge_self_loops", "sort_edge_indices",
                 "set_edge_indices_reverse", "count_nodes_and_edges"):
        _same(pre.get_preprocessor(name)(dict(empty)), jpre.get_preprocessor(name)(dict(empty)))


# --------------------------------------------------------- crystal graph builder


def _cubic(a=3.0):
    return {"graph_lattice": np.eye(3) * a, "frac_coords": np.zeros((1, 3)),
            "atomic_numbers": np.array([26])}


def _bcc(a=3.0):
    return {"graph_lattice": np.eye(3) * a,
            "frac_coords": np.array([[0, 0, 0], [0.5, 0.5, 0.5]]),
            "atomic_numbers": np.array([26, 26])}


def _fcc(a=3.6):
    return {"graph_lattice": np.eye(3) * a,
            "frac_coords": np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]),
            "atomic_numbers": np.array([29] * 4)}


def _random_cell():
    rs = np.random.RandomState(0)
    return {"graph_lattice": np.eye(3) * 5 + rs.randn(3, 3) * 0.1,
            "frac_coords": rs.rand(5, 3) * 1.5 - 0.2,  # some outside the cell
            "atomic_numbers": np.array([6, 8, 1, 1, 14])}


class _Structure:
    """A pymatgen ``Structure`` by duck typing."""

    def __init__(self, s):
        lat, frac = np.asarray(s["graph_lattice"]), np.asarray(s["frac_coords"])
        self.lattice = type("L", (), {"matrix": lat})()
        self.frac_coords, self.cart_coords = frac, frac @ lat
        self.sites = [type("S", (), {"specie": type("E", (), {"Z": int(z)})()})()
                      for z in s["atomic_numbers"]]


STRUCTURES = {"cubic": _cubic, "bcc": _bcc, "fcc": _fcc, "random": _random_cell}


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_graph_builder_functions_match_jax_bit_for_bit(name):
    s = STRUCTURES[name]()
    for symmetrize in (False, True):
        _same(gb.structure_to_graph(s, symmetrize), jgb.structure_to_graph(s, symmetrize))
    _same(gb.structure_to_graph(_Structure(s)), jgb.structure_to_graph(_Structure(s)))
    g = gb.structure_to_graph(s)
    _same(gb.symmetrize_graph(g), jgb.symmetrize_graph(g))
    pairs = [(gb.add_radius_bonds(g, radius=4.0), jgb.add_radius_bonds(g, radius=4.0)),
             (gb.add_radius_bonds(g, 5.0, 8), jgb.add_radius_bonds(g, 5.0, 8)),
             (gb.add_knn_bonds(g, k=6), jgb.add_knn_bonds(g, k=6)),
             (gb.add_voronoi_bonds(g), jgb.add_voronoi_bonds(g))]
    for ours, ref in pairs:
        _same(ours, ref)
        doubled = {**ours, **{k: np.concatenate([ours[k]] * 2) for k in
                              ("range_indices", "range_image", "range_attributes")}}
        _same(gb.remove_duplicate_edges(doubled), jgb.remove_duplicate_edges(doubled))
        for kw in ({}, {"frac_offset": True}, {"offset": False, "distance": False}):
            _same(gb.add_edge_information(ours, **kw), jgb.add_edge_information(ours, **kw))
        _same(gb.to_supercell_graph(ours, (2, 2, 1)), jgb.to_supercell_graph(ours, (2, 2, 1)))
    sym = gb.add_radius_bonds(gb.structure_to_graph(s, symmetrize=True), radius=3.0)
    _same(gb.to_asymmetric_unit_graph(sym), jgb.to_asymmetric_unit_graph(sym))
    with pytest.raises(ValueError, match="symmetry"):
        gb.to_asymmetric_unit_graph(g)


def test_asymmetric_unit_graph_with_orbits_matches_jax():
    g = gb.symmetrize_graph(gb.structure_to_graph(_bcc()))
    g["node_asymmetric_mapping"] = np.array([0, 0])
    g["node_multiplicity"] = np.array([2, 2])
    g = gb.add_radius_bonds(g, radius=2.7)
    _same(gb.to_asymmetric_unit_graph(g), jgb.to_asymmetric_unit_graph(g))


CRYSTAL_PREPROCESSORS = [
    ("RadiusUnitCell", (3.5,)), ("KNNUnitCell", (6,)), ("VoronoiUnitCell", ()),
    ("RadiusSuperCell", (3.5, (2, 2, 2))), ("KNNSuperCell", (4, (2, 1, 1))),
    ("VoronoiSuperCell", ((1, 2, 1),)), ("RadiusAsymmetricUnitCell", (3.0,)),
    ("KNNAsymmetricUnitCell", (6,)), ("VoronoiAsymmetricUnitCell", ()),
]


@pytest.mark.parametrize("cls,args", CRYSTAL_PREPROCESSORS, ids=[c for c, _ in CRYSTAL_PREPROCESSORS])
def test_crystal_preprocessors_match_jax_bit_for_bit(cls, args):
    ours, ref = getattr(gb, cls)(*args), getattr(jgb, cls)(*args)
    assert ours.get_config() == ref.get_config()
    assert ours.hash() == ref.hash()
    assert ours == getattr(gb, cls)(*args) and hash(ours) == hash(ref)
    for make in (_fcc, _random_cell):
        _same(ours(make()), ref(make()))


# --------------------------------------------------------- molecular file IO


def test_symbols_and_xyz_files_match_jax(tmp_path):
    assert io.SYMBOL_TO_Z == jio.SYMBOL_TO_Z and io.PERIODIC_TABLE == jio.PERIODIC_TABLE
    for sym in ("H", "cl", "CL", " Fe ", "8", "n"):
        assert io._symbol_to_z(sym) == jio._symbol_to_z(sym)
    rs = np.random.RandomState(1)
    mols = [(list(rs.randint(1, 18, size=n)), rs.randn(n, 3).tolist()) for n in (3, 1, 5)]
    io.write_xyz_file(str(tmp_path / "a.xyz"), mols, comments=["one", "", "three"])
    jio.write_xyz_file(str(tmp_path / "b.xyz"), mols, comments=["one", "", "three"])
    assert (tmp_path / "a.xyz").read_text() == (tmp_path / "b.xyz").read_text()
    io.write_xyz_file(str(tmp_path / "c.xyz"), mols)
    text = (tmp_path / "c.xyz").read_text()
    (tmp_path / "c.xyz").write_text("\n" + text.replace("\n3\n", "\n\n3\n", 1))  # blank lines
    for path in ("a.xyz", "c.xyz"):
        ours, ref = io.read_xyz_file(str(tmp_path / path)), jio.read_xyz_file(str(tmp_path / path))
        assert ours == ref and len(ours) == 3


def test_extxyz_and_sdf_readers_match_jax(tmp_path):
    (tmp_path / "f.extxyz").write_text(
        "2\n"
        'energy=-1.25 charge=1 Lattice="5 0 0 0 5 0 0 0 5" '
        "Properties=species:S:1:pos:R:3:forces:R:3:tag:I:1\n"
        "O 0.0 0.0 0.1 0.5 -0.5 0.25 7\nH 0.0 0.8 0.5 -0.1 0.2 0.3 1\n"
        "\n1\nEnergy=3.5 total_charge=0\nC 1.0 2.0 3.0\n"
        "1\nProperties=species:S:1:pos:R:3:force:R:3\nN 0 0 0 1 2 3\n")
    ours, ref = io.read_extxyz_file(str(tmp_path / "f.extxyz")), \
        jio.read_extxyz_file(str(tmp_path / "f.extxyz"))
    _same(ours, ref)
    assert sorted(ours[0]) == ["energy", "force", "graph_lattice", "node_coordinates",
                               "node_number", "total_charge"]
    sdf = ("mol1\n  prog\n\n  2  1  0  0  0  0  0  0  0  0999 V2000\n"
           "    0.0000    0.0000    0.0000 C   0  0\n"
           "    1.2000    0.0000    0.0000 O   0  0\n"
           "  1  2  2  0\nM  END\n$$$$\n"
           "short\n$$$$\nbad\n\n\nxx\n$$$$\n"
           "mol2\n\n\n  1  0  0  0  0  0  0  0  0  0999 V2000\n"
           "   -0.5000    0.2500    1.0000 Cl  0  0\nM  END\n$$$$\n")
    (tmp_path / "m.sdf").write_text(sdf)
    ours = io.read_sdf_coordinates(str(tmp_path / "m.sdf"))
    assert ours == jio.read_sdf_coordinates(str(tmp_path / "m.sdf"))
    assert [a for a, _ in ours] == [[6, 8], [17]]


# --------------------------------------------------------- visual-graph data


@pytest.mark.parametrize("name,kw", [("VgdMockDataset", dict(num_graphs=12, seed=3)),
                                     ("VgdRbMotifsDataset", dict(num_graphs=12, seed=4)),
                                     ("VgdRbMotifsDataset", {})])
def test_vgd_datasets_match_jax_bit_for_bit(name, kw):
    ours, ref = getattr(vgd, name)(**kw), getattr(jvgd, name)(**kw)
    assert ours.dataset_name == ref.dataset_name
    _same([dict(g) for g in ours], [dict(g) for g in ref])
    assert vgd.VgdMockDataset is xai.VgdMockDataset
    cfg = {"class_name": name, "config": kw,
           "methods": [{"map_list": {"method": "set_edge_weights_uniform"}}]}
    _same([dict(g) for g in serial.deserialize(cfg)], [dict(g) for g in jserial.deserialize(cfg)])


@pytest.mark.parametrize("sort_edges", [True, False])
def test_mock_importance_model_matches_jax(sort_edges):
    graphs = [dict(g) for g in vgd.VgdMockDataset(num_graphs=4, seed=1)]
    ours = xai.MockImportanceModel(3)(batch_graphs(graphs, sort_edges_by_receiver=sort_edges,
                                                   device="cpu"))
    jm = jxai.MockImportanceModel(3)
    jb = jbatch_graphs(graphs, sort_edges_by_receiver=sort_edges)
    ref = jm.apply(jm.init(None, jb), jb)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)


# --------------------------------------------------------- periodic ScannedMD


def test_periodic_scanned_md_matches_jax():
    """The recipe of ``tests/test_scanned_md.py``'s periodic case: NaCl in
    its cubic cell, the JAX SchNet's weights carried into the port; the
    energies and positions of three segments from seeded velocities against
    the JAX ScannedMD's, the first energy against a direct evaluation, and a
    start one lattice vector away wrapped back to the same energy."""
    a = 5.64
    z = np.array([11, 17, 11, 17])
    frac = np.array([[0.0, 0, 0], [0.5, 0, 0], [0.0, 0.5, 0.5], [0.5, 0.5, 0.5]],
                    dtype=np.float32)
    lat = (np.eye(3) * a).astype(np.float32)
    pos = frac @ lat + np.random.RandomState(0).randn(4, 3).astype(np.float32) * 0.05
    g = {"node_number": z, "node_coordinates": pos, "graph_lattice": lat,
         "energy": np.array([0.0], dtype=np.float32)}
    g = pre.set_range_periodic(g, max_distance=4.0, max_neighbours=14)
    g["edge_indices"] = g.pop("range_indices")
    jm = jmake_schnet(depth=2)
    jb = jbatch_graphs([g], global_keys=("energy",))
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jb))
    tm = params_from_jax(make_schnet(depth=2, device="cpu"), variables)
    e_direct = tm(batch_graphs([g], global_keys=("energy",), device="cpu"))["output"][0, 0].item()

    kw = dict(dt=1e-3, segment_steps=20, max_distance=4.0, max_neighbours=14)
    system = {"node_number": z, "node_coordinates": pos, "graph_lattice": lat,
              "velocities": np.random.RandomState(1).randn(4, 3).astype(np.float32)}
    out = ScannedMD(tm, device="cpu", **kw).run_ensemble([system], n_segments=3)
    ref = JScannedMD(jm, variables, **kw).run_ensemble([system], n_segments=3)
    assert np.isfinite(out["e_pot"]).all() and out["e_pot"].shape == (60, 1)
    np.testing.assert_allclose(out["e_pot"], np.asarray(ref["e_pot"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["pos"][0], np.asarray(ref["pos"][0]), rtol=1e-5, atol=1e-5)
    assert out["edge_counts"] == list(ref["edge_counts"])
    assert abs(out["e_pot"][0, 0] - e_direct) < 1e-4

    moved = pos.copy()
    moved[1] += lat[0] * 2.0
    out2 = ScannedMD(tm, device="cpu", **kw).run_ensemble(
        [dict(system, node_coordinates=moved)], n_segments=1)
    assert abs(out2["e_pot"][0, 0] - out["e_pot"][0, 0]) < 1e-4
