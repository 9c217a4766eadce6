"""The dataset classes and their download layer of the port against the JAX
package's, on archives written here in the published layouts and served
through ``DownloadDataset``'s ``file://`` path (or placed in the dataset
root, where a class builds its URL inline), into a dataset root of each
package under ``tmp_path``. Nothing else is fetched: every fetch of the
module is checked to be a ``file://`` URL.

Every class of the JAX table builds in both packages from the same
archive, and every graph's every key is equal bit for bit, of the same
dtype, in the same order. The MoleculeNet classes fetch and read their CSV
and then need RDKit: without it both raise the same ``ImportError``, and
the port's CSV reader (``data/csv_table.py``, no pandas) gives pandas'
columns. The archive writers of ``tests/test_real_format_archives.py`` are
reused; the others are written here.
"""
import gzip
import io
import json
import os
import shutil
import sqlite3
import tarfile
import urllib.request
import zipfile

import numpy as np
import pytest

import gcnn_keras_tpu.data.download as jdownload
from gcnn_keras_tpu.data import serial as jserial
from gcnn_keras_tpu_torch.data import csv_table, serial
from gcnn_keras_tpu_torch.data import download
from tests.test_real_format_archives import (_make_esol_csv, _make_iso17_tar,
                                             _make_qm7_mat, _make_qm9_zip, _make_rmd17_npz,
                                             _sdf_record, _write_ase_sqlite)

RMD17_QUERY = "&record_id=466"  # what MD17RevisedDataset appends to its URL
MATBENCH_TASKS = {"MatProjectEFormDataset": "matbench_mp_e_form",
                  "MatProjectGapDataset": "matbench_mp_gap",
                  "MatProjectIsMetalDataset": "matbench_mp_is_metal",
                  "MatProjectDielectricDataset": "matbench_dielectric",
                  "MatProjectJdft2dDataset": "matbench_jdft2d",
                  "MatProjectLogGVRHDataset": "matbench_log_gvrh",
                  "MatProjectLogKVRHDataset": "matbench_log_kvrh",
                  "MatProjectPerovskitesDataset": "matbench_perovskites",
                  "MatProjectPhononsDataset": "matbench_phonons",
                  "MatBenchDataset2020": "matbench_mp_e_form"}
# each dataset name of the JAX table that reads files: (its config, the
# keywords of its read_in_memory)
CASES = {
    "QM7Dataset": ({}, {}),
    "QM7bDataset": ({}, {"label_column_name": "homo_gw"}),
    "QM8Dataset": ({}, {}),
    "QM9Dataset": ({}, {"label_column_name": "U0"}),
    "MD17Dataset": ({"trajectory_name": "aspirin_ccsd"}, {"max_frames": 5}),
    "MD17RevisedDataset": ({"trajectory_name": "aspirin"}, {}),
    "ISO17Dataset": ({}, {}),
    "CoraDataset": ({}, {}),
    "CoraLuDataset": ({}, {}),
    "ESOLDataset": ({}, {}),
    "FreeSolvDataset": ({}, {}),
    "LipopDataset": ({}, {}),
    "ClinToxDataset": ({}, {}),
    "Tox21MolNetDataset": ({}, {}),
    "SIDERDataset": ({}, {}),
    "MoleculeNetDataset2018": ({"dataset_name": "BACE"}, {}),
    "QM9MolNetDataset": ({}, {}),
    "MUTAGDataset": ({}, {}),
    "MutagenicityDataset": ({}, {}),
    "PROTEINSDataset": ({}, {}),
    "GraphTUDataset2020": ({"dataset_name": "MUTAG"}, {}),
    **{name: ({}, {"radius": 4.0, "max_neighbours": 8}) for name in MATBENCH_TASKS},
    "VisualGraphDataset": ({"name": "vgd"}, {}),
}
MOLECULENET = ("ESOLDataset", "FreeSolvDataset", "LipopDataset", "ClinToxDataset",
               "Tox21MolNetDataset", "SIDERDataset", "MoleculeNetDataset2018",
               "QM9MolNetDataset")
# the CSV each MoleculeNet case reads: (its dataset folder, its file)
MOLECULENET_CSV = {"ESOLDataset": ("ESOL", "delaney-processed.csv"),
                   "FreeSolvDataset": ("FreeSolv", "SAMPL.csv"),
                   "LipopDataset": ("Lipop", "Lipophilicity.csv"),
                   "ClinToxDataset": ("ClinTox", "clintox.csv"),
                   "Tox21MolNetDataset": ("Tox21", "tox21.csv"),
                   "SIDERDataset": ("SIDER", "sider.csv"),
                   "MoleculeNetDataset2018": ("BACE", "bace.csv"),
                   "QM9MolNetDataset": ("QM9MolNet", "qm9.csv")}


# ------------------------------------------------------------ the archives


def _csv(rows):
    return "\n".join(",".join(str(c) for c in r) for r in rows) + "\n"


def _float_rows(rs, n_rows, n_cols, blank=0.0):
    """Random floats printed as Python does (17 significant digits at
    most), some rounded to few, ``blank`` of them missing."""
    out = []
    for _ in range(n_rows):
        row = []
        for v in rs.randn(n_cols) * 10.0 ** rs.randint(-3, 4, size=n_cols):
            c = repr(float(v)) if rs.rand() < 0.5 else f"{v:.3f}"
            row.append("" if rs.rand() < blank else c)
        out.append(row)
    return out


def _npz_bytes(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _gz(path, text):
    with gzip.open(path, "wt") as f:
        f.write(text)


def _tu_zip(srv, name, n_graphs, rs, node_attributes=False, edge_labels=True):
    """``<name>.zip`` in the TUDataset layout: a ``<name>/`` folder of
    ``<name>_A.txt`` (1-based ``sender, receiver`` rows), the graph
    indicator, the graph labels (1 and -1, as MUTAG's), the node labels and
    where asked the edge labels and node attributes."""
    files = {"A": [], "graph_indicator": [], "graph_labels": [], "node_labels": [],
             "edge_labels": [], "node_attributes": []}
    first = 1
    for g in range(n_graphs):
        n = rs.randint(3, 8)
        pairs = {(i, rs.randint(i)) for i in range(1, n)} | \
            {tuple(rs.randint(n, size=2)) for _ in range(2)}
        for a, b in sorted(p for p in pairs if p[0] != p[1]):
            label = rs.randint(4)
            for s, t in ((a, b), (b, a)):
                files["A"].append(f"{first + s}, {first + t}")
                files["edge_labels"].append(str(label))
        files["graph_indicator"] += [str(g + 1)] * n
        files["node_labels"] += [str(v) for v in rs.randint(7, size=n)]
        files["node_attributes"] += [", ".join(repr(float(v)) for v in rs.randn(3))
                                     for _ in range(n)]
        files["graph_labels"].append(str(rs.choice([1, -1])))
        first += n
    keep = ["A", "graph_indicator", "graph_labels", "node_labels"] + \
        (["edge_labels"] if edge_labels else []) + \
        (["node_attributes"] if node_attributes else [])
    with zipfile.ZipFile(os.path.join(srv, f"{name}.zip"), "w") as z:
        for stem in keep:
            z.writestr(f"{name}/{name}_{stem}.txt", "\n".join(files[stem]) + "\n")


def _matbench_rows(rs, n, is_class):
    rows = []
    for i in range(n):
        a = 3.5 + rs.rand()
        lattice = (np.eye(3) * a + rs.randn(3, 3) * 0.1).tolist()
        sites = [{"species": [{"element": el, "occu": 1}], "abc": rs.rand(3).tolist(),
                  "xyz": None, "label": el}
                 for el in rs.choice(["Fe", "O", "Si", "Na", "Cl"], size=rs.randint(1, 4))]
        label = bool(rs.rand() > 0.5) if is_class else float(rs.randn())
        rows.append([{"@module": "pymatgen.core.structure", "@class": "Structure",
                      "lattice": {"matrix": lattice}, "sites": sites}, label])
    return {"index": list(range(n)), "columns": ["structure", "target"], "data": rows}


def write_archives(srv):
    """Every archive of ``CASES`` under ``srv``: those served by URL at
    ``srv/<file>``, those placed in the dataset root under
    ``srv/placed/<dataset folder>/<file>``."""
    rs = np.random.RandomState(11)
    placed = os.path.join(srv, "placed")
    _make_qm9_zip(srv)
    _make_qm7_mat(srv)
    _, data = _make_rmd17_npz(srv, name="aspirin")
    os.replace(os.path.join(srv, "rmd17_aspirin.npz"),
               os.path.join(srv, "rmd17_aspirin.npz" + RMD17_QUERY))
    # the ccsd trajectories are fetched as <name>.zip into md17_<name>.npz
    with open(os.path.join(srv, "aspirin_ccsd.zip"), "wb") as f:
        f.write(_npz_bytes(z=rs.choice([1, 6, 8], size=9).astype(np.int64),
                           R=rs.randn(7, 9, 3), E=rs.randn(7, 1) * 1e5, F=rs.randn(7, 9, 3)))
    _make_iso17_tar(srv)
    from scipy.io import savemat
    Z, R = np.zeros((4, 23)), np.zeros((4, 23, 3))
    for i, n in enumerate(rs.randint(4, 9, size=4)):
        Z[i, :n] = rs.choice([1, 6, 7, 8, 16], size=n)
        R[i, :n] = rs.randn(n, 3)
    savemat(os.path.join(srv, "qm7b.mat"), {"R": R, "Z": Z, "T": rs.randn(4, 14) * 10.0})
    # QM8: gdb8.tar.gz of qm8.sdf and qm8.sdf.csv (twelve spectra columns)
    from gcnn_keras_tpu.data.datasets.qm import QM8_LABEL_NAMES
    stage = os.path.join(srv, "qm8")
    os.makedirs(stage)
    mols = [("gdb8_1", [6, 1, 1, 1, 1]), ("gdb8_2", [8, 1, 1]), ("gdb8_3", [7, 1, 1, 1])]
    with open(os.path.join(stage, "qm8.sdf"), "w") as f:
        f.write("".join(_sdf_record(t, zs, rs.randn(len(zs), 3).round(4)) for t, zs in mols))
    with open(os.path.join(stage, "qm8.sdf.csv"), "w") as f:
        f.write(_csv([["Molecule"] + QM8_LABEL_NAMES] +
                     [[t] + r for (t, _), r in zip(mols, _float_rows(rs, 3, 12))]))
    with tarfile.open(os.path.join(srv, "gdb8.tar.gz"), "w:gz") as tar:
        for fn in ("qm8.sdf", "qm8.sdf.csv"):
            tar.add(os.path.join(stage, fn), arcname=fn)
    # Cora (graph2gauss cora.npz) and CoraLu (cora.tgz of cora/cora.content, .cites)
    import scipy.sparse as sp
    n, f = 12, 7
    adj = sp.csr_matrix((rs.rand(n, n) < 0.25).astype(np.float32))
    attr = sp.csr_matrix((rs.rand(n, f) < 0.3).astype(np.float32))
    with open(os.path.join(srv, "cora.npz"), "wb") as fh:
        fh.write(_npz_bytes(adj_data=adj.data, adj_indices=adj.indices, adj_indptr=adj.indptr,
                            adj_shape=np.array(adj.shape), attr_data=attr.data,
                            attr_indices=attr.indices, attr_indptr=attr.indptr,
                            attr_shape=np.array(attr.shape),
                            labels=rs.randint(0, 4, size=n).astype(np.int64)))
    stage = os.path.join(srv, "coralu", "cora")
    os.makedirs(stage)
    ids = [f"p{i * 7 + 3}" for i in range(9)]
    classes = ["Neural_Networks", "Theory", "Rule_Learning"]
    with open(os.path.join(stage, "cora.content"), "w") as fh:
        for pid in ids:
            fh.write(" ".join([pid] + [str(v) for v in rs.randint(2, size=6)]
                              + [classes[rs.randint(3)]]) + "\n")
    with open(os.path.join(stage, "cora.cites"), "w") as fh:
        for _ in range(14):
            fh.write(f"{ids[rs.randint(9)]} {rs.choice(ids + ['pX'])}\n")
    with tarfile.open(os.path.join(srv, "cora.tgz"), "w:gz") as tar:
        tar.add(stage, arcname="cora")
    # MoleculeNet CSVs (deepchem headers)
    _make_esol_csv(srv)
    smiles = ["CCO", "c1ccccc1", "CC(=O)O", "C1CC1N", "OCC(O)CO"]
    with open(os.path.join(srv, "SAMPL.csv"), "w") as fh:
        fh.write(_csv([["iupac", "smiles", "expt", "calc"]] +
                      [[f"m{i}", s] + r for i, (s, r) in enumerate(
                          zip(smiles, _float_rows(rs, 5, 2)))]))
    with open(os.path.join(srv, "Lipophilicity.csv"), "w") as fh:
        fh.write(_csv([["CMPD_CHEMBLID", "exp", "smiles"]] +
                      [[f"CHEMBL{i}", r[0], s] for i, (s, r) in enumerate(
                          zip(smiles, _float_rows(rs, 5, 1)))]))
    _gz(os.path.join(srv, "clintox.csv.gz"),
        _csv([["smiles", "FDA_APPROVED", "CT_TOX"]] +
             [[s, rs.randint(2), rs.randint(2)] for s in smiles]))
    tasks = [f"NR-{i}" for i in range(12)]
    _gz(os.path.join(srv, "tox21.csv.gz"),
        _csv([tasks + ["mol_id", "smiles"]] +
             [["" if rs.rand() < 0.3 else f"{rs.randint(2)}.0" for _ in tasks] + [f"TOX{i}", s]
              for i, s in enumerate(smiles)]))
    _gz(os.path.join(srv, "sider.csv.gz"),
        _csv([["smiles"] + [f"SE{i}" for i in range(27)]] +
             [[s] + list(rs.randint(2, size=27)) for s in smiles]))
    targets = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "u0", "u298", "h298", "g298",
               "cv"]
    with open(os.path.join(srv, "qm9.csv"), "w") as fh:
        fh.write(_csv([["mol_id", "smiles"] + targets] +
                      [[f"gdb_{i}", s] + r for i, (s, r) in enumerate(
                          zip(smiles, _float_rows(rs, 5, 12, blank=0.1)))]))
    os.makedirs(os.path.join(placed, "BACE"))
    with open(os.path.join(placed, "BACE", "bace.csv"), "w") as fh:
        fh.write(_csv([["mol", "CID", "Class", "Model", "pIC50"]] +
                      [[s, f"BACE_{i}", rs.randint(2), "Train", r[0]] for i, (s, r) in
                       enumerate(zip(smiles, _float_rows(rs, 5, 1)))]))
    # TUDataset zips
    _tu_zip(srv, "MUTAG", 6, rs)
    _tu_zip(srv, "Mutagenicity", 5, rs, edge_labels=False)
    _tu_zip(srv, "PROTEINS", 5, rs, node_attributes=True, edge_labels=False)
    # matbench json.gz, placed under each class's folder
    for name, task in MATBENCH_TASKS.items():
        folder = os.path.join(placed, name.replace("Dataset", ""))
        os.makedirs(folder, exist_ok=True)
        _gz(os.path.join(folder, f"{task}.json.gz"),
            json.dumps(_matbench_rows(rs, 3, task == "matbench_mp_is_metal")))
    # a folder of visual-graph JSON elements
    vgd = os.path.join(srv, "vgd")
    os.makedirs(vgd)
    for i in range(4):
        k = rs.randint(3, 6)
        element = {"graph": {"node_attributes": rs.rand(k, 3).tolist(),
                             "edge_indices": [[j, (j + 1) % k] for j in range(k)],
                             "edge_attributes": rs.rand(k, 2).tolist()},
                   "targets": [float(rs.randn())]}
        if i == 3:  # an element without edge attributes or targets
            element = {"node_attributes": rs.rand(k, 3).tolist(),
                       "edge_indices": [[0, 1]], "graph_labels": 1.0}
        with open(os.path.join(vgd, f"{i:03d}.json"), "w") as fh:
            json.dump(element, fh)
    return srv


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    return write_archives(str(tmp_path_factory.mktemp("srv")))


def _url_classes(package):
    """``(class, attribute, URL)`` of each class whose URL the module
    patches to ``file://``."""
    import importlib
    ds = lambda m: importlib.import_module(f"{package}.data.datasets.{m}")  # noqa: E731
    qm, md, cit, mn, tu = ds("qm"), ds("md17"), ds("citation"), ds("moleculenet"), ds("tudataset")
    return [(qm.QM7Dataset, "_url", "qm7.mat"), (qm.QM7bDataset, "_url", "qm7b.mat"),
            (qm.QM8Dataset, "_url", "gdb8.tar.gz"), (qm.QM9Dataset, "_url", "qm9.zip"),
            (md.MD17Dataset, "_url_base", ""), (md.MD17RevisedDataset, "_url_base", ""),
            (md.ISO17Dataset, "_url", "iso17.tar.gz"), (cit.CoraDataset, "_url", "cora.npz"),
            (cit.CoraLuDataset, "_url", "cora.tgz"),
            (mn.ESOLDataset, "_url", "delaney-processed.csv"),
            (mn.FreeSolvDataset, "_url", "SAMPL.csv"),
            (mn.LipopDataset, "_url", "Lipophilicity.csv"),
            (mn.ClinToxDataset, "_url", "clintox.csv.gz"),
            (mn.Tox21MolNetDataset, "_url", "tox21.csv.gz"),
            (mn.SIDERDataset, "_url", "sider.csv.gz"), (mn.QM9MolNetDataset, "_url", "qm9.csv"),
            (tu.GraphTUDataset2020, "_url_base", "")]


def serve(monkeypatch, srv, tmp_path):
    """Both packages' dataset roots under ``tmp_path`` (``jax/``, ``port/``),
    each holding the placed archives; every URL a ``file://`` one into
    ``srv``, and every fetch checked to be one. Returns the two roots."""
    roots = {}
    for package, module in (("gcnn_keras_tpu", jdownload), ("gcnn_keras_tpu_torch", download)):
        root = str(tmp_path / ("jax" if module is jdownload else "port"))
        shutil.copytree(os.path.join(srv, "placed"), root)
        monkeypatch.setattr(module, "DATASET_ROOT", root)
        roots[package] = root
        for cls, attr, target in _url_classes(package):
            monkeypatch.setattr(cls, attr, "file://" + os.path.join(srv, target)
                                + ("/" if attr == "_url_base" else ""))
    fetch = urllib.request.urlretrieve

    def local_only(url, *a, **kw):
        assert url.startswith("file://"), url
        return fetch(url, *a, **kw)
    monkeypatch.setattr(urllib.request, "urlretrieve", local_only)
    return roots


def reading_jax_deserialize(monkeypatch):
    """The JAX ``deserialize`` reading a dataset whose config's methods name
    no ``read_in_memory``, as the port's does (the JAX one builds
    ``hyper_cora.py``'s ``CoraDataset`` empty, and its driver stops at
    ``ds[0]``)."""
    plain = jserial.deserialize

    def deserialize(cfg):
        methods = list(cfg.get("methods", []))
        if not any("read_in_memory" in m for m in methods):
            methods = [{"read_in_memory": {}}] + methods
        return plain(dict(cfg, methods=methods))
    monkeypatch.setattr(jserial, "deserialize", deserialize)


def build(package, name, srv):
    """``name`` of ``package``'s table built with its case and read: the
    dataset, or the exception its read raised."""
    config, read_kw = CASES[name]
    if name == "VisualGraphDataset":
        config = dict(config, data_directory=os.path.join(srv, "vgd"))
    table = (jserial if package == "gcnn_keras_tpu" else serial)._DATASET_MODULES
    import importlib
    cls = getattr(importlib.import_module(table[name]), name)
    ds = cls(**config)
    try:
        ds.read_in_memory(**read_kw)
    except ImportError as e:
        return e
    return ds


def same_graphs(ours, ref):
    """The same graphs: keys in the same order, arrays of the same dtype and
    shape, equal bit for bit."""
    assert len(ours) == len(ref) and len(ref) > 0
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k in b:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k


def same_errors(ours, ref):
    assert isinstance(ours, ImportError) and isinstance(ref, ImportError)
    assert str(ours) == str(ref)


def test_every_name_of_the_table_has_a_case():
    synthetic = {"SyntheticQM9Dataset", "SyntheticMDDataset", "SyntheticCitationDataset",
                 "VgdMockDataset", "VgdRbMotifsDataset"}
    assert set(CASES) | synthetic == set(jserial._DATASET_MODULES) == set(serial._DATASET_MODULES)
    assert len(CASES) == 32


@pytest.mark.parametrize("name", sorted(CASES))
def test_dataset_matches_jax(name, archives, monkeypatch, tmp_path):
    serve(monkeypatch, archives, tmp_path)
    ref, ours = build("gcnn_keras_tpu", name, archives), build("gcnn_keras_tpu_torch", name,
                                                              archives)
    if name in MOLECULENET and isinstance(ref, ImportError):
        same_errors(ours, ref)
    else:
        same_graphs(ours, ref)


@pytest.mark.parametrize("name", sorted(MOLECULENET_CSV))
def test_moleculenet_csv_is_fetched_and_read_as_pandas_reads_it(name, archives, monkeypatch,
                                                                 tmp_path):
    """The fetched (and gunzipped) CSV is the same file in both roots, and
    ``csv_table`` gives each of its columns as ``pandas.read_csv`` does:
    the dtype, and the values bit for bit (NaN where a cell is empty)."""
    pd = pytest.importorskip("pandas")
    roots = serve(monkeypatch, archives, tmp_path)
    for package in roots:
        build(package, name, archives)
    folder, fn = MOLECULENET_CSV[name]
    paths = [os.path.join(root, folder, fn) for root in roots.values()]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    check_csv_against_pandas(paths[1], pd)


def check_csv_against_pandas(path, pd):
    """Each column as pandas reads it: the same dtype; integers equal;
    floats equal bit for bit to pandas' correctly rounded parse
    (``float_precision="round_trip"``), within 1e-12 of its default parse
    (which lands up to some thousand ulps off on 17-digit decimals), and
    equal bit for bit to that once cast to float32, as the classes cast
    their labels; strings equal, NaN where pandas has NaN."""
    table, df = csv_table.read_csv(path), pd.read_csv(path)
    exact = pd.read_csv(path, float_precision="round_trip")
    assert table.columns == list(df.columns) and len(table) == len(df)
    for col in df.columns:
        ours, ref = table.column(col), df[col].to_numpy()
        if ref.dtype.kind in "if":
            assert ours.dtype == ref.dtype, col
            assert np.array_equal(ours, exact[col].to_numpy(), equal_nan=True), col
            if ref.dtype.kind == "f":
                assert np.array_equal(ours.astype(np.float32), ref.astype(np.float32),
                                      equal_nan=True), col
                np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0, err_msg=col)
        else:
            assert ours.dtype == object, col
            assert [v if isinstance(v, str) else "nan" for v in ours] == \
                [v if isinstance(v, str) else "nan" for v in ref], col
            assert all(isinstance(v, str) or np.isnan(v) for v in ours), col


@pytest.mark.parametrize("fn", ["gdb9.sdf.csv", "qm8.sdf.csv"])
def test_label_tables_read_as_pandas_reads_them(fn, archives, monkeypatch, tmp_path):
    pd = pytest.importorskip("pandas")
    roots = serve(monkeypatch, archives, tmp_path)
    name = "QM9Dataset" if fn.startswith("gdb9") else "QM8Dataset"
    build("gcnn_keras_tpu_torch", name, archives)
    check_csv_against_pandas(os.path.join(roots["gcnn_keras_tpu_torch"], name[:3], fn), pd)


def test_csv_table_types_columns_as_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    path = tmp_path / "t.csv"
    path.write_text('a,b,c,d,e\n1,2.5,x,,"q,1"\n-3,NaN,y,7,z\n4,1e-3,,8,NA\n')
    check_csv_against_pandas(str(path), pd)
    with pytest.raises(KeyError):
        csv_table.read_csv(str(path)).column("nope")


def test_qm9_label_names_and_errors_as_jax(archives, monkeypatch, tmp_path):
    """The canonical ``U0`` and the release's ``u0`` read the same column;
    an unknown name raises ``KeyError`` listing the columns, in both."""
    from gcnn_keras_tpu.data.datasets.qm import QM9Dataset as J
    from gcnn_keras_tpu_torch.data.datasets.qm import QM9Dataset as T
    serve(monkeypatch, archives, tmp_path)
    same_graphs(T().read_in_memory(label_column_name="u0"),
                J().read_in_memory(label_column_name="U0"))
    same_graphs(T().read_in_memory(label_column_name="homo"),
                J().read_in_memory(label_column_name="homo"))
    for cls in (J, T):
        with pytest.raises(KeyError, match="columns"):
            cls().read_in_memory(label_column_name="nope")


@pytest.mark.parametrize("kw", [{"label_column_name": "E2-PBE0"}, {"label_column_name": None}])
def test_qm_label_selection_matches_jax(kw, archives, monkeypatch, tmp_path):
    from gcnn_keras_tpu.data.datasets.qm import QM7bDataset as J7, QM8Dataset as J8
    from gcnn_keras_tpu_torch.data.datasets.qm import QM7bDataset as T7, QM8Dataset as T8
    serve(monkeypatch, archives, tmp_path)
    same_graphs(T8().read_in_memory(**kw), J8().read_in_memory(**kw))
    kw7 = {} if kw["label_column_name"] is None else {"label_column_name": "lumo_gw"}
    same_graphs(T7().read_in_memory(**kw7), J7().read_in_memory(**kw7))


def test_iso17_truncation_and_missing_energy_as_jax(archives, monkeypatch, tmp_path):
    """Under ``max_frames_per_db`` a validation id past the rows read marks
    no row of the next db; a db row without any energy raises
    ``ValueError`` naming ``total_energy``: in both packages."""
    from gcnn_keras_tpu.data.dataset import MemoryGraphDataset as JM
    from gcnn_keras_tpu.data.datasets.md17 import ISO17Dataset as J
    from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset as TM
    from gcnn_keras_tpu_torch.data.datasets.md17 import ISO17Dataset as T
    serve(monkeypatch, archives, tmp_path)
    ours, ref = T().read_in_memory(max_frames_per_db=2), J().read_in_memory(max_frames_per_db=2)
    same_graphs(ours, ref)
    assert len(ours) == 9 and "valid" in ours[1] and all("valid" not in g for g in ours[2:])
    bad = tmp_path / "bad"
    bad.mkdir()
    _write_ase_sqlite(str(bad / "reference.db"), [dict(numbers=[1, 1], positions=np.zeros((2, 3)),
                                                      energy=0.0, forces=np.zeros((2, 3)))])
    conn = sqlite3.connect(str(bad / "reference.db"))
    conn.execute("UPDATE systems SET key_value_pairs='{}', energy=NULL")
    conn.commit()
    conn.close()
    for cls, base in ((J, JM), (T, TM)):
        ds = cls.__new__(cls)
        base.__init__(ds, data_directory=str(bad), dataset_name="ISO17")
        with pytest.raises(ValueError, match="total_energy"):
            ds.read_in_memory()


def test_md17_frames_as_jax(archives, monkeypatch, tmp_path):
    """``max_frames`` and the revised npz's float64 arrays cast as JAX casts
    them."""
    from gcnn_keras_tpu.data.datasets.md17 import MD17RevisedDataset as J
    from gcnn_keras_tpu_torch.data.datasets.md17 import MD17RevisedDataset as T
    serve(monkeypatch, archives, tmp_path)
    same_graphs(T().read_in_memory(max_frames=3), J().read_in_memory(max_frames=3))


def test_a_missing_file_raises_file_not_found(monkeypatch, tmp_path):
    """A fetch that fails is logged and the build goes on; the read raises
    ``FileNotFoundError`` (nothing is made up in its place), in both."""
    from gcnn_keras_tpu.data.datasets import citation as jc, md17 as jm, qm as jq, tudataset as jt
    from gcnn_keras_tpu_torch.data.datasets import (citation as tc, md17 as tm, qm as tq,
                                                    tudataset as tt)
    srv = tmp_path / "empty"
    srv.mkdir()
    for module in (jdownload, download):
        monkeypatch.setattr(module, "DATASET_ROOT", str(tmp_path / "root"))
    for j, t in ((jc.CoraDataset, tc.CoraDataset), (jq.QM9Dataset, tq.QM9Dataset),
                 (jq.QM7Dataset, tq.QM7Dataset), (jm.MD17RevisedDataset, tm.MD17RevisedDataset),
                 (jt.MUTAGDataset, tt.MUTAGDataset)):
        for cls in (j, t):
            attr = "_url_base" if "_url_base" in vars(cls) or cls.__name__ == "MUTAGDataset" \
                else "_url"
            monkeypatch.setattr(cls, attr, (srv / "nothing").as_uri() + "/")
            with pytest.raises(FileNotFoundError):
                cls().read_in_memory()


def test_download_dataset_fetches_unpacks_and_caches_as_jax(tmp_path):
    """``DownloadDataset``'s flow on ``file://`` archives, each step in both
    packages: fetch, untar, unzip, gunzip; a second build fetches and
    unpacks nothing; ``reload=True`` does both again."""
    src = tmp_path / "srv"
    src.mkdir()
    stage = src / "stage"
    stage.mkdir()
    (stage / "member.txt").write_text("tar-payload")
    tar_path = src / "arch.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tar:
        tar.add(stage / "member.txt", arcname="member.txt")
    zip_path = src / "arch.zip"
    with zipfile.ZipFile(zip_path, "w") as z:
        z.writestr("zipped.txt", "zip-payload")
    gz_path = src / "data.csv.gz"
    _gz(gz_path, "a,b\n1,2\n")
    for name, module in (("jax", jdownload), ("port", download)):
        root = tmp_path / name
        D = module.DownloadDataset
        D("TarDS", download_url=tar_path.as_uri(), download_file_name="arch.tar.gz",
          unpack_tar=True, unpack_directory_name="unpacked", data_main_dir=str(root))
        out = root / "TarDS" / "unpacked" / "member.txt"
        assert out.read_text() == "tar-payload"
        archive = root / "TarDS" / "arch.tar.gz"
        out.write_text("edited")
        mtime = archive.stat().st_mtime_ns
        D("TarDS", download_url=tar_path.as_uri(), download_file_name="arch.tar.gz",
          unpack_tar=True, unpack_directory_name="unpacked", data_main_dir=str(root))
        assert out.read_text() == "edited" and archive.stat().st_mtime_ns == mtime
        D("TarDS", download_url=tar_path.as_uri(), download_file_name="arch.tar.gz",
          unpack_tar=True, unpack_directory_name="unpacked", reload=True,
          data_main_dir=str(root))
        assert out.read_text() == "tar-payload"
        D("ZipDS", download_url=zip_path.as_uri(), download_file_name="arch.zip",
          unpack_zip=True, unpack_directory_name="unz", data_main_dir=str(root))
        assert (root / "ZipDS" / "unz" / "zipped.txt").read_text() == "zip-payload"
        D("GzDS", download_url=gz_path.as_uri(), download_file_name="data.csv.gz",
          extract_gz=True, extract_file_name="data.csv", data_main_dir=str(root))
        assert (root / "GzDS" / "data.csv").read_text() == "a,b\n1,2\n"
        D("MissingDS", download_url=(tmp_path / "nope.zip").as_uri(),
          download_file_name="nope.zip", unpack_zip=True, data_main_dir=str(root))
        assert (root / "MissingDS").is_dir() and not (root / "MissingDS" / "nope.zip").exists()
    assert download.DATASET_ROOT == jdownload.DATASET_ROOT


def test_untar_refuses_a_member_outside_the_target(tmp_path):
    """The ``data`` filter: a member with an absolute path or ``..`` is
    refused (Python 3.12's ``tarfile`` raises), in both packages."""
    evil = tmp_path / "evil.tar"
    with tarfile.open(evil, "w") as tar:
        info = tarfile.TarInfo("../outside.txt")
        info.size = 3
        tar.addfile(info, io.BytesIO(b"bad"))
    for name, module in (("jax", jdownload), ("port", download)):
        with pytest.raises(tarfile.TarError):
            module.DownloadDataset("Evil", download_url=evil.as_uri(),
                                   download_file_name="evil.tar", unpack_tar=True,
                                   data_main_dir=str(tmp_path / name))
        assert not (tmp_path / name / "outside.txt").exists()


def test_visual_graph_dataset_ensure_raises_without_its_package():
    from gcnn_keras_tpu_torch.data.visual_graph import VisualGraphDataset
    try:
        import visual_graph_datasets  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="VgdMockDataset"):
            VisualGraphDataset().ensure()
    with pytest.raises(FileNotFoundError):
        VisualGraphDataset().read_in_memory()


def test_the_rdkit_backend_is_gated_as_jax():
    from gcnn_keras_tpu.mol import graph_rdkit as jrd
    from gcnn_keras_tpu_torch.mol import graph_rdkit as trd
    assert trd._HAS_RDKIT == jrd._HAS_RDKIT
    assert sorted(trd.ATOM_FEATURES) == sorted(jrd.ATOM_FEATURES)
    assert sorted(trd.BOND_FEATURES) == sorted(jrd.BOND_FEATURES)
    if not jrd._HAS_RDKIT:
        for mod in (jrd, trd):
            with pytest.raises(ImportError, match="rdkit is required"):
                mod.MolecularGraphRDKit()


def test_one_hot_encoder_as_jax():
    from gcnn_keras_tpu.mol.encoder import OneHotEncoder as J
    from gcnn_keras_tpu_torch.mol.encoder import OneHotEncoder as T
    for add_unknown in (True, False):
        j, t = J(["C", "N", "O"], add_unknown=add_unknown), T(["C", "N", "O"],
                                                             add_unknown=add_unknown)
        for v in ("N", "Cl", "C", "Cl", "Br"):
            a, b = t(v), j(v)
            assert a.dtype == b.dtype and a.tolist() == b.tolist()
        assert t.found_values == j.found_values and t.get_config() == j.get_config()


def test_io_loader_is_the_data_loader():
    from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
    from gcnn_keras_tpu_torch.io import GraphBatchLoader as A
    from gcnn_keras_tpu_torch.io.loader import GraphBatchLoader as B
    assert A is B is GraphBatchLoader
