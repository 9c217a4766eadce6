"""The rest of the port's host side against the JAX package on the CPU:
the ASE bridge (``moldyn/ase_calc.py``, driven by a stand-in ``Atoms``;
ASE is not installed), profiling (``utils/profiling.py``), ``utils/tools.py``
and molecule conversion (``mol/convert.py``, ``mol/graph_babel.py``).

Graph dicts and files are compared bit for bit; the calculator's energy
and forces through the two packages' SchNet predictors on shared weights
within ``rtol=1e-5`` and ``1e-5`` of the largest entry (float32 sums in
other orders, as ``tests/test_torch_schnet.py``).
"""
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models.schnet import make_model as jmake_model
from gcnn_keras_tpu.moldyn import ase_calc as jase_calc
from gcnn_keras_tpu.moldyn.base import MolDynamicsModelPredictor as JPredictor
from gcnn_keras_tpu.mol import convert as jconvert
from gcnn_keras_tpu.utils import profiling as jprofiling
from gcnn_keras_tpu.utils import tools as jtools
from chip_smoke import AtomsStandIn
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.graph import preprocess as pre
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models.schnet import make_model
from gcnn_keras_tpu_torch.moldyn import ase_calc
from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
from gcnn_keras_tpu_torch.mol import convert, graph_babel
from gcnn_keras_tpu_torch.utils import profiling, tools
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCHNET_KW = dict(depth=2, interaction_args={"units": 32},
                 gauss_args={"bins": 8, "distance_max": 4.0},
                 last_mlp={"units": [32, 16]}, output_mlp={"units": [16, 1]})


def stand_ins(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for n in (3, 7, 12):
        out.append(AtomsStandIn(rs.choice([1, 6, 7, 8], size=n), rs.randn(n, 3) * 1.3))
    cell = np.diag([6.0, 7.0, 8.0]) + rs.rand(3, 3) * 0.3
    out.append(AtomsStandIn([14, 8, 8], rs.rand(3, 3) @ cell, cell=cell, pbc=True))
    return out


@pytest.mark.parametrize("properties", [None, {"node_number": "get_atomic_numbers",
                                                "node_coordinates": "get_positions",
                                                "positions_again": "get_positions"}],
                         ids=["default", "custom"])
def test_atoms_converter_matches_jax_bit_for_bit(properties):
    """With and without ``pbc``: the lattice only for a periodic ``Atoms``."""
    for atoms in stand_ins():
        got = ase_calc.AtomsToGraphConverter(properties)(atoms)
        ref = jase_calc.AtomsToGraphConverter(properties)(atoms)
        assert sorted(got) == sorted(ref)
        assert ("graph_lattice" in got) == bool(atoms.pbc.any())
        for key in ref:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_calculator_is_none_without_ase_in_both_packages():
    have_ase = importlib.util.find_spec("ase") is not None
    for mod in (ase_calc, jase_calc):
        assert (mod.TPUGraphCalculator is None) == (not have_ase)
        assert mod.KgcnnSingleCalculator is mod.TPUGraphCalculator


def test_calculator_results_match_the_jax_predictor():
    """The calculator's results for each molecule through the port's and
    the JAX package's SchNet predictors on one set of weights: ``energy``
    a float, ``forces`` (n, 3), no ``charges`` (SchNet gives none)."""
    atoms_list = stand_ins()[:3]
    jprep = functools.partial(jpre.set_range, max_distance=4.0, max_neighbours=25)
    tprep = functools.partial(pre.set_range, max_distance=4.0, max_neighbours=25)
    frames = [jprep(jase_calc.AtomsToGraphConverter()(a)) for a in atoms_list]
    for f in frames:
        f["edge_indices"] = f.pop("range_indices")
    jm = JEnergyForceModel(jmake_model(**SCHNET_KW))
    params = jax.jit(lambda k, b: jm.init(k, b))(jax.random.PRNGKey(1), jbatch_graphs(frames))
    tmodel = params_from_jax(make_model(device="cpu", **SCHNET_KW),
                             jax.tree_util.tree_map(np.asarray, params))
    jpred = JPredictor(model=jm, variables=params, graph_preprocessors=[jprep])
    tpred = MolDynamicsModelPredictor(EnergyForceModel(tmodel, device="cpu"),
                                      graph_preprocessors=[tprep], device="cpu")
    converter = ase_calc.AtomsToGraphConverter()
    for atoms in atoms_list:
        got = ase_calc.calculator_results(tpred, converter, atoms)
        ref = jpred([jase_calc.AtomsToGraphConverter()(atoms)])[0]
        assert sorted(got) == ["energy", "forces"]
        assert isinstance(got["energy"], float)
        e_ref = float(np.asarray(ref["energy"]).reshape(-1)[0])
        np.testing.assert_allclose(got["energy"], e_ref, rtol=1e-5, atol=1e-5 * abs(e_ref))
        f_ref = np.asarray(ref["force"])
        assert got["forces"].shape == f_ref.shape == (len(atoms.numbers), 3)
        np.testing.assert_allclose(got["forces"], f_ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(f_ref).max())


def test_calculator_results_read_charges():
    """A predictor that returns ``charge`` fills ``charges``."""
    def predictor(graphs):
        n = len(graphs[0]["node_number"])
        return [{"energy": np.array([[1.5]], np.float32), "force": np.zeros((n, 3), np.float32),
                 "charge": np.arange(n, dtype=np.float32)[:, None]}]
    atoms = stand_ins()[1]
    got = ase_calc.calculator_results(predictor, ase_calc.AtomsToGraphConverter(), atoms)
    assert got["energy"] == 1.5
    np.testing.assert_array_equal(got["charges"][:, 0], np.arange(7))


def test_throughput_meter_counts_the_real_graph_like_jax():
    rs = np.random.RandomState(2)
    graphs = []
    for n in (4, 9, 6):
        g = {"node_number": rs.randint(1, 9, size=n),
             "node_coordinates": rs.randn(n, 3).astype(np.float32)}
        g = jpre.set_range(g, max_distance=3.0, max_neighbours=6)
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(g)
    jb = jbatch_graphs(graphs)
    tb = batch_graphs(graphs, device="cpu")
    jm, tm = jprofiling.ThroughputMeter(), profiling.ThroughputMeter()
    for _ in range(3):
        jm.step(jb)
        tm.step(tb)
    assert tm.counts() == {"steps": jm._steps, "edges": jm._edges, "nodes": jm._nodes,
                           "graphs": jm._graphs}
    assert tm.counts()["graphs"] == 9 and tm.counts()["nodes"] == 3 * 19
    rep = tm.report()
    assert sorted(rep) == sorted(jm.report())
    assert rep["edges_per_s"] > 0 and rep["elapsed_s"] > 0


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    x = torch.randn(64, 64)
    with profiling.trace(str(logdir)) as d:
        assert d == str(logdir)
        (x @ x).sum()
    events = json.loads((logdir / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_device_memory_stats(monkeypatch):
    """``{}`` on the CPU, as JAX's on a device without stats; the card by
    default, so that without one it raises rather than answer for the
    CPU."""
    assert profiling.device_memory_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.device_memory_stats()


def test_git_hash_matches_jax_and_is_unknown_outside_a_repository(tmp_path):
    assert tools.get_git_hash(str(ROOT)) == jtools.get_git_hash(str(ROOT))
    assert tools.get_git_hash(str(tmp_path)) == jtools.get_git_hash(str(tmp_path)) == "unknown"


ECHO = {"class_name": "echo", "config": {"args": ["MOL"]}}
SMILES = ["C", "CCO", "c1ccccc1", "O=C=O", "N#N"]


@pytest.mark.parametrize("workers,pool", [(1, "process"), (3, "thread"), (3, "process")],
                         ids=["serial", "threads", "process-pool-external"])
def test_mol_converter_external_program_matches_jax(workers, pool, tmp_path):
    """An external program (``echo``) per SMILES, serially and on threads
    (an external program always takes threads); the SDF file as JAX's."""
    kw = dict(num_workers=workers, pool=pool, external_program=ECHO)
    got = convert.MolConverter(**kw).smile_to_mol(SMILES)
    assert got == jconvert.MolConverter(**kw).smile_to_mol(SMILES)
    assert got == [f"MOL {s}\n" for s in SMILES]
    a = convert.MolConverter(**kw).smile_to_sdf(SMILES, str(tmp_path / "port.sdf"))
    b = jconvert.MolConverter(**kw).smile_to_sdf(SMILES, str(tmp_path / "jax.sdf"))
    assert Path(a).read_bytes() == Path(b).read_bytes()
    assert Path(a).read_text().count("$$$$") == len(SMILES)


def test_mol_converter_external_failure_gives_none(tmp_path):
    missing = {"class_name": str(tmp_path / "no_such_program")}
    assert convert.MolConverter(num_workers=1, external_program=missing).smile_to_mol(
        ["C", "CC"]) == [None, None]
    out = convert.MolConverter(num_workers=1, external_program=missing).smile_to_sdf(
        ["C"], str(tmp_path / "empty.sdf"))
    assert Path(out).read_text() == ""


def test_mol_converter_process_pool():
    """The RDKit process pool against serial conversion, as the JAX test
    (``tests/test_dataset_parsers.py``); skipped without RDKit, as it."""
    pytest.importorskip("rdkit")
    smiles = ["C", "CC", "CCO", "c1ccccc1"]
    serial = convert.MolConverter(num_workers=1, make_conformers=False,
                                  optimize_conformer=False).smile_to_mol(smiles)
    parallel = convert.MolConverter(num_workers=2, pool="process", make_conformers=False,
                                    optimize_conformer=False).smile_to_mol(smiles)
    assert parallel == serial and all(b is not None for b in parallel)


def test_openbabel_backend_gated():
    """Without OpenBabel, building the backend raises a clear
    ``ImportError`` and ``babel_available()`` reports the gate, as in the
    JAX package."""
    from gcnn_keras_tpu.mol import graph_babel as jgraph_babel
    assert graph_babel.babel_available() == jgraph_babel.babel_available()
    if graph_babel.babel_available():
        mg = graph_babel.MolecularGraphOpenBabel().from_smiles("CCO")
        assert len(mg.node_number) >= 3
    else:
        with pytest.raises(ImportError, match="openbabel"):
            graph_babel.MolecularGraphOpenBabel()
        with pytest.raises(ImportError):
            convert._convert_one("CCO", "openbabel", True, True, False, False)
