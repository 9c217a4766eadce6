"""The configuration library ``training/hyper/`` through the port: its
files load without the JAX package (in a fresh interpreter, since this one
has JAX loaded), the port's ``hyper_templates`` gives the JAX module's
dicts, every model key builds on the CPU, representative configurations
run as the JAX package's on shared weights (outputs within ``rtol=1e-5``,
``atol=1e-6`` of the output's scale), and ``data/serial.py``'s
``deserialize`` builds every dataset of the JAX table bit for bit as
JAX's: the synthetic ones, and the others from archives written by
``tests/test_torch_datasets.py`` and served through ``file://``.
"""
import glob
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.data import serial as jserial
from gcnn_keras_tpu.graph.preprocess import set_angle, set_range
from gcnn_keras_tpu.training.hyper import HyperParameter as JHyperParameter
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.data import serial
from gcnn_keras_tpu_torch.training import hyper_templates
from gcnn_keras_tpu_torch.training.hyper import HyperParameter
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_datasets import CASES as DATASET_CASES
from tests.test_torch_datasets import (MOLECULENET, archives, same_errors,  # noqa: F401
                                       same_graphs, serve)
from tests.test_torch_zoo import _close, _perturbed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYPER_DIR = os.path.join(ROOT, "training", "hyper")
HYPER_FILES = sorted(glob.glob(os.path.join(HYPER_DIR, "hyper_*.py")))
# the library entries whose output MLP merges more units than the model's
# default ``use_bias`` list has entries: the JAX MLP asserts at the model's
# first call, the port's raises ``ValueError`` when built
RAISES_WHEN_BUILT = {("hyper_mutag.py", "Unet"), ("hyper_iso17.py", "MXMNet.EnergyForceModel"),
                     ("hyper_md17.py", "MXMNet.EnergyForceModel"),
                     ("hyper_md17_revised.py", "MXMNet.EnergyForceModel"),
                     ("hyper_qm7.py", "MXMNet"), ("hyper_qm9_energies.py", "MXMNet"),
                     ("hyper_qm9_orbitals.py", "MXMNet")}


def _jax_load(path):
    """The config as the JAX package's tests load it (``exec_module``)."""
    spec = importlib.util.spec_from_file_location("hyper_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.hyper


_LOAD_ALONE = """
import glob, sys
jax_before = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'gcnn_keras_tpu'))
from gcnn_keras_tpu_torch.training.hyper import HyperParameter
files = sorted(glob.glob(sys.argv[1] + '/hyper_*.py'))
for path in files:
    HyperParameter(path)
after = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'gcnn_keras_tpu'))
print(len(files), jax_before, after,
      'gcnn_keras_tpu_torch.training.hyper_templates' in sys.modules)
"""


def test_library_loads_without_the_jax_package():
    """Every ``training/hyper/hyper_*.py`` through the port's
    ``HyperParameter`` in a fresh interpreter: neither ``jax`` nor any
    module of ``gcnn_keras_tpu`` is imported, before or after, and the
    files' ``hyper_templates`` is the port's."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _LOAD_ALONE, HYPER_DIR], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(HYPER_FILES)), "[]", "[]", "True"], out.stdout
    assert len(HYPER_FILES) == 30


def test_the_config_loader_leaves_sys_modules_as_it_was():
    """In a process that has the JAX package loaded, the load neither adds
    nor removes a module of it, and the config's own ``sys.path`` line runs
    as it is."""
    before = {m: sys.modules[m] for m in sys.modules if m.split(".")[0] == "gcnn_keras_tpu"}
    HyperParameter(os.path.join(HYPER_DIR, "hyper_esol.py"), model_name="MAT")
    after = {m: sys.modules[m] for m in sys.modules if m.split(".")[0] == "gcnn_keras_tpu"}
    assert after == before


def test_a_config_importing_an_unported_module_raises_naming_it(tmp_path):
    path = tmp_path / "hyper_x.py"
    # the Pallas kernels' module has no port of that name (its kernels are
    # ops/cuda's); parallel/, this test's module until slice 20, is ported
    path.write_text("from gcnn_keras_tpu.ops.pallas.segment_sum import segment_sum\n"
                    "hyper = {}\n")
    with pytest.raises(ValueError, match="gcnn_keras_tpu.ops.pallas.segment_sum"):
        HyperParameter(str(path))
    ok = tmp_path / "hyper_y.py"
    ok.write_text("import gcnn_keras_tpu.training.hyper_templates as t\n"
                  "from gcnn_keras_tpu.models.registry import update_model_kwargs\n"
                  "hyper = {'MAT': {'model': t.model_section('MAT', depth=1)}, "
                  "'n': update_model_kwargs({'a': 1}, {'b': 2})}\n")
    loaded = HyperParameter(str(ok), model_name="MAT")
    assert loaded["model"]["config"] == {"depth": 1}


@pytest.mark.parametrize("path", HYPER_FILES, ids=os.path.basename)
def test_templates_give_the_jax_dicts(path):
    assert HyperParameter(path)._hyper_all == _jax_load(path)


def test_templates_are_the_jax_module_copied():
    from gcnn_keras_tpu.training import hyper_templates as jtemplates
    public = [n for n in dir(jtemplates) if not n.startswith("__") and n not in
              ("annotations", "Any", "Dict", "List", "Optional", "Sequence", "copy")]
    for name in public:
        ours, ref = getattr(hyper_templates, name), getattr(jtemplates, name)
        if callable(ref):
            assert ours.__code__.co_code == ref.__code__.co_code, name
        else:
            assert ours == ref, name


@pytest.mark.parametrize("path", HYPER_FILES, ids=os.path.basename)
def test_every_model_config_builds(path):
    """Each model key of the file builds on the CPU through the port, its
    optimizer too, but the entries of ``RAISES_WHEN_BUILT``, which raise
    as JAX fails at their first call."""
    hyper_all = HyperParameter(path)._hyper_all
    for key in hyper_all:
        hp = HyperParameter(hyper_all, model_name=key)
        assert "model" in hp and "data" in hp and "training" in hp
        assert "class_name" in hp["data"]["dataset"]
        assert callable(hp.make_optimizer())
        if (os.path.basename(path), key) in RAISES_WHEN_BUILT:
            with pytest.raises(ValueError, match="use_bias|list length"):
                hp.make_model(device="cpu")
            continue
        model = hp.make_model(device="cpu")
        assert sum(p.numel() for p in model.parameters()) > 0, f"{path}:{key}"


@pytest.mark.parametrize("fname,key", sorted(RAISES_WHEN_BUILT))
def test_entries_that_raise_fail_in_jax_at_their_first_call(fname, key):
    """The JAX model of each entry of ``RAISES_WHEN_BUILT`` asserts at its
    first call (MXMNet's ``output_mlp`` of three units against
    ``model_default``'s one bias, the Graph U-Net's against two)."""
    from tests.test_torch_zoo_c import MXM_KEYS, _mols, _multiplex
    path = os.path.join(HYPER_DIR, fname)
    if key == "Unet":
        jb = jbatch_graphs(_graphs("molnet"))
    else:
        jb = jbatch_graphs(_multiplex(_mols(5)), second_edge_index_key="range_indices",
                           **MXM_KEYS)
    jm = JHyperParameter(_jax_load(path), model_name=key).make_model()
    with pytest.raises(AssertionError, match="list length"):
        jm.init(jax.random.PRNGKey(0), jb)
    with pytest.raises(ValueError, match="use_bias|list length"):
        HyperParameter(path, model_name=key).make_model(device="cpu")


# --------------------------------------------------- representative forwards

def _graphs(style):
    """``tests/test_hyper_library.py``'s ``_make_batch(style)`` graphs, draw
    for draw."""
    rs = np.random.RandomState(0)
    graphs = []
    for _ in range(2):
        n = rs.randint(6, 10)
        ei = np.array([[i, (i + 1) % n] for i in range(n)]
                      + [[(i + 1) % n, i] for i in range(n)], dtype=np.int64)
        g = {"node_number": rs.choice([1, 6, 7, 8], size=n),
             "node_coordinates": rs.randn(n, 3).astype(np.float32) * 2, "edge_indices": ei}
        if style == "molnet":
            g["node_attributes"] = rs.randn(n, 41).astype(np.float32)
            g["edge_attributes"] = rs.randn(len(ei), 11).astype(np.float32)
        g = set_range(g, max_distance=4.0, max_neighbours=8)
        g = set_angle(g)
        if style == "qm":
            g["edge_indices"] = g["range_indices"]
        graphs.append(g)
    return graphs


# test_representative_forward's five cases and MAT of hyper_esol.py, with the
# port's input widths of the molnet graphs
REPRESENTATIVE = [("GIN", "hyper_esol.py", "molnet", dict(in_features=41)),
                  ("Schnet", "hyper_qm7.py", "qm", {}),
                  ("HDNNP2nd", "hyper_qm7.py", "qm", {}),
                  ("PAiNN.EnergyForceModel", "hyper_md17.py", "qm", {}),
                  ("MEGAN", "hyper_vgd_mock.py", "molnet",
                   dict(in_features=41, edge_in_features=11)),
                  ("MAT", "hyper_esol.py", "molnet", dict(in_features=41, edge_in_features=11))]


@pytest.mark.parametrize("key,fname,style,widths", REPRESENTATIVE,
                         ids=[f"{k}-{f}" for k, f, _, _ in REPRESENTATIVE])
def test_representative_forward_matches_jax(key, fname, style, widths):
    path = os.path.join(HYPER_DIR, fname)
    graphs = _graphs(style)
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    jm = JHyperParameter(_jax_load(path), model_name=key).make_model()
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jb), 11)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    model = params_from_jax(HyperParameter(path, model_name=key).make_model(
        device="cpu", **widths), variables)
    ref, out = jax.jit(jm.apply)(variables, jb), model(tb)
    name = "output" if "output" in ref else list(ref)[0]
    r = np.asarray(ref[name])
    assert np.isfinite(r).all()
    _close(out[name], r, 1e-5, 1e-6 * max(1.0, float(np.abs(r).max())))


# --------------------------------------------------------------- deserialize

SYNTHETIC = [
    {"class_name": "SyntheticMDDataset", "config": {"num_frames": 6},
     "methods": [{"map_list": {"method": "set_range", "max_distance": 5.0,
                               "max_neighbours": 15}}]},
    {"class_name": "SyntheticQM9Dataset", "config": {"num_molecules": 5, "seed": 3},
     "methods": [{"map_list": {"method": "set_range", "max_distance": 4.0}},
                 {"map_list": {"method": "set_angle"}}]},
    {"class_name": "SyntheticCitationDataset", "config": {"num_nodes": 40},
     "methods": [{"map_list": {"method": "normalize_edge_weights_symmetric"}}]},
    {"class_name": "SyntheticQM9Dataset", "module_name": "gcnn_keras_tpu.data.datasets.synthetic",
     "config": {"num_molecules": 3}},
]


@pytest.mark.parametrize("config", SYNTHETIC, ids=lambda c: c["class_name"] + (
    "-module" if "module_name" in c else ""))
def test_deserialize_builds_the_synthetic_datasets_as_jax(config):
    ours, ref = serial.deserialize(config), jserial.deserialize(config)
    assert type(ours).__name__ == type(ref).__name__ and len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_deserialize_of_the_library_synthetic_md_config():
    """``hyper_synthetic_md.py``'s dataset: 256 frames with their range
    edges, as the JAX package builds them."""
    path = os.path.join(HYPER_DIR, "hyper_synthetic_md.py")
    cfg = HyperParameter(path, model_name="Schnet")["data"]["dataset"]
    ours, ref = serial.deserialize(cfg), jserial.deserialize(cfg)
    assert len(ours) == 256
    for a, b in zip(ours[:8], ref[:8]):
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_deserialize_table_is_the_jax_table():
    assert set(serial._DATASET_MODULES) == set(jserial._DATASET_MODULES)
    for name, module in serial._DATASET_MODULES.items():
        assert module == "gcnn_keras_tpu_torch." + \
            jserial._DATASET_MODULES[name][len("gcnn_keras_tpu."):]
    assert not hasattr(serial, "_HOST_SIDE")


def _file_config(name, srv):
    """``name``'s dataset section with its case's config and
    ``read_in_memory`` keywords as a method."""
    config, read_kw = DATASET_CASES[name]
    if name == "VisualGraphDataset":
        config = dict(config, data_directory=os.path.join(srv, "vgd"))
    return {"class_name": name, "config": config, "methods": [{"read_in_memory": read_kw}]}


@pytest.mark.parametrize("name", sorted(DATASET_CASES))
def test_deserialize_builds_the_file_datasets_as_jax(name, archives, monkeypatch, tmp_path):
    """Every dataset of the JAX table that reads files, through both
    packages' ``deserialize`` on the same archives (served by ``file://``):
    the same graphs bit for bit; the MoleculeNet names fetch and read their
    CSV and then raise the same ``ImportError`` where RDKit is absent."""
    serve(monkeypatch, archives, tmp_path)
    cfg = _file_config(name, archives)
    got = {}
    for key, module in (("ref", jserial), ("ours", serial)):
        try:
            got[key] = module.deserialize(cfg)
        except ImportError as e:
            got[key] = e
    if name in MOLECULENET and isinstance(got["ref"], ImportError):
        same_errors(got["ours"], got["ref"])
    else:
        same_graphs(got["ours"], got["ref"])


@pytest.mark.parametrize("fname,model", [("hyper_cora.py", "GCN"),
                                         ("hyper_md17_revised.py", "Schnet.EnergyForceModel")])
def test_deserialize_reads_a_config_dataset_that_names_no_read(fname, model, archives,
                                                               monkeypatch, tmp_path):
    """A library config whose methods name no ``read_in_memory``: the JAX
    package builds its dataset empty, the port reads it first, as kgcnn's
    classes do in their constructors; the graphs are the JAX ones read
    before the same methods."""
    serve(monkeypatch, archives, tmp_path)
    cfg = HyperParameter(os.path.join(HYPER_DIR, fname), model_name=model)["data"]["dataset"]
    assert not any("read_in_memory" in m for m in cfg.get("methods", []))
    assert len(jserial.deserialize(cfg)) == 0
    ref = jserial.deserialize(dict(cfg, methods=[{"read_in_memory": {}}]
                                   + list(cfg.get("methods", []))))
    same_graphs(serial.deserialize(cfg), ref)


def test_deserialize_raises_on_an_unknown_name_or_module():
    with pytest.raises(ValueError, match="unknown dataset Nothing"):
        serial.deserialize({"class_name": "Nothing"})
    with pytest.raises(ValueError, match="no module gcnn_keras_tpu.data.datasets.nothing"):
        serial.deserialize({"class_name": "QM9Dataset",
                            "module_name": "gcnn_keras_tpu.data.datasets.nothing"})
