"""The port stands alone: no module of ``gcnn_keras_tpu_torch`` nor its
scripts (``chip_smoke.py``, ``profile_serving_torch.py``,
``probe_kernel_variants.py``) imports JAX, flax, optax or the JAX package, and its entry
points refuse to fall back to the CPU unasked.

The scan reads the sources' ASTs rather than ``sys.modules``: the test
process has JAX loaded already.
"""
import ast
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import importlib

from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset
from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.model.mlmm import MLMMEnergyForceModel
from gcnn_keras_tpu_torch.models import (attentivefp, cgcnn, cmpnn, dimenet_pp, dmpnn, egnn,
                                         gat, gcn, gin, gnnfilm, hamnet, hdnnp2nd, hdnnp4th,
                                         inorp, megan, megnet, mxmnet, nmpn, painn, rgcn, sage)
from gcnn_keras_tpu_torch.models.hdnnp2nd import make_model_behler
from gcnn_keras_tpu_torch.models.schnet import make_crystal_model, make_model
from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
from gcnn_keras_tpu_torch.training import force_script
from gcnn_keras_tpu_torch.training.force_script import run_force_training
from gcnn_keras_tpu_torch.training.hyper import HyperParameter
from gcnn_keras_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gcnn_keras_tpu")
SOURCES = sorted((ROOT / "gcnn_keras_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_serving_torch.py", ROOT / "probe_kernel_variants.py"]


SCRIPTS = ("force_schnet", "force_painn", "force_hdnnp2nd", "force_hdnnp4th",
           "energy_hdnnp4th", "charge_hdnnp4th", "energy_hdnnp2nd", "force_inverse_distances")
# the entry points that run a trained ensemble or search, each a ``main(argv)``
# that takes ``--device``; ``retrieve_trial`` reads JSON only
WORKFLOW = ("evaluate_models", "calc_prediction_std", "load_model", "transfer_learning",
            "force_schnet_hyp_param_search", "force_painn_hyp_param_search",
            "force_hdnnp2nd_hyp_param_search", "force_hdnnp4th_hyp_param_search",
            "charge_hyp_param_search")


# the graph-learning drivers and the force driver, each a ``main(argv)``
# that takes ``--device``
DRIVERS = ("train_tudataset", "train_moleculenet", "train_force")
# the last root drivers, each a ``main(argv)`` that takes ``--device``, with
# the arguments of a tiny run; and the golden-IO harnesses (``prepare_data``
# runs on the host only and takes no device)
ROOT_DRIVERS = {"train_citation": ["--nodes", "40", "--epochs", "2", "--folds", "2"],
                "train_qm": ["--molecules", "12", "--epochs", "1", "--folds", "2",
                             "--batch-size", "4"],
                "train_crystal": ["--structures", "10", "--epochs", "1", "--batch-size", "4"],
                "train_visual_graph_dataset": ["--graphs", "10", "--epochs", "2"]}
HARNESSES = ("test_model_force_schnet_painn", "test_model_force_hdnnp")


def _script(name):
    return importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{name}")


def _tiny(name, **kw):
    """A run of two folds of one step at narrow widths."""
    cfg = dict(_script(name).CONFIG, synthetic_frames=6, batch_size=3, ensemble_size=2,
               epochs=1, make_plots=False, **kw)
    if "mlp_units" in cfg:
        cfg["mlp_units"] = [8, 8, 1]
    cfg.update({"schnet": {"depth": 1, "units": 8, "gauss_bins": 8, "gauss_distance": 5.0},
                "painn": {"depth": 1, "units": 8, "num_radial": 8, "cutoff": 5.0}})
    return cfg


def _run_script(name, **kw):
    """What ``python -m gcnn_keras_tpu_torch.scripts.<name>`` runs."""
    mod = _script(name)
    if name == "force_hdnnp4th":
        return mod.train(_tiny(name, **kw))
    return run_force_training(mod.build_model, _tiny(name, **kw))


def _run_workflow(name, monkeypatch, device=None):
    """``main`` of a workflow entry point, with ``--device`` if given: the
    ensemble scripts on a tiny two-fold SchNet ensemble trained in the
    working directory first, the searches on 4 frames (one trial of one
    epoch)."""
    mod = _script(name)
    if hasattr(mod, "SPACE"):
        monkeypatch.setattr(mod, "CONFIG", dict(mod.CONFIG, synthetic_frames=4, batch_size=3))
        argv = ["--trials", "1", "--min-epochs", "1", "--max-epochs", "1"]
    else:
        with open("conf.json", "w") as f:
            # 8 frames: one batch of transfer_learning's 8
            json.dump({"schnet": _tiny("force_schnet")["schnet"], "synthetic_frames": 8,
                       "make_plots": False}, f)
        if device:
            run_force_training(_script("force_schnet").build_model,
                               _tiny("force_schnet", device=device))
        flag = "--prefix" if name in ("evaluate_models", "calc_prediction_std") \
            else "--checkpoint"
        target = "model_schnet_force" if flag == "--prefix" else "model_schnet_force_0"
        argv = [flag, target, "--script", "force_schnet", "--conf", "conf.json"]
        if name == "transfer_learning":
            argv += ["--epochs", "1"]
    return mod.main(argv + (["--device", device] if device else []))


def _run_driver(name, device=None):
    """A driver's ``main``: one epoch of two folds (``train_force``: of 32
    frames)."""
    return _script(name).main(["--epochs", "1", "--folds", "2", "--no-plots"]
                              + (["--frames", "32"] if name == "train_force" else [])
                              + (["--device", device] if device else []))


def _run_root_driver(name, device=None):
    return _script(name).main(ROOT_DRIVERS[name] + ["--no-plots"]
                              + (["--device", device] if device else []))


def _run_harness(name, device=None):
    """A harness recording one molecule through a fresh checkpoint of its
    script's model at narrow widths (``--conf``)."""
    script = "force_schnet" if name.endswith("schnet_painn") else "force_hdnnp4th"
    with open("conf.json", "w") as f:
        json.dump({"schnet": _tiny("force_schnet")["schnet"], "mlp_units": [8, 1]}, f)
    cfg = force_script.load_config(_script(script), conf="conf.json")
    save_checkpoint("ckpt", _script(script).build_model(cfg, device="cpu").energy_model)
    with open("input_00.txt", "w") as f:
        f.write("3\n1 0 0 0 0.01\n6 0 0 1.1 -0.02\n1 0 1 1.3 0.0\n")
    return _script(name).main(["--checkpoint", "ckpt", "--script", script, "--conf", "conf.json",
                               "--record"] + (["--device", device] if device else []))


def _imported_modules(source):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            for arg in node.args:
                if isinstance(arg, ast.Constant):
                    yield arg.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imported_modules(path.read_text()):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_scan_sees_the_package():
    assert len(SOURCES) > 10 and (ROOT / "chip_smoke.py").exists()
    package = ROOT / "gcnn_keras_tpu_torch"
    for rel in ("models/gin.py", "models/sage.py", "models/gat.py", "models/gatv2.py",
                "models/rgcn.py", "models/gnnfilm.py", "models/inorp.py",
                "models/dmpnn.py", "models/cmpnn.py", "models/nmpn.py",
                "models/attentivefp.py", "models/hamnet.py", "models/megan.py",
                "models/egnn.py", "models/cgcnn.py", "models/megnet.py",
                "models/dimenet_pp.py", "models/mxmnet.py", "ops/polynom.py",
                "ops/initializers.py", "graph/preprocess.py", "training/schedules.py",
                "layers/pool/__init__.py", "layers/pool/set2set.py",
                "layers/conv/basic.py", "training/graph_driver.py",
                "training/fast_force_step.py", "graph/postprocess.py",
                "scripts/plot_learning_curve.py", "scripts/kgcnn_plot.py",
                "crystal/graph_builder.py", "xai/testing.py", "data/datasets/vgd.py",
                "mol/io.py", "scripts/prepare_data.py", *(f"{m.replace('.', '/')}.py"
                                                          for m in SLICE_19),
                *(f"scripts/{name}.py" for name in (*DRIVERS, *ROOT_DRIVERS, *HARNESSES))):
        assert package / rel in SOURCES, rel
    src = ("import jax\nfrom flax import linen\n"
           "def f():\n    import gcnn_keras_tpu.batch\n"
           "importlib.import_module('optax')\n")
    assert set(_imported_modules(src)) == {
        "jax", "flax", "gcnn_keras_tpu.batch", "optax"}


_FAST_STEP_ALONE = """
import sys
import numpy as np
import torch
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.models.schnet import make_model
from gcnn_keras_tpu_torch.training.fast_force_step import make_force_train_step
f32 = lambda v: np.asarray(v, dtype=np.float32)
graph = {"node_number": [1, 8, 1], "node_coordinates": f32([[0, 0, 0], [0, 0, 1], [0, 1, 0]]),
         "edge_indices": [[0, 1], [1, 0], [1, 2], [2, 1]], "energy": f32([0.5]),
         "force": f32([[0, 0, 0.1], [0, 0, -0.1], [0, 0, 0]])}
batch = batch_graphs([graph], global_keys=("energy",), device="cpu")
step = make_force_train_step(make_model(depth=1, device="cpu"), torch.optim.Adam)
state, loss, metrics = step(step.init_state(), batch)
print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax',
                                                             'gcnn_keras_tpu')),
      bool(torch.isfinite(loss)), sorted(metrics))
"""


# slice 19's modules (``native`` is a package: its ``__init__.py``)
SLICE_19 = ("native.__init__", "moldyn.ase_calc", "utils.profiling", "utils.tools",
            "mol.convert", "mol.graph_babel", "xai.base", "xai.gnn_explainer",
            "models.gnnexplain")


def test_fresh_interpreter_imports_slice_19_without_jax():
    """Each of slice 19's modules imported in a fresh interpreter, and a
    300-atom ``set_range`` run through the native list: no module of JAX,
    flax, optax or the JAX package is loaded."""
    code = "\n".join([
        "import sys, importlib, numpy as np",
        *(f"importlib.import_module('gcnn_keras_tpu_torch.{m.removesuffix('.__init__')}')"
          for m in SLICE_19),
        "from gcnn_keras_tpu_torch.graph.preprocess import set_range",
        "g = set_range({'node_coordinates': np.random.RandomState(0).rand(300, 3) * 5},"
        " max_distance=2.0, max_neighbours=10)",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'gcnn_keras_tpu')), len(g['range_indices']) > 0)"])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "[] True", out.stdout


def test_fresh_interpreter_runs_the_fast_step_without_jax():
    """``training/fast_force_step.py`` imported and one step run on a CPU
    batch in a fresh interpreter: no module of JAX, flax, optax or the JAX
    package is loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _FAST_STEP_ALONE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "[] True ['energy_loss', 'force_loss']", out.stdout


@pytest.mark.parametrize("entry", ["batch_graphs", "make_model", "make_crystal_model",
                                   "make_model_behler", "EnergyForceModel",
                                   "MolDynamicsModelPredictor", "hdnnp4th.make_model_behler",
                                   "hdnnp4th.make_model_rep", "hdnnp4th.make_model_learn",
                                   "hdnnp4th.make_model_behler_charge_separat", "ScannedMD",
                                   "hdnnp2nd.make_model", "hdnnp2nd.make_model_weighted",
                                   "hdnnp2nd.make_model_atom_wise",
                                   "hdnnp2nd.make_model_inverse_distances",
                                   "painn.make_model", "painn.make_crystal_model",
                                   "gcn.make_model", "gcn.make_model_weighted",
                                   "gin.make_model", "gin.make_model_edge", "sage.make_model",
                                   "gat.make_model", "gat.make_model_v2", "rgcn.make_model",
                                   "gnnfilm.make_model", "inorp.make_model",
                                   "dmpnn.make_model", "cmpnn.make_model", "nmpn.make_model",
                                   "nmpn.make_crystal_model", "attentivefp.make_model",
                                   "hamnet.make_model", "megan.make_model",
                                   "egnn.make_model", "cgcnn.make_model",
                                   "cgcnn.make_crystal_model", "megnet.make_model",
                                   "megnet.make_crystal_model", "dimenet_pp.make_model",
                                   "dimenet_pp.make_crystal_model", "mxmnet.make_model",
                                   "MLMMEnergyForceModel", "GraphBatchLoader",
                                   "MemoryGraphDataset.to_batch", "run_force_training",
                                   "HyperParameter.make_model",
                                   *(f"scripts.{name}" for name in SCRIPTS),
                                   *(f"scripts.{name}" for name in WORKFLOW),
                                   *(f"scripts.{name}" for name in DRIVERS),
                                   *(f"scripts.{name}" for name in ROOT_DRIVERS),
                                   *(f"scripts.{name}" for name in HARNESSES)])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)  # the training entry points write their artifacts here
    graph = {"node_number": [1, 8], "node_coordinates": [[0, 0, 0], [0, 0, 1.0]],
             "edge_indices": [[0, 1], [1, 0]]}
    calls = {
        "batch_graphs": lambda **kw: batch_graphs([graph], **kw),
        "make_model": lambda **kw: make_model(depth=1, **kw),
        "make_crystal_model": lambda **kw: make_crystal_model(depth=1, **kw),
        "make_model_behler": lambda **kw: make_model_behler(**kw),
        "EnergyForceModel": lambda **kw: EnergyForceModel(
            make_model(device="cpu", depth=1), **kw),
        "MolDynamicsModelPredictor": lambda **kw: MolDynamicsModelPredictor(
            EnergyForceModel(make_model(device="cpu", depth=1), device="cpu"), **kw),
        "hdnnp4th.make_model_behler": lambda **kw: hdnnp4th.make_model_behler(**kw),
        "hdnnp4th.make_model_rep": lambda **kw: hdnnp4th.make_model_rep(**kw),
        "hdnnp4th.make_model_learn": lambda **kw: hdnnp4th.make_model_learn(**kw),
        "hdnnp4th.make_model_behler_charge_separat":
            lambda **kw: hdnnp4th.make_model_behler_charge_separat(**kw),
        "ScannedMD": lambda **kw: ScannedMD(make_model(device="cpu", depth=1), dt=1e-3, **kw),
        "hdnnp2nd.make_model": lambda **kw: hdnnp2nd.make_model(**kw),
        "hdnnp2nd.make_model_weighted": lambda **kw: hdnnp2nd.make_model_weighted(**kw),
        "hdnnp2nd.make_model_atom_wise": lambda **kw: hdnnp2nd.make_model_atom_wise(**kw),
        "hdnnp2nd.make_model_inverse_distances":
            lambda **kw: hdnnp2nd.make_model_inverse_distances(**kw),
        "painn.make_model": lambda **kw: painn.make_model(depth=1, **kw),
        "painn.make_crystal_model": lambda **kw: painn.make_crystal_model(depth=1, **kw),
        "gcn.make_model": lambda **kw: gcn.make_model(in_features=8, **kw),
        "gcn.make_model_weighted": lambda **kw: gcn.make_model_weighted(**kw),
        "gin.make_model": lambda **kw: gin.make_model(depth=1, **kw),
        "gin.make_model_edge": lambda **kw: gin.make_model_edge(edge_in_features=4, **kw),
        "sage.make_model": lambda **kw: sage.make_model(depth=1, **kw),
        "gat.make_model": lambda **kw: gat.make_model(**kw),
        "gat.make_model_v2": lambda **kw: gat.make_model_v2(**kw),
        "rgcn.make_model": lambda **kw: rgcn.make_model(depth=1, **kw),
        "gnnfilm.make_model": lambda **kw: gnnfilm.make_model(depth=1, **kw),
        "inorp.make_model": lambda **kw: inorp.make_model(depth=1, **kw),
        "dmpnn.make_model": lambda **kw: dmpnn.make_model(depth=1, **kw),
        "cmpnn.make_model": lambda **kw: cmpnn.make_model(depth=2, **kw),
        "nmpn.make_model": lambda **kw: nmpn.make_model(depth=1, **kw),
        "nmpn.make_crystal_model": lambda **kw: nmpn.make_crystal_model(depth=1, **kw),
        "attentivefp.make_model": lambda **kw: attentivefp.make_model(**kw),
        "hamnet.make_model": lambda **kw: hamnet.make_model(**kw),
        "megan.make_model": lambda **kw: megan.make_model(**kw),
        "egnn.make_model": lambda **kw: egnn.make_model(depth=1, **kw),
        "cgcnn.make_model": lambda **kw: cgcnn.make_model(depth=1, **kw),
        "cgcnn.make_crystal_model": lambda **kw: cgcnn.make_crystal_model(depth=1, **kw),
        "megnet.make_model": lambda **kw: megnet.make_model(nblocks=1, **kw),
        "megnet.make_crystal_model": lambda **kw: megnet.make_crystal_model(nblocks=1, **kw),
        "dimenet_pp.make_model": lambda **kw: dimenet_pp.make_model(num_blocks=1, **kw),
        "dimenet_pp.make_crystal_model":
            lambda **kw: dimenet_pp.make_crystal_model(num_blocks=1, **kw),
        "mxmnet.make_model": lambda **kw: mxmnet.make_model(depth=1, **kw),
        "MLMMEnergyForceModel": lambda **kw: MLMMEnergyForceModel(EnergyForceModel(
            hdnnp4th.make_model_behler(device="cpu"), use_esp_coupling=True, **kw)),
        "GraphBatchLoader": lambda **kw: GraphBatchLoader([graph], 1, **kw),
        "MemoryGraphDataset.to_batch": lambda **kw: MemoryGraphDataset(
            graphs=[graph]).to_batch(**kw),
        "run_force_training": lambda **kw: run_force_training(
            _script("force_schnet").build_model, _tiny("force_schnet", **kw)),
        "HyperParameter.make_model": lambda **kw: HyperParameter(
            {"model": {"module_name": "Schnet", "config": {"depth": 1}}}).make_model(**kw),
        **{f"scripts.{name}": functools.partial(_run_script, name) for name in SCRIPTS},
        **{f"scripts.{name}": functools.partial(_run_workflow, name, monkeypatch)
           for name in WORKFLOW},
        **{f"scripts.{name}": functools.partial(_run_driver, name) for name in DRIVERS},
        **{f"scripts.{name}": functools.partial(_run_root_driver, name)
           for name in ROOT_DRIVERS},
        **{f"scripts.{name}": functools.partial(_run_harness, name) for name in HARNESSES},
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    calls[entry](device="cpu")  # asking for the CPU works
