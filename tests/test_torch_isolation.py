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
from pathlib import Path

import pytest
import torch

import importlib

from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset
from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.model.mlmm import MLMMEnergyForceModel
from gcnn_keras_tpu_torch.models import gcn, hdnnp4th, painn
from gcnn_keras_tpu_torch.models.hdnnp2nd import make_model_behler
from gcnn_keras_tpu_torch.models.schnet import make_crystal_model, make_model
from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
from gcnn_keras_tpu_torch.training.force_script import run_force_training
from gcnn_keras_tpu_torch.training.hyper import HyperParameter

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gcnn_keras_tpu")
SOURCES = sorted((ROOT / "gcnn_keras_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_serving_torch.py", ROOT / "probe_kernel_variants.py"]


SCRIPTS = ("force_schnet", "force_painn", "force_hdnnp2nd", "force_hdnnp4th",
           "energy_hdnnp4th", "charge_hdnnp4th", "energy_hdnnp2nd")
# the entry points that run a trained ensemble or search, each a ``main(argv)``
# that takes ``--device``; ``retrieve_trial`` reads JSON only
WORKFLOW = ("evaluate_models", "calc_prediction_std", "load_model", "transfer_learning",
            "force_schnet_hyp_param_search", "force_painn_hyp_param_search",
            "force_hdnnp2nd_hyp_param_search", "force_hdnnp4th_hyp_param_search",
            "charge_hyp_param_search")


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
    src = ("import jax\nfrom flax import linen\n"
           "def f():\n    import gcnn_keras_tpu.batch\n"
           "importlib.import_module('optax')\n")
    assert set(_imported_modules(src)) == {
        "jax", "flax", "gcnn_keras_tpu.batch", "optax"}


@pytest.mark.parametrize("entry", ["batch_graphs", "make_model", "make_crystal_model",
                                   "make_model_behler", "EnergyForceModel",
                                   "MolDynamicsModelPredictor", "hdnnp4th.make_model_behler",
                                   "hdnnp4th.make_model_rep", "hdnnp4th.make_model_learn",
                                   "hdnnp4th.make_model_behler_charge_separat", "ScannedMD",
                                   "painn.make_model", "painn.make_crystal_model",
                                   "gcn.make_model", "gcn.make_model_weighted",
                                   "MLMMEnergyForceModel", "GraphBatchLoader",
                                   "MemoryGraphDataset.to_batch", "run_force_training",
                                   "HyperParameter.make_model",
                                   *(f"scripts.{name}" for name in SCRIPTS),
                                   *(f"scripts.{name}" for name in WORKFLOW)])
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
        "painn.make_model": lambda **kw: painn.make_model(depth=1, **kw),
        "painn.make_crystal_model": lambda **kw: painn.make_crystal_model(depth=1, **kw),
        "gcn.make_model": lambda **kw: gcn.make_model(in_features=8, **kw),
        "gcn.make_model_weighted": lambda **kw: gcn.make_model_weighted(**kw),
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
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    calls[entry](device="cpu")  # asking for the CPU works
