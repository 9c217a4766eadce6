"""The port stands alone: no module of ``gcnn_keras_tpu_torch`` nor its
scripts (``chip_smoke.py``, ``profile_serving_torch.py``,
``probe_kernel_variants.py``) imports JAX, flax, optax or the JAX package, and its entry
points refuse to fall back to the CPU unasked.

The scan reads the sources' ASTs rather than ``sys.modules``: the test
process has JAX loaded already.
"""
import ast
from pathlib import Path

import pytest
import torch

from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import hdnnp4th
from gcnn_keras_tpu_torch.models.hdnnp2nd import make_model_behler
from gcnn_keras_tpu_torch.models.schnet import make_crystal_model, make_model
from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gcnn_keras_tpu")
SOURCES = sorted((ROOT / "gcnn_keras_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_serving_torch.py", ROOT / "probe_kernel_variants.py"]


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
                                   "hdnnp4th.make_model_behler_charge_separat", "ScannedMD"])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
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
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    calls[entry](device="cpu")  # asking for the CPU works
