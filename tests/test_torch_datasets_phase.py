"""``chip_smoke.py`` phase 28 (the dataset layer) on the CPU at small sizes,
and its archives read in a fresh interpreter without JAX or pandas.

The phase writes its archives into a temporary dataset root, builds each
dataset as its driver does, runs ``train_citation --hyper hyper_cora.py``,
``train_qm --hyper hyper_qm9_energies.py``, ``train_force --hyper
hyper_md17_revised.py`` and ``train_tudataset --dataset MUTAG`` (each first
step against the CPU, each #1 call against its plain version), and checks
that a missing file raises ``FileNotFoundError`` and ESOL raises RDKit's
``ImportError`` after reading its CSV. On the CPU every kernel wrapper is
counted as the card counts its launches; ``tests/test_torch_cuda.py`` runs
the phase on the card.
"""
import os
import subprocess
import sys

from tests.test_torch_zoo_scripts import counted_kernels  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(cora=dict(nodes=300, features=140, links=900, classes=70, per_row=6), qm9=128,
             rmd17=80, mutag=140)
RUNS = ("train_citation_cora_GCN", "train_qm_qm9_Schnet",
        "train_force_rmd17_Schnet.EnergyForceModel", "train_tudataset_mutag_GIN")


def test_phase_28_runs_on_the_cpu(counted_kernels, tmp_path, monkeypatch):  # noqa: F811
    cs = counted_kernels
    monkeypatch.chdir(tmp_path)
    paths, recs = cs.phase_datasets("cpu", device="cpu", sizes=SMALL)
    assert sorted(paths) == sorted(RUNS)
    for run in RUNS:
        assert paths[run]["sorted_segment_sum"] > 0, run
    assert len(recs["sorted_segment_sum"]) > 0
    assert not cs.DATASET_CACHE and not os.listdir(tmp_path)


_ALONE = """
import importlib, sys, tempfile
import chip_smoke
from gcnn_keras_tpu_torch.data import download
from gcnn_keras_tpu_torch.data.serial import _DATASET_MODULES, deserialize
from gcnn_keras_tpu_torch.scripts import train_tudataset
from gcnn_keras_tpu_torch.training.hyper import HyperParameter
with tempfile.TemporaryDirectory() as root:
    download.DATASET_ROOT = root
    chip_smoke.write_cora_npz(root, nodes=60, features=20, links=150, classes=7, per_row=3)
    chip_smoke.write_qm9_zip(root, 6)
    chip_smoke.write_rmd17_npz(root, 5)
    chip_smoke.write_tu_zip(root, "MUTAG", 8)
    sizes = []
    for path, model in ((chip_smoke.HYPER_CORA, "GCN"), (chip_smoke.HYPER_QM9, "Schnet"),
                        (chip_smoke.HYPER_RMD17, "Schnet.EnergyForceModel")):
        sizes.append(len(deserialize(HyperParameter(path, model_name=model)["data"]["dataset"])))
    score = train_tudataset.main(["--dataset", "MUTAG", "--epochs", "1", "--folds", "2",
                                  "--batch-size", "2", "--no-plots", "--device", "cpu"])
for name, module in _DATASET_MODULES.items():
    getattr(importlib.import_module(module), name)
print(sizes, score["number_histories"],
      sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'gcnn_keras_tpu', 'pandas')))
"""


def test_fresh_interpreter_builds_the_datasets_without_jax_or_pandas(tmp_path):
    """The phase's archives built through ``deserialize`` of the library's
    configs, ``train_tudataset --dataset MUTAG`` run and every dataset
    class of the table imported in a fresh interpreter: no module of JAX,
    the JAX package or pandas is loaded."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _ALONE], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[1, 6, 5] 2 []", out.stdout
