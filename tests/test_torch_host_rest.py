"""The training library's host-side modules of the port against the JAX
package's, on the same inputs: ``QMGraphLabelScaler``, the scaler
postprocessor (``tests/test_moldyn.py``'s recipe) and its re-export in
``graph/postprocess.py``, the history and split-index files (round trips
through ``tmp_path``, each package reading the other's), and the two
plotting scripts, run as ``python -m`` against the root scripts on a score
file and an extended-xyz file written here. Plain numpy on both sides: the
numbers agree to ``rtol 1e-12``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import KGCNNPlot
import plot_learning_curve
from gcnn_keras_tpu.data import scalers as jscalers
from gcnn_keras_tpu.data.datasets.synthetic import SyntheticMDDataset as JSyntheticMDDataset
from gcnn_keras_tpu.moldyn.base import (
    ExtensiveEnergyForceScalerPostprocessor as JPostprocessor)
from gcnn_keras_tpu.utils import save_load_utils as jsave
from gcnn_keras_tpu_torch.data import scalers
from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticMDDataset
from gcnn_keras_tpu_torch.graph import postprocess
from gcnn_keras_tpu_torch.graph.preprocess import get_preprocessor
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models.schnet import make_model
from gcnn_keras_tpu_torch.moldyn.base import (ExtensiveEnergyForceScalerPostprocessor,
                                              MolDynamicsModelPredictor)
from gcnn_keras_tpu_torch.scripts import kgcnn_plot
from gcnn_keras_tpu_torch.training.history import save_history_score
from gcnn_keras_tpu_torch.utils import save_load_utils

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12


def _qm_labels(seed=0, n_mols=12):
    rs = np.random.RandomState(seed)
    z = [rs.choice([1, 6, 7, 8], size=rs.randint(3, 9)) for _ in range(n_mols)]
    y = np.stack([np.array([len(a) * 1.7 + rs.randn() for a in z]),
                  rs.randn(n_mols) * 3.0 + 2.0,
                  np.array([np.sum(a) * 0.1 + rs.randn() for a in z])], axis=1)
    return y, z


def _qm_config(pkg):
    """The same three column scalers, as config dicts and as instances."""
    cfg = [{"class_name": "ExtensiveMolecularLabelScaler", "config": {"alpha": 1e-6}},
           {"class_name": "StandardLabelScaler", "config": {}},
           {"class_name": "ExtensiveMolecularLabelScaler",
            "config": {"standardize_scale": False}}]
    inst = [pkg.ExtensiveMolecularLabelScaler(alpha=1e-6), pkg.StandardLabelScaler(),
            pkg.ExtensiveMolecularLabelScaler(standardize_scale=False)]
    return {"dict": cfg, "instance": inst}


@pytest.mark.parametrize("form", ["dict", "instance"])
def test_qm_graph_label_scaler_matches_jax(form):
    y, z = _qm_labels()
    ours = scalers.QMGraphLabelScaler(_qm_config(scalers)[form])
    ref = jscalers.QMGraphLabelScaler(_qm_config(jscalers)[form])
    scaled = ours.fit_transform(y, z)
    np.testing.assert_allclose(scaled, ref.fit_transform(y, z), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(ours.get_scaling(), ref.get_scaling(), rtol=RTOL)
    back = ours.inverse_transform(scaled, z)
    np.testing.assert_allclose(back, ref.inverse_transform(scaled, z), rtol=RTOL)
    np.testing.assert_allclose(back, y, rtol=1e-9)
    assert [type(s).__name__ for s in ours.scalers] == [
        "ExtensiveMolecularLabelScaler", "StandardLabelScaler", "ExtensiveMolecularLabelScaler"]


def _fitted(pkg_scalers, dataset):
    sc = pkg_scalers.EnergyForceExtensiveLabelScaler()
    sc.fit_dataset(dataset)
    return sc


def test_scaler_postprocessor_matches_jax():
    """``tests/test_moldyn.py``'s recipe in both packages: a zero scaled
    energy inverts to the composition baseline; then random scaled outputs
    of every frame through both postprocessors."""
    ds, jds = SyntheticMDDataset(num_frames=8), JSyntheticMDDataset(num_frames=8)
    sc, jsc = _fitted(scalers, ds), _fitted(jscalers, jds)
    post, jpost = ExtensiveEnergyForceScalerPostprocessor(sc), JPostprocessor(jsc)
    assert postprocess.ExtensiveEnergyForceScalerPostprocessor \
        is ExtensiveEnergyForceScalerPostprocessor
    g = dict(ds[0])
    res = {"energy": np.array([0.0]), "force": np.zeros((len(g["node_number"]), 3))}
    out = post(res, g)
    expect = sc.inverse_transform(np.array([0.0]), [np.asarray(g["node_number"])])
    assert np.allclose(out["energy"], expect)
    rs = np.random.RandomState(2)
    for i in range(len(ds)):
        g, jg = dict(ds[i]), dict(jds[i])
        np.testing.assert_array_equal(g["node_number"], jg["node_number"])
        res = {"energy": rs.randn(1), "force": rs.randn(len(g["node_number"]), 3),
               "charge": rs.randn(len(g["node_number"]))}
        out, ref = post(res, g), jpost(res, jg)
        assert set(out) == set(ref) == {"energy", "force", "charge"}
        for key in out:
            np.testing.assert_allclose(out[key], ref[key], rtol=RTOL)


def test_predictor_runs_the_scaler_postprocessor():
    """``MolDynamicsModelPredictor(graph_postprocessors=[...])`` hands each
    graph's answer to the postprocessor: its energy and forces are the
    unscaled model outputs inverted."""
    ds = SyntheticMDDataset(num_frames=4)
    post = ExtensiveEnergyForceScalerPostprocessor(_fitted(scalers, ds))
    fm = EnergyForceModel(make_model(device="cpu", depth=1,
                                     generator=torch.Generator().manual_seed(0)),
                          device="cpu")
    pre = get_preprocessor("set_range", max_distance=5.0, max_neighbours=10)
    plain = MolDynamicsModelPredictor(fm, graph_preprocessors=[pre], device="cpu")
    scaled = MolDynamicsModelPredictor(fm, graph_preprocessors=[pre],
                                       graph_postprocessors=[post], device="cpu")
    frames = [dict(ds[i]) for i in range(len(ds))]
    for f, raw, got in zip(frames, plain([dict(f) for f in frames]),
                           scaled([dict(f) for f in frames])):
        ref = post(raw, f)
        np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-6)
        np.testing.assert_allclose(got["force"], ref["force"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("suffix", [".json", ".pickle"])
def test_history_files_round_trip_between_packages(suffix, tmp_path):
    history = {"loss": [3.0, 2.5, 1.25], "val_loss": [3.5, 2.75, 2.0]}
    for writer, reader in ((save_load_utils, save_load_utils), (save_load_utils, jsave),
                           (jsave, save_load_utils)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}_history{suffix}")
        writer.save_history(history, path)
        assert reader.load_history(path) == history


def test_training_indices_round_trip_between_packages(tmp_path):
    rs = np.random.RandomState(4)
    folds = [rs.permutation(20)[:k] for k in (5, 7, 8)]
    for writer, reader in ((save_load_utils, save_load_utils), (save_load_utils, jsave),
                           (jsave, save_load_utils)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}_indices.pickle")
        writer.save_training_indices(folds, path)
        got = reader.load_training_indices(path)
        assert len(got) == len(folds)
        for a, b in zip(got, folds):
            np.testing.assert_array_equal(a, b)


def _run_module(module, args, cwd):
    """``python -m <module> args`` in ``cwd`` with the repo importable;
    returns its standard output."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    done = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    return done.stdout


def test_plot_learning_curve_script_matches_the_root_script(tmp_path, monkeypatch):
    """A score file of two folds; each script plots the metric's lists into
    a directory of its own, the same files with the same messages."""
    monkeypatch.chdir(tmp_path)
    save_history_score([{"loss": [3.0, 2.0, 1.5], "val_loss": [3.2, 2.4, 1.9]},
                        {"loss": [2.8, 1.9, 1.4], "val_loss": [3.0, 2.5, 2.0]}],
                       "results/force/Schnet_score.yaml", model_name="Schnet",
                       dataset_name="synthetic")
    scores = "results/**/*_score.*"
    out = _run_module("gcnn_keras_tpu_torch.scripts.plot_learning_curve",
                      ["--scores", scores, "--out", "plots_port"], tmp_path)
    monkeypatch.setattr(sys, "argv", ["plot_learning_curve.py", "--scores", scores,
                                      "--out", "plots_jax"])
    plot_learning_curve.main()
    printed = [line for line in out.splitlines() if line.startswith("plotted")]
    assert len(printed) == 1
    assert sorted(os.listdir("plots_port")) == sorted(os.listdir("plots_jax"))
    assert len(os.listdir("plots_port")) == 1


def _write_geoms(path, seed=5, n_frames=6):
    rs = np.random.RandomState(seed)
    frames = []
    for _ in range(n_frames):
        n = rs.randint(3, 8)
        force = rs.randn(n, 3)
        charge = rs.randn(n) * 0.3
        energy = rs.randn() * 5.0
        frames.append({"node_number": rs.choice([1, 6, 8], size=n),
                       "node_coordinates": rs.randn(n, 3) * 1.5,
                       "ref_energy": energy, "pred_energy": energy + rs.randn() * 0.1,
                       "ref_forces": force, "pred_forces": force + rs.randn(n, 3) * 0.05,
                       "ref_charges": charge, "pred_charges": charge + rs.randn(n) * 0.02})
    save_load_utils.save_extxyz(path, frames,
                                array_keys=("ref_forces", "pred_forces", "ref_charges",
                                            "pred_charges"),
                                info_keys=("ref_energy", "pred_energy"))


@pytest.mark.parametrize("flags", [[], ["--atomic-units", "--per-atom"]],
                         ids=["plain", "atomic_per_atom"])
def test_kgcnn_plot_script_matches_the_root_script(flags, tmp_path, monkeypatch):
    """The metric table of an extended-xyz file of predictions, from the
    port's script and the root ``KGCNNPlot.py``: the same numbers, and a
    correlation plot per quantity where matplotlib is installed. The port's
    runs as ``python -m``, with the unit flags as its ``main(argv)``."""
    monkeypatch.chdir(tmp_path)
    _write_geoms("geoms.extxyz")
    args = ["-g", "geoms.extxyz", "-o", "port", "--json", "port.json", *flags]
    if flags:
        kgcnn_plot.main(args)
    else:
        _run_module("gcnn_keras_tpu_torch.scripts.kgcnn_plot", args, tmp_path)
    monkeypatch.setattr(sys, "argv", ["KGCNNPlot.py", "-g", "geoms.extxyz", "-o", "jax",
                                      "--json", "jax.json", *flags])
    KGCNNPlot.main()
    with open("port.json") as f:
        ours = json.load(f)
    with open("jax.json") as f:
        ref = json.load(f)
    assert set(ours) == set(ref) == {"energy", "forces", "charges"}
    for quantity, m in ours.items():
        assert m["count"] == ref[quantity]["count"] and m["unit"] == ref[quantity]["unit"]
        for key in ("mae", "rmse", "r2"):
            np.testing.assert_allclose(m[key], ref[quantity][key], rtol=RTOL)
    assert sorted(os.listdir("port")) == sorted(os.listdir("jax"))
