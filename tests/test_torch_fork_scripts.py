"""The port's ensemble, transfer and search scripts against the root scripts
of the JAX package, on the CPU.

A two-member JAX ensemble (SchNet, HDNNP4th) at the scripts' ``CONFIG``
widths is made from ``PRNGKey(member)`` with a scaler fitted on every
other frame, written as the JAX package writes checkpoints, and converted
into the port's (``params_from_jax``, ``torch.save``). On 12 frames
(``--conf``):

- ``evaluate_models``' report (each member's and the ensemble mean's
  MAEs) within ``rtol 1e-5``, and each member's ``errors_{i}.json``
  within ``rtol 1e-4`` (``test_torch_force_script.py``'s evaluator
  tolerance);
- ``calc_prediction_std``'s per-frame force and energy std within
  ``1e-5`` of the largest, and the same flagged frames at the JAX median
  as the threshold (frames within that tolerance of it left out);
- ``load_model``'s energies within ``1e-5`` of the largest;
- ``transfer_learning``: the trainable set is the JAX ``freeze_mask``'s
  for SchNet and HDNNP4th, and after 2 epochs every frozen parameter is
  bit for bit as loaded while the trainable ones moved;
- ``energy_hdnnp2nd.CONFIG`` equals the root script's; each new script's
  ``main`` runs with ``--device cpu``;
- ``chip_smoke.py`` phase 20 on the CPU at narrow widths.
"""
import importlib
import json
import os
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gcnn_keras_tpu.data.dataset import MemoryGraphDataset as JDataset  # noqa: E402
from gcnn_keras_tpu.data.scalers import EnergyForceExtensiveLabelScaler as JScaler  # noqa: E402
from gcnn_keras_tpu.training import force_script as jfs  # noqa: E402
from gcnn_keras_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint  # noqa: E402
from gcnn_keras_tpu_torch.training import force_script  # noqa: E402
from gcnn_keras_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from gcnn_keras_tpu_torch.utils.convert import flax_leaf_names, params_from_jax  # noqa: E402
from tests.torch_jax_jit import JitApply  # noqa: E402

torch.set_num_threads(1)

REPORT_RTOL, ERRORS_RTOL, STD_TOL, ENERGY_TOL = 1e-5, 1e-4, 1e-5, 1e-5
FRAMES = 12
PREFIX = "model_ens"
ENSEMBLES = ["force_schnet", "force_hdnnp4th"]


def _port(name):
    return importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{name}")


def _jax_dataset(name, cfg):
    jmod = importlib.import_module(name)
    return jmod.load_dataset(cfg) if hasattr(jmod, "load_dataset") \
        else jfs.load_force_dataset(cfg)


@pytest.fixture(scope="module", params=ENSEMBLES)
def ensemble(request, tmp_path_factory):
    """``(name, jax_dir, port_dir, conf)``: the same two-member ensemble as
    JAX checkpoints and as the port's, and the ``--conf`` file of both
    runs."""
    name = request.param
    base = tmp_path_factory.mktemp(name)
    conf = base / "conf.json"
    conf.write_text(json.dumps({"synthetic_frames": FRAMES}))
    cfg = jfs.script_config(importlib.import_module(name), synthetic_frames=FRAMES)
    ds = _jax_dataset(name, cfg)
    batch = JDataset(graphs=list(ds)).to_batch(global_keys=("energy", "total_charge"))
    jm = importlib.import_module(name).build_model(cfg)
    for i in range(2):
        params = jax.jit(lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(i), batch)
        scaler = JScaler()
        scaler.fit_dataset(ds[list(range(i, FRAMES, 2))])
        jdir = base / "jax" / f"{PREFIX}_{i}"
        jsave_checkpoint(str(jdir), params, step=1)
        scaler.save(str(jdir / "scaler.json"))
        fm = _port(name).build_model(cfg, device="cpu")
        params_from_jax(fm.energy_model, jax.tree_util.tree_map(np.asarray, params))
        pdir = base / "port" / f"{PREFIX}_{i}"
        save_checkpoint(str(pdir), fm.energy_model, step=1)
        shutil.copy(jdir / "scaler.json", pdir / "scaler.json")
    return name, base / "jax", base / "port", str(conf)


def _jit_jax_models(monkeypatch):
    """The JAX scripts' models with ``apply`` under ``jax.jit``."""
    for script in ENSEMBLES:
        mod = importlib.import_module(script)
        monkeypatch.setattr(mod, "build_model",
                            lambda *a, _build=mod.build_model, **kw: JitApply(_build(*a, **kw)))


def _jax_main(module, argv, workdir, monkeypatch, capsys):
    """The root script's ``main`` in ``workdir``; its printed JSON."""
    _jit_jax_models(monkeypatch)
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(sys, "argv", [module + ".py"] + argv)
    capsys.readouterr()
    importlib.import_module(module).main()
    return json.loads(capsys.readouterr().out)


def _port_main(module, argv, workdir, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    capsys.readouterr()
    got = _port(module).main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    if module == "calc_prediction_std" or module == "evaluate_models":
        assert json.loads(printed) == got
    return got


def test_evaluate_models_matches_jax(ensemble, monkeypatch, capsys):
    name, jdir, pdir, conf = ensemble
    argv = ["--prefix", PREFIX, "--script", name, "--output-dir", "eval", "--conf", conf]
    ref = _jax_main("evaluate_models", argv, jdir, monkeypatch, capsys)
    got = _port_main("evaluate_models", argv, pdir, monkeypatch, capsys)
    assert sorted(got) == sorted(ref) and got["n_members"] == 2
    for k in ("energy_mae_per_model", "energy_mae_ensemble", "force_mae_per_model",
              "force_mae_ensemble"):
        np.testing.assert_allclose(got[k], ref[k], rtol=REPORT_RTOL, err_msg=k)
    for i in range(2):
        errors = json.loads((pdir / "eval" / f"errors_{i}.json").read_text())
        jerrors = json.loads((jdir / "eval" / f"errors_{i}.json").read_text())
        assert sorted(errors) == sorted(jerrors) and any("Charge" in k for k in errors) == (
            name == "force_hdnnp4th")
        for k in jerrors:
            np.testing.assert_allclose(errors[k], jerrors[k], rtol=ERRORS_RTOL, err_msg=k)
        for f in ("geoms", "energy_predictions", "force_predictions"):
            ext = ".extxyz" if f == "geoms" else ".csv"
            assert (pdir / "eval" / f"{f}_{i}{ext}").exists(), f


def test_evaluate_models_takes_the_test_indices(ensemble, monkeypatch, capsys, tmp_path):
    name, _, pdir, conf = ensemble
    import pickle
    with open(tmp_path / "idx.pickle", "wb") as f:
        pickle.dump({"test": np.array([1, 4, 7])}, f)
    _port_main("evaluate_models", ["--prefix", PREFIX, "--script", name, "--output-dir",
                                   "eval_idx", "--conf", conf, "--indices",
                                   str(tmp_path / "idx.pickle")], pdir, monkeypatch, capsys)
    rows = (pdir / "eval_idx" / "energy_predictions_0.csv").read_text().splitlines()
    assert len(rows) == 1 + 3


def test_calc_prediction_std_matches_jax(ensemble, monkeypatch, capsys):
    name, jdir, pdir, _ = ensemble
    argv = ["--prefix", PREFIX, "--script", name]
    ref = _jax_main("calc_prediction_std", argv, jdir, monkeypatch, capsys)
    threshold = float(np.median(ref["force_std_max_per_frame"]))
    ref = _jax_main("calc_prediction_std", argv + ["--threshold", str(threshold)], jdir,
                    monkeypatch, capsys)
    got = _port_main("calc_prediction_std", argv + ["--threshold", str(threshold)], pdir,
                     monkeypatch, capsys)
    assert sorted(got) == sorted(ref)
    for k in ("force_std_max_per_frame", "energy_std_per_frame"):
        r = np.asarray(ref[k])
        assert len(got[k]) == len(r) == 64
        np.testing.assert_allclose(got[k], r, rtol=0, atol=STD_TOL * np.abs(r).max(), err_msg=k)
    np.testing.assert_allclose(got["force_std_mean"], ref["force_std_mean"], rtol=STD_TOL)
    per_frame = np.asarray(ref["force_std_max_per_frame"])
    near = set(np.flatnonzero(np.abs(per_frame - threshold) <= STD_TOL * per_frame.max()))
    assert 0 < len(ref["flagged_frames"]) < 64
    assert set(got["flagged_frames"]) - near == set(ref["flagged_frames"]) - near


def test_load_model_matches_jax(ensemble, monkeypatch):
    name, jdir, pdir, _ = ensemble
    load_model = importlib.import_module("load_model")
    _jit_jax_models(monkeypatch)
    monkeypatch.chdir(jdir)
    ref = load_model.load_and_predict(f"{PREFIX}_1", name, n_frames=5)
    monkeypatch.chdir(pdir)
    got = _port("load_model").load_and_predict(f"{PREFIX}_1", name, n_frames=5, device="cpu")
    assert {k: v for k, v in got.items() if k != "energies"} == \
        {k: v for k, v in ref.items() if k != "energies"}
    r = np.asarray(ref["energies"])
    np.testing.assert_allclose(got["energies"], r, rtol=0, atol=ENERGY_TOL * np.abs(r).max())


@pytest.mark.parametrize("prefixes", [["mlp_local", "output"], ["output_mlp"],
                                      ["interaction_0", "params/embed"], ["mlp_charge"]])
@pytest.mark.parametrize("name", ENSEMBLES)
def test_freeze_mask_labels_the_jax_leaves(name, prefixes):
    transfer = importlib.import_module("transfer_learning")
    cfg = jfs.script_config(importlib.import_module(name), synthetic_frames=3)
    batch = JDataset(graphs=list(_jax_dataset(name, cfg))).to_batch(
        global_keys=("energy", "total_charge"))
    jm = importlib.import_module(name).build_model(cfg)
    params = jax.jit(lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(0), batch)
    ref = {"/".join(str(p.key) for p in path): label for path, label in
           jax.tree_util.tree_leaves_with_path(transfer.freeze_mask(params, prefixes))}
    model = _port(name).build_model(cfg, device="cpu").energy_model
    labels = _port("transfer_learning").freeze_mask(model, prefixes)
    names = flax_leaf_names(model)
    assert {f"params/{names[n]}": label for n, label in labels.items()} == ref


@pytest.mark.parametrize("name,trainable", [("force_schnet", ["output_mlp"]),
                                            ("force_hdnnp4th", ["mlp_local", "output"])])
def test_transfer_learning_keeps_the_frozen_parameters(name, trainable, tmp_path, monkeypatch,
                                                       capsys):
    cfg = force_script.script_config(_port(name), synthetic_frames=16)
    fm = _port(name).build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    save_checkpoint(str(tmp_path / "start"), fm.energy_model, step=4)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"synthetic_frames": 16}))
    monkeypatch.chdir(tmp_path)
    _port("transfer_learning").main(["--checkpoint", "start", "--script", name, "--epochs",
                                     "2", "--trainable", *trainable, "--out", "moved",
                                     "--conf", str(conf), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {"saved": "moved"}
    before = load_checkpoint("start")["params"]
    after = load_checkpoint("moved", step=2)["params"]
    assert os.path.exists("moved/scaler.json")
    labels = _port("transfer_learning").freeze_mask(fm.energy_model, trainable)
    assert set(labels.values()) == {"trainable", "frozen"}
    for n, label in labels.items():
        if label == "frozen":
            assert torch.equal(after[n], before[n]), n
    assert all(not torch.equal(after[n], before[n]) for n, lab in labels.items()
               if lab == "trainable" and before[n].abs().max() > 0)


def test_energy_hdnnp2nd_config_equals_the_root_scripts():
    assert _port("energy_hdnnp2nd").CONFIG == importlib.import_module("energy_hdnnp2nd").CONFIG


def test_energy_hdnnp2nd_runs_from_the_command_line(tmp_path, monkeypatch):
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"synthetic_frames": 6, "batch_size": 3, "ensemble_size": 2,
                                "make_plots": False, "mlp_units": [8, 1]}))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delitem(sys.modules, "gcnn_keras_tpu_torch.scripts.energy_hdnnp2nd",
                        raising=False)
    monkeypatch.setattr(sys, "argv", ["energy_hdnnp2nd", "--device", "cpu", "--epochs", "1",
                                      "--conf", str(conf)])
    runpy.run_module("gcnn_keras_tpu_torch.scripts.energy_hdnnp2nd", run_name="__main__")
    for fold in range(2):
        assert load_checkpoint(f"model_hdnnp2nd_energy_{fold}", step=1)["params"]
    assert os.path.exists("results/model_hdnnp2nd_energy_score.yaml")


SEARCHES = {"force_schnet_hyp_param_search": "val_force_mae",
            "force_painn_hyp_param_search": "val_force_mae",
            "force_hdnnp2nd_hyp_param_search": "val_force_mae",
            "force_hdnnp4th_hyp_param_search": "val_force_mae",
            "charge_hyp_param_search": "val_charge_mae"}


def _trial_files(directory):
    out = {}
    for f in sorted(os.listdir(directory)):
        rec = json.loads((directory / f).read_text())
        rec.pop("time_s")
        out[f] = rec
    return out


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_search_script_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    """Three trials of one epoch, then the best one's three, on 20 frames:
    the JAX ``HyperbandSearch`` replaying the same metrics writes the same
    trial files (the same configurations, rungs and best trial); the best
    trial reads back."""
    from gcnn_keras_tpu.training.hyper_search import HyperbandSearch, SearchSpace
    from gcnn_keras_tpu_torch.training import hyper_search
    mod = _port(name)
    monkeypatch.setitem(mod.CONFIG, "synthetic_frames", 20)
    monkeypatch.chdir(tmp_path)
    records = []
    save = hyper_search.HyperbandSearch._save_trial
    monkeypatch.setattr(hyper_search.HyperbandSearch, "_save_trial",
                        lambda self, t: records.append(dict(t)) or save(self, t))
    best = mod.main(["--trials", "3", "--min-epochs", "1", "--max-epochs", "3",
                     "--directory", "search", "--device", "cpu"])
    assert "best:" in capsys.readouterr().out
    assert [r["epochs"] for r in records] == [1, 1, 1, 3]
    assert all(np.isfinite(v) for r in records for v in r["metrics"].values())
    tids = {json.dumps(r["hparams"], sort_keys=True): r["trial_id"] for r in records}
    metrics = {(r["trial_id"], r["epochs"]): r["metrics"] for r in records}
    HyperbandSearch(SearchSpace(mod.SPACE), objective=SEARCHES[name], num_trials=3,
                    min_epochs=1, max_epochs=3, directory=str(tmp_path / "ref")).run(
        lambda hp, epochs: metrics[tids[json.dumps(hp, sort_keys=True)], epochs])
    trials = _trial_files(tmp_path / "search")
    assert trials == _trial_files(tmp_path / "ref") and len(trials) == 4
    assert _port("retrieve_trial").main(["--directory", "search"]) == dict(
        trials["best_trial.json"], time_s=best["time_s"])


# ------------------------------------------------- chip_smoke phase 20


@pytest.fixture
def counted_kernels(monkeypatch):
    """Each kernel wrapper call counted as the card counts its launches."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for kname, (mod, attr, _) in chip_smoke.kernel_wrappers().items():
        def counted(*args, _run=getattr(mod, attr), _mod=mod, _name=kname):
            if isinstance(_mod.launches, dict):
                _mod.launches[_name] += 1
            else:
                _mod.launches += 1
            return _run(*args)
        monkeypatch.setattr(mod, attr, counted)
    return chip_smoke


NARROW = {"force_schnet": {"schnet": {"depth": 2, "units": 16, "gauss_bins": 8,
                                      "gauss_distance": 5.0}},
          "force_painn": {"painn": {"depth": 2, "units": 8, "num_radial": 8, "cutoff": 5.0}},
          "force_hdnnp2nd": {"mlp_units": [8, 8, 1]}, "force_hdnnp4th": {"mlp_units": [8, 8, 1]}}


@pytest.mark.parametrize("name", ["force_schnet", "force_painn", "force_hdnnp2nd",
                                  "force_hdnnp4th"])
def test_chip_smoke_phase_20_workflow_runs_on_the_cpu(name, counted_kernels, tmp_path,
                                                       monkeypatch):
    """``phase_workflow`` on the CPU on a two-fold ensemble of 40 frames at
    narrow widths: every check of the card's run, the launches counted."""
    monkeypatch.chdir(tmp_path)
    cfg = dict(_port(name).CONFIG, synthetic_frames=40, batch_size=8, ensemble_size=2,
               epochs=1, make_plots=False, device="cpu", **NARROW[name])
    if name == "force_hdnnp4th":
        _port(name).train(cfg)
    else:
        force_script.run_force_training(_port(name).build_model, cfg)
    paths, recs = counted_kernels.phase_workflow(name, cfg, "cpu", device="cpu")
    assert sorted(paths) == [f"{name}_evaluate", f"{name}_transfer"]
    assert recs and all(r["max_abs_err"] == 0.0 for rs in recs.values() for r in rs)
    assert {r["path"] for rs in recs.values() for r in rs} == set(paths)


def test_chip_smoke_phase_20_searches_run_on_the_cpu(counted_kernels, tmp_path, monkeypatch):
    """``phase_searches`` on the CPU for the HDNNP2nd and charge searches on
    20 frames: the schedule, the replay, retrieve_trial, the first step."""
    monkeypatch.chdir(tmp_path)
    searches = ("force_hdnnp2nd_hyp_param_search", "charge_hyp_param_search")
    paths, recs = counted_kernels.phase_searches("cpu", device="cpu", frames=20,
                                                 searches=searches)
    assert sorted(paths) == sorted(f"{s}_search" for s in searches)
    assert all(paths[p]["g2_fwd"] > 0 for p in paths) and recs
