"""The last root scripts of the port against the JAX package's, on the CPU:
``prepare_data`` and the two golden-IO harnesses, and ``chip_smoke.py``
phase 27 at a small size.

``prepare_data``'s pickles equal the root script's on the same extxyz input
and on the same xyz-plus-columns input; the harnesses' predictions on the
same weights agree within ``1e-5`` of each output's largest entry, and a
``--record`` followed by a check passes.
"""
import importlib
import importlib.util
import json
import os
import pickle
import subprocess
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
from gcnn_keras_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint  # noqa: E402
from gcnn_keras_tpu_torch.scripts import prepare_data  # noqa: E402
from gcnn_keras_tpu_torch.training import force_script  # noqa: E402
from gcnn_keras_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from gcnn_keras_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

OUTPUT_TOL = 1e-5


def _root_script(path, name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", str(ROOT / path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------- prepare_data


def _write_inputs(tmp_path):
    """An extxyz file and the same frames as xyz plus column files."""
    from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticMDDataset
    from gcnn_keras_tpu_torch.mol.io import write_xyz_file
    import chip_smoke
    frames = list(SyntheticMDDataset(num_frames=5, seed=1))
    chip_smoke.write_extxyz(str(tmp_path / "f.extxyz"), frames)
    rs = np.random.RandomState(0)
    n = len(frames[0]["node_number"])
    write_xyz_file(str(tmp_path / "g.xyz"), [(g["node_number"], g["node_coordinates"])
                                             for g in frames])
    write_xyz_file(str(tmp_path / "f.xyz"), [(g["node_number"], g["force"]) for g in frames])
    write_xyz_file(str(tmp_path / "eg.xyz"), [(g["node_number"], rs.randn(n, 3))
                                              for g in frames])
    np.savetxt(tmp_path / "e.txt", [g["energy"][0] for g in frames])
    np.savetxt(tmp_path / "q.txt", rs.randn(5, n) * 0.1)
    np.savetxt(tmp_path / "esp.txt", rs.randn(5, n) * 0.01)
    np.savetxt(tmp_path / "tq.txt", [0, 1, -1, 0, 2])


PREPARE = [["--extxyz", "f.extxyz"], ["--extxyz", "f.extxyz", "--units", "angstrom_ev"],
           ["--geoms", "g.xyz", "--energies", "e.txt", "--forces", "f.xyz", "--charges", "q.txt",
            "--esp", "esp.txt", "--esp-grad", "eg.xyz", "--angles"],
           ["--geoms", "g.xyz", "--energies", "e.txt", "--forces", "f.xyz", "--charges", "q.txt",
            "--total-charges", "tq.txt", "--units", "angstrom_ev", "--cutoff", "3",
            "--max-neighbours", "4"],
           ["--geoms", "g.xyz"]]


@pytest.mark.parametrize("argv", PREPARE, ids=range(len(PREPARE)))
def test_prepare_data_pickles_match_jax(argv, tmp_path, monkeypatch):
    _write_inputs(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["prepare_data.py"] + argv + ["--out", "jax"])
    _root_script("prepare_data.py", "prepare_data").main()
    ds = prepare_data.main(argv + ["--out", "port"])
    with open("jax/dataset.pickle", "rb") as f:
        ref = pickle.load(f)
    with open("port/dataset.pickle", "rb") as f:
        got = pickle.load(f)
    assert len(got) == len(ds) == 5
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    # the pickle is what the training engine reads through data_path
    loaded = force_script.load_force_dataset({**force_script.DEFAULTS,
                                              "data_path": "port/dataset.pickle"})
    assert len(loaded) == 5 and "edge_indices" in loaded[0]


# --------------------------------------------------------- golden-IO harnesses


HARNESSES = {"force_schnet": ("test_model_force_schnet_painn", [1, 6, 8], False),
             "force_hdnnp4th": ("test_model_force_hdnnp", [1, 6, 16], True)}


def _harness_inputs(directory, elements, esp):
    rs = np.random.RandomState(2)
    for i, n in enumerate((3, 5, 4)):
        pos = rs.randn(n, 3) * 1.2
        rows = [[int(rs.choice(elements)), *p] + ([rs.randn() * 0.01] if esp else [])
                for p in pos]
        with open(directory / f"input_{i:02d}.txt", "w") as f:
            f.write(f"{n}\n" + "\n".join(" ".join(repr(float(v)) if j else str(v)
                                                  for j, v in enumerate(r)) for r in rows) + "\n")


@pytest.mark.parametrize("script", list(HARNESSES))
def test_harness_matches_jax_on_the_same_weights(script, tmp_path, monkeypatch):
    """The JAX harness on a JAX checkpoint against the port's on the same
    (perturbed) weights: energies, forces and charges within ``OUTPUT_TOL``
    of their largest entry. The port's ``--record`` then check passes, its check
    against the JAX golden too, and a golden that is off fails with exit
    code 1 from the command line."""
    harness, elements, esp = HARNESSES[script]
    _harness_inputs(tmp_path, elements, esp)
    monkeypatch.chdir(tmp_path)
    jmod = importlib.import_module(script)
    cfg = dict(jmod.CONFIG)
    jm = jmod.build_model(cfg)
    jroot = _root_script(f"{harness}.py", harness)
    graphs = [jroot.read_input_file(str(p)) for p in sorted(tmp_path.glob("input_*.txt"))]
    prepared = []
    for g in graphs:
        from gcnn_keras_tpu.graph.preprocess import set_angle, set_range
        g = set_range(dict(g), max_distance=6.0, max_neighbours=25)
        g["edge_indices"] = g["range_indices"]
        prepared.append(set_angle(g, range_indices="edge_indices"))
    params = jm.init(jax.random.PRNGKey(3), JDataset(graphs=prepared).to_batch(
        global_keys=("total_charge",)), train=False)
    # perturbed, so that the outputs are not the near-zero sums of fresh
    # output layers, which a relative tolerance cannot hold
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rs.randn(*np.shape(x)).astype(np.float32), params)
    jsave_checkpoint(str(tmp_path / "jax_ckpt"), params, step=1)
    fm = importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{script}").build_model(
        force_script.load_config(force_script.script_module(script)), device="cpu")
    params_from_jax(fm.energy_model, jax.tree_util.tree_map(np.asarray, params))
    save_checkpoint(str(tmp_path / "port_ckpt"), fm.energy_model, step=1)

    argv = ["--script", script, "--record"]
    monkeypatch.setattr(sys, "argv", [harness] + argv + ["--checkpoint", "jax_ckpt",
                                                         "--golden", "jax.json"])
    jroot.main()
    port = importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{harness}")
    res = port.main(argv + ["--checkpoint", "port_ckpt", "--golden", "port.json",
                            "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert res["ok"] and json.loads((tmp_path / "port.json").read_text()) == res["results"]
    for key in ("energy", "force", "charge"):
        if key in ref[0] or key in res["results"][0]:
            r = np.concatenate([np.ravel(x[key]) for x in ref])
            g = np.concatenate([np.ravel(x[key]) for x in res["results"]])
            np.testing.assert_allclose(g, r, rtol=0, atol=OUTPUT_TOL * np.abs(r).max(),
                                       err_msg=key)
    check = ["--script", script, "--checkpoint", "port_ckpt", "--device", "cpu"]
    assert port.main(check + ["--golden", "port.json"])["ok"]
    assert port.main(check + ["--golden", "jax.json"])["ok"]
    off = json.loads((tmp_path / "port.json").read_text())
    off[1]["energy"] += 1e-3
    (tmp_path / "off.json").write_text(json.dumps(off))
    assert not port.main(check + ["--golden", "off.json"])["ok"]
    if script == "force_schnet":  # the command line's exit codes, once
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        for golden, code in (("off.json", 1), ("jax.json", 0)):
            out = subprocess.run([sys.executable, "-m", f"gcnn_keras_tpu_torch.scripts.{harness}"]
                                 + check + ["--golden", golden], env=env, capture_output=True,
                                 text=True, timeout=300)
            assert out.returncode == code, out.stderr
            assert ("FAIL" if code else "PASS") in out.stdout


# --------------------------------------------------------- chip_smoke phase 27


@pytest.fixture
def counted_kernels(monkeypatch):
    """Each kernel wrapper call counted as the card counts its launches, no
    device syncs."""
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


SMALL_RUNS = {"train_citation": ["--nodes", "150", "--epochs", "10", "--folds", "2"],
              "train_qm": ["--molecules", "24", "--epochs", "1", "--folds", "2",
                           "--batch-size", "8"],
              "train_crystal": ["--structures", "24", "--epochs", "1", "--batch-size", "8"],
              "train_vgd_mock": ["--graphs", "24", "--epochs", "10",
                                 "--dataset", "VgdMockDataset"],
              "train_vgd_rb_motifs": ["--graphs", "24", "--epochs", "10",
                                      "--dataset", "VgdRbMotifsDataset"]}


def test_chip_smoke_phase_27_runs_on_the_cpu(counted_kernels, monkeypatch, tmp_path):
    """Phase 27 on the CPU at a small size: each driver's run (its first
    step against the CPU, its kernel calls, every later step's launches),
    periodic MD against the CPU with its derived launches, and the fork's
    workflow chain with both harnesses."""
    cs = counted_kernels
    monkeypatch.chdir(tmp_path)
    for name, argv in SMALL_RUNS.items():
        module, _, cpu_step, script = cs.ZOO_DRIVER_RUNS[name]
        monkeypatch.setitem(cs.ZOO_DRIVER_RUNS, name,
                            (module, argv + ["--no-plots"], cpu_step, script))
    monkeypatch.setattr(cs, "PERIODIC_MD_STRUCTURES", 4)
    monkeypatch.setattr(cs, "WORKFLOW_FRAMES", 48)
    monkeypatch.setattr(cs, "HARNESS_INPUTS", 3)
    monkeypatch.setattr(cs, "phase_device", lambda: "cpu")
    drivers = [(s, m) for p, s, m in cs.ZOO_DRIVERS if p == 27]
    assert len(drivers) == 6
    recs = {}
    for script, model in drivers:
        paths, rs = cs.phase_zoo_driver(script, model, "cpu", device="cpu")
        assert paths[f"{script}_{model}"]["sorted_segment_sum"] > len(rs["sorted_segment_sum"])
        recs[script] = rs
    paths, rs = cs.phase_periodic_md("cpu", device="cpu")
    evals = cs.PERIODIC_MD_SEGMENTS * (cs.PERIODIC_MD_STEPS + 1)
    assert paths["periodic_md"]["sorted_segment_sum"] == evals * 10
    assert len(rs["sorted_segment_sum"]) == 2 * 10
    paths, rs = cs.phase_fork_chain("cpu", device="cpu")
    assert paths["fork_schnet_harness"]["sorted_segment_sum"] == 10
    assert paths["fork_hdnnp_harness"] == cs.HDNNP4TH_LAUNCHES
    assert {k: len(v) for k, v in rs.items()} == {
        "sorted_segment_sum": 15, "spd_solve": 2, "g2_fwd": 1, "g4_fwd": 1, "g2_vjp": 1,
        "g4_vjp": 1}
    assert not list(tmp_path.iterdir())  # the scratch directories are gone
