"""A cell and a per-layer metric added as new files and entries, with no
edit to any file the benchmark has, run through the harness's CPU dry
mode; and the generator's angles and ESP labels, which a configuration
turns on by its flags alone."""
from __future__ import annotations

import hashlib
import json

import numpy as np

from bench_helpers import last_json, run, tiny_checkout
from benchmark.core import traffic

METRIC = '''"""Calls in the traced window."""


def read(obs):
    return float(len(obs.done))
'''


def _digests(root):
    return {p: hashlib.sha1(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_files_and_entries(tmp_path):
    root = tiny_checkout(tmp_path)
    before = _digests(root)
    bench = root / "benchmark"
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps({
        "mode": "train",
        "molecule": {"shape": "packed", "atoms": 9, "composition": {"6": 3, "1": 4, "8": 2},
                     "spacing": 1.6, "placement": 0.5},
        "frame_jitter": 0.1, "frames_per_batch": 2, "pool_batches": 3, "trace_batches": 2}))
    (bench / "metrics" / "dummy_calls.train.py").write_text(METRIC)
    (bench / "limits" / "dummy-cell.json").write_text(json.dumps(
        {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dummy-cell", "config": "schnet-force",
                              "traffic": "dummy-mix", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "dummy_calls.train", "unit": "count", "better": "lower",
                              "source": "host_clock", "layer": "training engine",
                              "moves": "train_frames_per_s", "workloads": ["dummy-cell"]})
    for m in spec["end_to_end"]:
        if "train_frames_per_s" == m["name"]:
            m["workloads"].append("dummy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    proc = run(root, "--workload", "dummy-cell", "--seed", "77", "--seconds", "1",
               "--trace", "1", "--dry-run")
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = last_json(proc.stdout)["dry_run"]
    assert got["metrics"]["dummy_calls.train"]["value"] == 2.0
    assert got["correct"], got["checks"]
    proc = run(root, "--workload", "dummy-cell", "--seed", "77", "--seconds", "1",
               "--trace", "0", "--dry-run")
    got = last_json(proc.stdout)["dry_run"]
    assert set(got["metrics"]) == {"train_frames_per_s", "setup_s"}, proc.stderr[-3000:]
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


def test_generator_angles_and_esp_follow_the_configuration():
    mix = {"mode": "train", "molecule": {"shape": "chain", "atoms": 12, "composition": {"6": 4, "1": 8},
                                         "spacing": 1.3, "placement": 0.05},
           "frame_jitter": 0.05, "frames_per_batch": 2, "pool_batches": 1, "trace_batches": 1}
    cfg = {"cutoff": 3.0, "max_neighbours": 4, "need_angles": True, "need_esp": True}
    pool = traffic.make_pool(mix, cfg, 2**40 + 5)
    again = traffic.make_pool(mix, cfg, 2**40 + 5)
    for g, h in zip(pool[0], again[0]):
        assert all(np.array_equal(g[k], h[k]) for k in g)
        recv = g["edge_indices"][:, 0]
        m = np.bincount(recv, minlength=12)
        assert m.max() <= 4 and len(g["angle_indices_nodes"]) == int((m * (m - 1)).sum())
        i, j, k = g["angle_indices_nodes"].T
        assert (j != k).all()
        pairs = {tuple(e) for e in g["edge_indices"]}
        assert all((a, b) in pairs and (a, c) in pairs for a, b, c in zip(i, j, k))
        assert abs(float(g["charge"].sum())) < 1e-5 and g["esp_grad"].shape == (12, 3)
        assert g["total_charge"].tolist() == [0.0]
    assert traffic.real_counts(pool[0])["angles"] == sum(len(g["angle_indices_nodes"]) for g in pool[0])
