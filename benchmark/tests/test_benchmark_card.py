"""On the card: each cell's command runs one short window and prints the
contract's line with ``correct`` true; a traced run reads the device.
Skips without a CUDA card (the marker ``cuda``)."""
from __future__ import annotations

import json

import pytest

from bench_helpers import ROOT, last_json, run

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    _need_card()
    proc = run(ROOT, "--workload", cell, "--seed", "4000000007", "--seconds", "2",
               "--trace", "0", timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = last_json(proc.stdout)
    assert list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.cuda
def test_traced_run_reads_the_device():
    _need_card()
    proc = run(ROOT, "--workload", "schnet-eval-b1024", "--seed", "4000000009",
               "--seconds", "2", "--trace", "1", timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = last_json(proc.stdout)
    assert out["correct"], out["checks"]
    dev = out["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert {"kernels_per_eval.eval", "kernel_roofline.eval", "device_idle.eval"} <= set(out["metrics"])
    assert out["breakdown"]["device_ops"] and len(out["breakdown"]["device_ops"]) <= 10
