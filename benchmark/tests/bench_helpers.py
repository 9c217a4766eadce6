"""Shared by the benchmark's tests: tiny copies of the cells, runnable on
the CPU.

``tiny_checkout(tmp)`` copies ``BENCHMARK.json`` and ``benchmark/`` into
``tmp``, links the port beside them, and adds for each cell a tiny twin
(``tiny-<cell>``: the same configuration, a pool of 3 batches of at most 4
frames), as new files and entries only. Its limits are the cell's own."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_checkout(tmp: Path) -> Path:
    tmp = Path(tmp)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    os.symlink(ROOT / "gcnn_keras_tpu_torch", tmp / "gcnn_keras_tpu_torch")
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    for cell in list(spec["workloads"]):
        name = f"tiny-{cell['name']}"
        mix = json.loads((tmp / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
        mix.update(frames_per_batch=min(mix["frames_per_batch"], 4), pool_batches=3,
                   trace_batches=3)
        (tmp / "benchmark" / "traffic" / f"tiny-{cell['traffic']}.json").write_text(json.dumps(mix))
        spec["workloads"].append(dict(cell, name=name, traffic=f"tiny-{cell['traffic']}"))
        limits = tmp / "benchmark" / "limits" / f"{cell['name']}.json"
        if limits.exists():
            shutil.copy(limits, tmp / "benchmark" / "limits" / f"{name}.json")
        for section in ("end_to_end", "per_layer"):
            for m in spec[section]:
                if cell["name"] in m.get("workloads", ()):
                    m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


def run(root: Path, *args, env=None, timeout=600) -> subprocess.CompletedProcess:
    """``python3 benchmark/run.py *args`` in the checkout ``root``, one
    thread a process."""
    e = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    return subprocess.run([sys.executable, str(Path(root) / "benchmark" / "run.py"), *args],
                          cwd=root, env=e, capture_output=True, text=True, timeout=timeout)


def last_json(stdout: str):
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None
