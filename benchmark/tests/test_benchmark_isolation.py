"""Nothing the benchmark runs loads JAX or the JAX package, the plain
references and the counts import nothing of the port, and the command
prints no result without a card or without the port."""
from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path

import pytest

from bench_helpers import ROOT, last_json, run, tiny_checkout

FORBIDDEN = {"jax", "jaxlib", "flax", "gcnn_keras_tpu"}


def _imports(path: Path):
    """Top-level names of every module a file imports."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    import sys
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        import run as bench_run
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    for name in ("jax.numpy", "gcnn_keras_tpu.batch", "flax", "jaxlib.xla_client"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "gcnn_keras_tpu_torch_like", object())
    got = bench_run.loaded_forbidden()
    assert {"jax.numpy", "gcnn_keras_tpu.batch", "flax", "jaxlib.xla_client"} <= set(got)
    assert all(m.split(".")[0] in FORBIDDEN for m in got)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not FORBIDDEN & set(_imports(path)), path


@pytest.mark.parametrize("part", ["reference", "counts"])
def test_references_and_counts_import_nothing_of_the_port(part):
    for path in (ROOT / "benchmark" / part).rglob("*.py"):
        assert "gcnn_keras_tpu_torch" not in set(_imports(path)), path


def test_dry_run_loads_no_jax(tmp_path):
    root = tiny_checkout(tmp_path)
    # run.py exits 3 naming what it found, should JAX or the JAX package load
    proc = run(root, "--workload", "tiny-schnet-eval-b1024", "--seed", "4294967311",
               "--seconds", "1", "--trace", "0", "--dry-run")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = last_json(proc.stdout)
    assert set(out) == {"dry_run"} and out["dry_run"]["attempted"] > 0


def test_no_result_without_a_card(tmp_path):
    proc = run(ROOT, "--workload", "schnet-eval-b1024", "--seed", "1", "--seconds", "1",
               "--trace", "0", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert last_json(proc.stdout) is None


def test_no_result_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for args in (["--workload", "schnet-eval-b1024"],
                 ["--workload", "schnet-eval-b1024", "--dry-run"]):
        proc = run(tmp_path, *args, "--seed", "1", "--seconds", "1", "--trace", "0")
        assert proc.returncode != 0
        assert last_json(proc.stdout) is None
    json.loads((tmp_path / "BENCHMARK.json").read_text())
