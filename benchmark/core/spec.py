"""``BENCHMARK.json`` and the files its names lead to.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
harness finds, by name alone:

- the configuration: the ``file`` of its ``configs`` entry, a JSON object
  that names its ``adapter`` (``adapters/<adapter>.py``: builds the port's
  model and the weights), its ``reference`` (``reference/<reference>.py``)
  and its ``counts`` (``counts/<counts>.py``: the model FLOPs);
- the traffic mix: ``traffic/<traffic>.json``;
- each metric: ``metrics/<metric name>.py``;
- the cell's correctness limits: ``limits/<workload>.json``.

Adding a cell, a mix, a configuration or a metric adds files and entries
and edits none.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "benchmark"
        self.data = read_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {[w['name'] for w in self.data['workloads']]})")

    def config(self, name: str) -> dict:
        """The configuration's file, with its BENCHMARK.json entry under
        ``"entry"``."""
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = read_json(self.root / c["file"])
                cfg["entry"] = c
                return cfg
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return read_json(self.bench_dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> Optional[Dict[str, float]]:
        path = self.bench_dir / "limits" / f"{workload}.json"
        return read_json(path) if path.exists() else None

    def metrics(self, workload: str, section: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
        that list it under ``workloads``, and those that list no cells."""
        return [m for m in self.data[section]
                if "workloads" not in m or workload in m["workloads"]]

    def module(self, kind: str, name: str) -> ModuleType:
        """``benchmark/<kind>/<name>.py``, loaded once under a private name."""
        return load_file(self.bench_dir / kind / f"{name}.py", f"_bench_{kind}_{name}")


def load_file(path: Path, modname: str) -> ModuleType:
    """The module of the file at ``path``, registered under ``modname`` made
    an identifier and told apart by a hash of the path (two checkouts in
    one process load their own copies)."""
    path = Path(path).resolve()
    key = "".join(c if c.isalnum() else "_" for c in modname) \
        + "_" + hashlib.sha1(str(path).encode()).hexdigest()[:8]
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    if not path.exists():
        raise FileNotFoundError(f"{path} (the harness finds each piece by its name)")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
