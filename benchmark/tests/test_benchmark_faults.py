"""The harness's check run on the CPU at a tiny size: a sound run comes out
correct, and with the timed path broken underneath (each fault a cell can
have), or with the TF32 control in the program's place, correct comes out
false. The look for a card is skipped: the cells run on the CPU."""
from __future__ import annotations

import time

import pytest
import torch

from bench_helpers import ROOT, tiny_checkout
from benchmark.core import faults
from benchmark.core.cell import run_cell
from benchmark.core.check import judge
from benchmark.core.spec import Spec

torch.set_num_threads(1)

CELLS = [w["name"] for w in Spec(ROOT).data["workloads"]]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(tiny_checkout(tmp_path_factory.mktemp("tiny")))


def _run(spec, cell, seed):
    return run_cell(spec, f"tiny-{cell}", seed, 0.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(spec, cell):
    res = _run(spec, cell, 2**31 + 101)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def _fault_cases():
    out = []
    spec = Spec(ROOT)
    for cell in CELLS:
        mix = spec.traffic(spec.workload(cell)["traffic"])
        for fault in faults.FAULTS[mix["mode"]]:
            if fault == "half_batch" and mix["frames_per_batch"] < 2:
                continue   # a batch of one molecule has no half to leave out
            out.append((cell, fault))
    return out


@pytest.mark.parametrize("cell,fault", _fault_cases())
def test_fault_turns_correct_false(spec, cell, fault):
    with faults.planted(fault):
        res = _run(spec, cell, 2**31 + 202)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(spec, cell):
    numbers = faults.control_numbers(spec, f"tiny-{cell}", 2**31 + 303, "cpu")
    correct, checks = judge(numbers, spec.limits(f"tiny-{cell}"))
    assert not correct, checks
