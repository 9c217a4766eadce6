"""The plain references against the port on the CPU at a tiny size, on the
same seeded weights and graphs: energies, forces and charges, one training
step's loss, first gradient and parameters, and a weight changed in the
port that the comparison must see."""
from __future__ import annotations

import json

import pytest
import torch

from bench_helpers import ROOT
from benchmark.core import check, traffic
from benchmark.core.program import Program, make_weights
from benchmark.core.spec import Spec, read_json
from benchmark.reference.common import MATMULS, Molecules, as_reference, follow_steps

torch.set_num_threads(1)

# (configuration, mix)
CASES = {"schnet": ("schnet-force", "aspirin-train-b2560")}
# the port's float32 against the float64 reference
TOL = 1e-4


def _setup(case, frames=3, seed=11):
    spec = Spec(ROOT)
    cfg_name, mix_name = CASES[case]
    cfg = read_json(ROOT / "benchmark" / "configs" / f"{cfg_name}.json")
    mix = spec.traffic(mix_name)
    mix = dict(mix, frames_per_batch=frames, pool_batches=3, mode="train")
    pool = traffic.make_pool(mix, cfg, seed)
    adapter = spec.module("adapters", cfg["adapter"])
    ref = spec.module("reference", cfg["reference"])
    weights = make_weights(adapter.weight_shapes(cfg), seed, "cpu")
    return spec, cfg, pool, adapter, ref, weights


def _eval_gaps(cfg, out, r):
    gaps = check.EvalGaps(with_charges="charge" in r)
    gaps.add(out, r, None)
    return gaps.gaps


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_port_evaluation(case):
    _, cfg, pool, adapter, ref, weights = _setup(case)
    prog = Program(adapter, cfg, weights, "cpu", train=False)
    out = prog.evaluate(prog.batch(pool[0]))
    r = ref.predict(as_reference(weights), Molecules(pool[0], "cpu"), cfg, MATMULS["exact"])
    gaps = _eval_gaps(cfg, out, {k: v.detach() for k, v in r.items()})
    assert set(gaps) == ({"energy_gap", "force_gap", "charge_gap"} if cfg["need_esp"]
                         else {"energy_gap", "force_gap"})
    assert max(gaps.values()) < TOL, gaps


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_port_training_step(case):
    _, cfg, pool, adapter, ref, weights = _setup(case)
    prog = Program(adapter, cfg, weights, "cpu", train=True)
    loss = float(prog.step(prog.batch(pool[0])))
    g1, w1 = prog.first_grad_norms(), prog.params()
    mm = MATMULS["exact"]
    r_losses, r_g1, _, r_w1 = follow_steps(lambda w, m: ref.loss(w, m, cfg, mm),
                                           as_reference(weights),
                                           [Molecules(pool[0], "cpu")], cfg["learning_rate"])
    numbers = check.train_numbers([loss], r_losses, g1, r_g1, w1, r_w1, weights)
    assert max(numbers.values()) < TOL, numbers
    # the step moved every leaf the reference moves
    for name in r_g1:
        if r_g1[name] > 0:
            assert float((w1[name] - weights[name]).norm()) > 0, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_weight_changed_in_the_port_is_seen(case):
    _, cfg, pool, adapter, ref, weights = _setup(case)
    # one entry of the second interaction's filter
    name, index = "interaction_1.cfconv.filter_1.bias", (6,)
    changed = dict(weights)
    changed[name] = weights[name].clone()
    changed[name][index] += 0.05
    prog = Program(adapter, cfg, changed, "cpu", train=False)
    out = prog.evaluate(prog.batch(pool[0]))
    r = ref.predict(as_reference(weights), Molecules(pool[0], "cpu"), cfg, MATMULS["exact"])
    gaps = _eval_gaps(cfg, out, {k: v.detach() for k, v in r.items()})
    assert max(gaps.values()) > 10 * TOL, gaps


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from benchmark.reference.common import to_tf32
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12), 3.0])
    got = to_tf32(x).tolist()
    # ties go to even: 1 + 2^-11 -> 1, 1 + 3 2^-11 -> 1 + 2^-9
    assert got == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, -1.0, 3.0]


def test_limits_files_hold_each_cells_numbers():
    spec = Spec(ROOT)
    for cell in spec.data["workloads"]:
        limits = spec.limits(cell["name"])
        mode = spec.traffic(cell["traffic"])["mode"]
        assert limits is not None, cell["name"]
        if mode == "train":
            assert {"loss_gap", "grad_gap"} <= set(limits), (cell["name"], limits)
            assert len({"change_gap", "change_gap_median_leaf"} & set(limits)) == 1, limits
        else:
            want = {"energy_gap", "force_gap"} | (
                {"charge_gap"} if spec.config(cell["config"]).get("need_esp") else set())
            assert want == set(limits), (cell["name"], limits)
        assert all(0 < v < 1 for v in limits.values()), limits
        json.dumps(limits)


def test_judge_needs_a_limit_for_each_number():
    numbers = {"loss_gap": 1e-7, "grad_gap": 1e-6, "change_gap": 1e-6,
               "change_gap_median_leaf": 1e-7}
    ok, checks = check.judge(numbers, {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-5})
    assert ok and set(checks) == {"loss_gap", "grad_gap", "change_gap"}
    assert check.judge(numbers, {"loss_gap": 1e-5, "grad_gap": 1e-5,
                                 "change_gap_median_leaf": 1e-5})[0]
    assert not check.judge(numbers, {"loss_gap": 1e-5, "grad_gap": 1e-5})[0]
    assert not check.judge(numbers, {"loss_gap": 1e-5, "change_gap": 1e-5})[0]
    assert not check.judge(numbers, None)[0]
    assert not check.judge({"energy_gap": 1e-7, "force_gap": 1e-6}, {"energy_gap": 1e-5})[0]
    assert not check.judge({"energy_gap": 1e-7, "force_gap": 1e-6},
                           {"energy_gap": 1e-5, "force_gap": 1e-7})[0]
