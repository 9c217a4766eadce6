"""One run of one cell: set-up, the checked steps, the timed (or traced)
window, the correctness check against the plain reference, the metrics.

Set-up builds everything the window uses, from the seed: the traffic pool,
the weights (on the device), the port's model and batches, for training
the port's ``Trainer``; then it takes every batch of the pool through the
window's own call, training's first three steps being the ones the
reference follows. Set-up ends at a ``synchronize()``. The window then runs
for ``seconds`` (``--trace 0``) or ``trace_batches`` calls under the
profiler (``--trace 1``), a closed loop with one caller cycling the pool:
training steps back to back, ended by a ``synchronize()``; evaluations
each ended by a ``synchronize()``, their latencies timed by the host's
clock. After the window the peak memory is read, the program freed, and
the reference judges what the window produced.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional

import torch

from . import check, traffic
from .program import Program, make_weights
from .spec import Spec

CHECKED_STEPS = 3


class Observation:
    """What a run saw, for the metric readers (``metrics/<name>.py``
    ``read(obs)``; ``instrument(obs)`` runs around the traced window)."""

    def __init__(self, spec: Spec, workload: str, cfg: dict, mix: dict, device):
        self.spec, self.workload, self.cfg, self.mix = spec, workload, cfg, mix
        self.mode = mix["mode"]
        self.device = torch.device(device)
        self.counts = spec.module("counts", cfg["counts"])
        self.program: Optional[Program] = None
        self.pool_counts: List[dict] = []
        self.done: List[int] = []          # pool index of each call in the window
        self.latency_s: List[float] = []   # evaluations: until their synchronize()
        self.window_s = 0.0
        self.setup_s = 0.0
        self.trace = None          # the traced window's Trace, and its calls
        self.trace_calls = 0
        self.in_window = False
        self.extra: Dict[str, object] = {}

    def frames_done(self) -> int:
        return sum(self.pool_counts[i]["graphs"] for i in self.done)

    def atoms_done(self) -> int:
        return sum(sum(self.pool_counts[i]["atoms"]) for i in self.done)

    def flops_done(self) -> float:
        """Model FLOPs of the window's calls: the configuration's forward
        count at each batch's real sizes, 3x for an evaluation (the force
        pass costs twice its primal) and 9x for a force-loss step."""
        per = 9.0 if self.mode == "train" else 3.0
        return per * sum(self.counts.forward_flops(self.pool_counts[i], self.cfg)
                         for i in self.done)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float) -> dict:
    """One run; returns ``{"obs", "correct", "checks", "numbers",
    "attempted", "failed", "memory_peak_bytes"}`` (``numbers``: those
    compared and those worked out beside them). ``t0`` is the host time
    the process started its set-up."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.workload(workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    obs = Observation(spec, workload, cfg, mix, device)
    adapter = spec.module("adapters", cfg["adapter"])
    ref = spec.module("reference", cfg["reference"])
    limits = spec.limits(workload)
    train = mix["mode"] == "train"

    phases = obs.extra["setup_phases"] = {"start": time.perf_counter() - t0}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    pool = traffic.make_pool(mix, cfg, seed)
    obs.pool_counts = [traffic.real_counts(g) for g in pool]
    phase("traffic")
    weights = make_weights(adapter.weight_shapes(cfg), seed, device)
    _sync(device)
    phase("weights")
    prog = obs.program = Program(adapter, cfg, weights, device, train)
    _sync(device)
    phase("model")
    batches = [prog.batch(g) for g in pool]
    phase("batches")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    if train:
        losses, g1 = [], None
        for k in range(CHECKED_STEPS):
            losses.append(prog.step(batches[k % len(batches)]))
            if k == 0:
                g1 = prog.first_grad_norms()
        w3 = prog.params()
        losses = [float(v) for v in losses]
        for k in range(CHECKED_STEPS, len(batches)):
            prog.step(batches[k])
    else:
        for b in batches:
            prog.evaluate(b)
    _sync(device)
    phase("first calls")
    # set-up's objects out of the garbage collector's way for the window
    gc.collect()
    gc.freeze()
    obs.setup_s = time.perf_counter() - t0

    kept: List[tuple] = []
    if trace:
        _traced_window(obs, batches, train, kept)
    else:
        _window(obs, batches, train, seconds, kept)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # free the program's state before the reference runs
    obs.program = prog = None
    del batches
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from benchmark.reference.common import MATMULS, Molecules, as_reference, follow_steps
    mm = MATMULS["exact"]
    w_ref = as_reference(weights)
    if train:
        mols = [Molecules(pool[k % len(pool)], device) for k in range(CHECKED_STEPS)]
        r_losses, r_g1, _, r_w3 = follow_steps(
            lambda w, m: ref.loss(w, m, cfg, mm), w_ref, mols, cfg["learning_rate"])
        numbers = check.train_numbers(losses, r_losses, g1, r_g1, w3, r_w3, weights)
        correct, checks = check.judge(numbers, limits)
        attempted, failed = len(obs.done) + obs.trace_calls, 0 if correct else 1
    else:
        gaps = check.EvalGaps(with_charges=bool(cfg.get("need_esp")))
        by_slot: Dict[int, list] = {}
        for slot, out in kept:
            by_slot.setdefault(slot, []).append(out)
        for slot, outs in sorted(by_slot.items()):
            r = ref.predict(w_ref, Molecules(pool[slot], device), cfg, mm)
            r = {k: v.detach() for k, v in r.items()}
            for out in outs:
                gaps.add(out, r, limits)
        numbers = gaps.gaps
        correct, checks = check.judge(numbers, limits)
        attempted, failed = len(obs.done) + obs.trace_calls, gaps.failed
        correct = correct and gaps.compared == attempted
    return {"obs": obs, "correct": correct, "checks": checks, "numbers": numbers,
            "attempted": attempted, "failed": failed, "memory_peak_bytes": int(memory_peak)}


def _call(obs: Observation, prog: Program, batch, slot: int, train: bool, kept: list):
    t = time.perf_counter()
    if train:
        prog.step(batch)
    else:
        out = prog.evaluate(batch)
        _sync(obs.device)
        obs.latency_s.append(time.perf_counter() - t)
        kept.append((slot, {k: v.detach() for k, v in out.items()}))
    obs.done.append(slot)


def _window(obs: Observation, batches, train: bool, seconds: float, kept: list) -> None:
    prog, n = obs.program, len(batches)
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        _call(obs, prog, batches[i % n], i % n, train, kept)
        i += 1
    _sync(obs.device)
    obs.window_s = time.perf_counter() - start


def _traced_window(obs: Observation, batches, train: bool, kept: list) -> None:
    """``trace_batches`` calls timed by the host's clock alone (the window
    of the host-clock readers), then as many under the profiler (the
    window of the trace readers)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from .trace import WINDOW, Trace
    prog, n, k = obs.program, len(batches), int(obs.mix["trace_batches"])
    start = time.perf_counter()
    for i in range(k):
        _call(obs, prog, batches[i % n], i % n, train, kept)
    _sync(obs.device)
    obs.window_s = time.perf_counter() - start
    done, latency_s = obs.done, obs.latency_s
    obs.done, obs.latency_s = [], []

    readers = [obs.spec.module("metrics", m["name"])
               for m in obs.spec.metrics(obs.workload, "per_layer")]
    activities = [ProfilerActivity.CPU]
    if obs.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with contextlib.ExitStack() as stack:
        for r in readers:
            if hasattr(r, "instrument"):
                stack.enter_context(r.instrument(obs))
        with profile(activities=activities) as prof:
            # two calls under the profiler before its window, so that its
            # own start-up is not in it
            for i in range(2):
                _call(obs, prog, batches[i % n], i % n, train, [])
            _sync(obs.device)
            obs.done = []
            obs.in_window = True
            with record_function(WINDOW):
                for i in range(k):
                    _call(obs, prog, batches[i % n], i % n, train, kept)
                _sync(obs.device)
            obs.in_window = False
    obs.trace_calls = len(obs.done)
    obs.done, obs.latency_s = done, latency_s
    obs.trace = Trace(prof)
