"""Faults planted underneath the timed path, and the control, for the
tests and the calibration of the limits (``calibrate.py``): each must
turn ``correct`` false.

- ``unchanged``: a training step that returns its state unchanged (the
  loss is computed, no parameter moves);
- ``half_batch``: half of each batch's molecules left out, the mean taken
  over the rest (their masks cleared before the program sees the batch);
- ``altered``: an answer altered where it is produced: one atom's force
  set to 0 in every evaluation's output.

The control is the plain reference put in the program's place, computed
in TF32 (``reference.common.control_precision``): ``control_numbers``.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from . import check, traffic
from .program import Program, make_weights

FAULTS = {"train": ("unchanged", "half_batch"), "eval": ("half_batch", "altered")}


def _half(batch):
    """The batch with the masks of its second half of real molecules cleared."""
    gmask = batch.globals["graph_mask"].clone()
    real = torch.nonzero(gmask)[:, 0]
    drop = real[len(real) // 2:]
    gmask[drop] = False
    node_mask = batch.node_mask & gmask[batch.graph_id.long()]
    return batch.replace(node_mask=node_mask,
                         globals={**batch.globals, "graph_mask": gmask})


@contextlib.contextmanager
def planted(fault: str):
    """Inside the block every ``Program`` carries ``fault``."""
    step, evaluate, batch = Program.step, Program.evaluate, Program.batch
    if fault == "unchanged":
        def bad_step(self, b):
            loss, _ = self.trainer.loss_fn(b)
            return loss.detach()
        Program.step = bad_step
    elif fault == "half_batch":
        Program.batch = lambda self, graphs: _half(batch(self, graphs))
    elif fault == "altered":
        def bad_evaluate(self, b):
            out = dict(evaluate(self, b))
            out["force"] = out["force"].clone()
            out["force"][0] = 0.0
            return out
        Program.evaluate = bad_evaluate
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        Program.step, Program.evaluate, Program.batch = step, evaluate, batch


def control_numbers(spec, workload: str, seed: int, device) -> Dict[str, float]:
    """The cell's numbers with the reference in TF32 in the program's place,
    against the reference itself, at the cell's own sizes."""
    from benchmark.reference.common import (MATMULS, Molecules, as_reference,
                                            control_precision, follow_steps)
    cell = spec.workload(workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    adapter = spec.module("adapters", cfg["adapter"])
    ref = spec.module("reference", cfg["reference"])
    pool = traffic.make_pool(mix, cfg, seed)
    weights = make_weights(adapter.weight_shapes(cfg), seed, device)
    w_ref = as_reference(weights)
    exact = MATMULS["exact"]
    f32 = torch.float32
    if mix["mode"] == "train":
        batches = [pool[k % len(pool)] for k in range(3)]
        r = follow_steps(lambda w, m: ref.loss(w, m, cfg, exact), w_ref,
                         [Molecules(g, device) for g in batches], cfg["learning_rate"])
        with control_precision(device) as mm:
            c = follow_steps(lambda w, m: ref.loss(w, m, cfg, mm), weights,
                             [Molecules(g, device, f32) for g in batches], cfg["learning_rate"])
        return check.train_numbers(c[0], r[0], c[1], r[1], c[3], r[3], weights)
    gaps = check.EvalGaps(with_charges=bool(cfg.get("need_esp")))
    for graphs in pool:
        r = {k: v.detach() for k, v in
             ref.predict(w_ref, Molecules(graphs, device), cfg, exact).items()}
        with control_precision(device) as mm:
            c = {k: v.detach() for k, v in
                 ref.predict(weights, Molecules(graphs, device, f32), cfg, mm).items()}
        # the control's outputs in the program's padded layout
        c["energy"] = c["energy"][:, None]
        gaps.add(c, r, None)
    return gaps.gaps
