"""The numbers that decide ``correct``, each a gap between the program and
the plain reference, and their judgement against the cell's limits.

Training (the three steps set-up takes through the window's own call):

- ``loss_gap``: the worst step's ``|loss_p - loss_r| / |loss_r|``;
- ``grad_gap``: the first gradient, by the worst leaf, ``| |g_p| - |g_r| |``
  over the larger of ``|g_r|`` and the median leaf's ``|g_r|``;
- ``change_gap``: the parameters' change after the three steps, by the
  worst leaf, each leaf's gap taken in the same way, over the leaves
  whose reference gradient is at least a thousandth of the median leaf's
  (a leaf below moves under Adam by round-off alone);
- ``change_gap_median_leaf``: the same by the median leaf, for a cell
  whose worst leaf swings from seed to seed by Adam's first steps, which
  move an element whose gradient is near 0 by the sign of its round-off.

A cell's limits file (``limits/<cell>.json``) names the numbers it
compares: every number of an evaluation, and of training ``loss_gap``,
``grad_gap`` and one of the two changes. The others are worked out
(``calibrate.py`` prints them) and not compared.

Evaluation (every answer of the window against the reference of its
inputs): ``energy_gap`` (the worst molecule's gap over the mean size of
the energy: ``|E_r|``, or where the reference gives it, its
``energy_scale``, the sum of the magnitudes of the terms that the energy
sums, so that a small total of large terms that cancel does not swell
the gap), ``force_gap`` (the worst component over the RMS of ``F_r``)
and, where the model gives charges, ``charge_gap`` (over the RMS of
``q_r``).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor

MOVED_SHARE = 1e-3  # a leaf's reference gradient below this share of the median leaf's


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> List[float]:
    med = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def train_numbers(prog_losses: List[float], ref_losses: List[float],
                  prog_g1: Dict[str, float], ref_g1: Dict[str, float],
                  prog_w: Dict[str, Tensor], ref_w: Dict[str, Tensor],
                  w0: Dict[str, Tensor]) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_losses, ref_losses))
    names = sorted(ref_g1)
    med_g = statistics.median(ref_g1[n] for n in names)
    moved = [n for n in names if ref_g1[n] >= MOVED_SHARE * med_g]
    dp = {n: float((prog_w[n].to(w0[n].device) - w0[n]).norm()) for n in moved}
    dr = {n: float((ref_w[n] - w0[n]).norm()) for n in moved}
    change = _leaf_gaps(dp, dr, moved)
    return {"loss_gap": loss_gap, "grad_gap": max(_leaf_gaps(prog_g1, ref_g1, names)),
            "change_gap": max(change), "change_gap_median_leaf": statistics.median(change)}


# of these numbers a cell's limits name one or the other
ALTERNATIVES = (("change_gap", "change_gap_median_leaf"),)


class EvalGaps:
    """The worst gaps over every answer compared so far."""

    def __init__(self, with_charges: bool):
        self.gaps = {"energy_gap": 0.0, "force_gap": 0.0}
        if with_charges:
            self.gaps["charge_gap"] = 0.0
        self.compared = self.failed = 0

    def add(self, out: Dict[str, Tensor], ref: Dict[str, Tensor],
            limits: Optional[Dict[str, float]]) -> None:
        """One answer ``out`` (the port's padded outputs) against the
        reference ``ref`` of its inputs."""
        g, n = ref["energy"].shape[0], ref["force"].shape[0]
        scale_e = ref.get("energy_scale", ref["energy"].abs()).mean().clamp_min(1e-30)
        gaps = {"energy_gap": (out["energy"][:g, 0] - ref["energy"]).abs().max() / scale_e,
                "force_gap": (out["force"][:n] - ref["force"]).abs().max()
                / ref["force"].pow(2).mean().sqrt().clamp_min(1e-30)}
        if "charge_gap" in self.gaps:
            gaps["charge_gap"] = (out["charge"][:n] - ref["charge"]).abs().max() \
                / ref["charge"].pow(2).mean().sqrt().clamp_min(1e-30)
        gaps = {k: float(v.detach()) if torch.isfinite(v) else float("inf")
                for k, v in gaps.items()}
        for k, v in gaps.items():
            self.gaps[k] = max(self.gaps[k], v)
        self.compared += 1
        if limits is None or any(not v <= limits[k] for k, v in gaps.items()):
            self.failed += 1


def judge(numbers: Dict[str, float], limits: Optional[Dict[str, float]]
          ) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that the
    limits name: correct when each is within its limit. A cell without
    limits, or whose limits leave out a number (of two alternatives, both),
    is never correct."""
    if limits is None:
        return False, {k: {"value": v, "limit": None} for k, v in numbers.items()}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    alt = {k for group in ALTERNATIVES for k in group}
    covered = all(k in limits for k in numbers if k not in alt) and all(
        any(k in limits for k in group) for group in ALTERNATIVES if group[0] in numbers)
    ok = covered and set(limits) <= set(numbers) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
