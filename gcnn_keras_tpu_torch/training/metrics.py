"""Metrics on tensors; counterpart of ``gcnn_keras_tpu/training/metrics.py``:
the MAE and RMSE over masked rows, times the label scaler's std, and the
NaN-tolerant binary accuracy.

The mask covers the leading dimensions of ``pred`` and is broadcast over
the trailing ones, which the mean also averages; the denominator is at
least 1, so an all-padding batch gives 0.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _masked_sum_and_count(err: Tensor, mask: Tensor):
    m = mask.reshape(tuple(mask.shape) + (1,) * (err.dim() - mask.dim())).to(err.dtype)
    trailing = math.prod(err.shape[mask.dim():])
    denom = torch.clamp_min(mask.to(err.dtype).sum() * trailing, 1.0)
    return (err * m).sum(), denom


def scaled_mae(pred: Tensor, target: Tensor, mask: Tensor, scale: float = 1.0) -> Tensor:
    """Mean absolute error over the rows of ``mask``, times ``scale``."""
    total, denom = _masked_sum_and_count((pred - target).abs(), mask)
    return total / denom * scale


def scaled_rmse(pred: Tensor, target: Tensor, mask: Tensor, scale: float = 1.0) -> Tensor:
    """Root of the mean squared error over the rows of ``mask``, times
    ``scale``."""
    total, denom = _masked_sum_and_count((pred - target) ** 2, mask)
    return torch.sqrt(total / denom) * scale


def nan_tolerant_auc_inputs(pred: Tensor, target: Tensor):
    """``(pred, target, weight)``: NaN labels become 0 with weight 0, every
    other label weight 1."""
    nan = torch.isnan(target)
    w = (~nan).to(target.dtype)
    t = torch.where(nan, torch.zeros_like(target), target)
    return pred, t, w


def binary_accuracy_no_nan(pred: Tensor, target: Tensor) -> Tensor:
    """The share of labelled entries where ``pred`` and ``target`` fall on
    the same side of 0.5; NaN labels do not count."""
    p, t, w = nan_tolerant_auc_inputs(pred, target)
    correct = ((p > 0.5) == (t > 0.5)).to(torch.float32) * w
    return correct.sum() / torch.clamp_min(w.sum(), 1.0)
