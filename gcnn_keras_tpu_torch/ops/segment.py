"""Segment reductions with a given ``num_segments``; counterpart of
``gcnn_keras_tpu/ops/segment.py``.

Every sorted float sum runs through the sorted segment-sum kernel
(``ops/cuda/segment_sum.py``), with no size gate: the JAX package's gate
(E >= 16384, F >= 64, TPU backend) weighed the TPU kernel's fixed cost.
Mean, max, min and softmax are plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cuda.segment_sum import SortedSegmentSum

Tensor = torch.Tensor


def _bcast(v: Tensor, ref: Tensor) -> Tensor:
    return v.reshape(v.shape + (1,) * (ref.dim() - v.dim()))


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int,
                indices_are_sorted: bool = False) -> Tensor:
    """``out[r] = sum_{e: segment_ids[e] = r} data[e]``.

    Sorted float data takes the kernel (trailing dims flattened, a 1-D
    input as one column). Unsorted ids take a plain ``index_add_``, as the
    JAX package takes XLA's scatter-add for them."""
    if indices_are_sorted and data.is_floating_point():
        return SortedSegmentSum.apply(data, segment_ids.to(torch.int32),
                                      num_segments)
    return torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                       device=data.device).index_add_(0, segment_ids, data)


def segment_mean(data: Tensor, segment_ids: Tensor, num_segments: int,
                 indices_are_sorted: bool = False) -> Tensor:
    s = segment_sum(data, segment_ids, num_segments, indices_are_sorted)
    cnt = torch.bincount(segment_ids.long(), minlength=num_segments)[:num_segments]
    cnt = cnt.clamp_min(1).to(s.dtype)
    return s / _bcast(cnt, s)


def _segment_reduce(data: Tensor, segment_ids: Tensor, num_segments: int,
                    reduce: str) -> Tensor:
    index = _bcast(segment_ids.long(), data).expand_as(data)
    # a float start value is the reduction's identity: torch's backward
    # splits the gradient among every entry equal to the result, the excluded
    # start value too, so a start of 0 would take a share wherever the
    # extremum is 0; JAX splits it among the segment's ties alone. Integers
    # have no gradient and keep a start of 0 (an empty segment's value)
    start = (float("-inf") if reduce == "amax" else float("inf")) \
        if data.is_floating_point() else 0
    out = torch.full((num_segments,) + tuple(data.shape[1:]), start, dtype=data.dtype,
                     device=data.device)
    out = out.scatter_reduce(0, index, data, reduce=reduce, include_self=False)
    # empty segments (and non-finite results) are 0, as in the JAX package
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def segment_max(data: Tensor, segment_ids: Tensor, num_segments: int,
                indices_are_sorted: bool = False) -> Tensor:
    return _segment_reduce(data, segment_ids, num_segments, "amax")


def segment_min(data: Tensor, segment_ids: Tensor, num_segments: int,
                indices_are_sorted: bool = False) -> Tensor:
    return _segment_reduce(data, segment_ids, num_segments, "amin")


_SEGMENT_OPS = {
    "sum": segment_sum,
    "segment_sum": segment_sum,
    "mean": segment_mean,
    "segment_mean": segment_mean,
    "max": segment_max,
    "segment_max": segment_max,
    "min": segment_min,
    "segment_min": segment_min,
}


def segment_ops_by_name(name: str, data: Tensor, segment_ids: Tensor,
                        num_segments: int, indices_are_sorted: bool = False) -> Tensor:
    """Dispatch a segment reduction by its reference name."""
    try:
        op = _SEGMENT_OPS[name]
    except KeyError:
        raise ValueError(f"Unknown segment op {name!r}; choose from {sorted(_SEGMENT_OPS)}") from None
    return op(data, segment_ids, num_segments, indices_are_sorted)


def segment_softmax(data: Tensor, segment_ids: Tensor, num_segments: int,
                    mask: Optional[Tensor] = None) -> Tensor:
    """Numerically stable softmax within segments along axis 0; masked
    (padding) entries get probability 0."""
    if mask is not None:
        data = torch.where(_bcast(mask, data), data,
                           torch.full_like(data, -1e9))
    seg_max = segment_max(data, segment_ids, num_segments)
    ex = torch.exp(data - seg_max[segment_ids.long()])
    if mask is not None:
        ex = ex * _bcast(mask, ex).to(ex.dtype)
    denom = torch.zeros((num_segments,) + tuple(ex.shape[1:]), dtype=ex.dtype,
                        device=ex.device).index_add_(0, segment_ids, ex)
    denom = denom.clamp_min(1e-20)
    return ex / denom[segment_ids.long()]
