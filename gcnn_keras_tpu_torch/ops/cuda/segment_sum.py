"""Sorted segment-sum: the hand-written CUDA kernel, its plain version and
its autograd pair; counterpart of ``gcnn_keras_tpu/ops/pallas/segment_sum.py``.

``out[r] = sum_{e : ids[e] = r} values[e]`` for ascending int32 ``ids``.
The kernel (``csrc/segment_sum.cu``) replaces the three TPU variants
``_sorted_segment_sum_pallas`` (``_make_kernel``), ``_v2`` and ``_v3``,
which compute the same function and differ only in their DMA schedule.

Bound on the H100: memory bytes. Each call reads ``values`` and ``ids``
once and writes ``out`` once; at the SchNet serving shapes (E=54784,
F=128, N=8192) that is 28.0 + 0.2 + 4.2 MB, about 9.7 us at 3.35 TB/s.
The design answers it by reading each value once, in coalesced rows, and
summing in registers with no atomics; the F=3 calls are launch-bound.

A CPU tensor takes :func:`segment_sum_plain`; a CUDA tensor launches the
kernel or raises. ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import load_library

Tensor = torch.Tensor

launches = 0


def segment_sum_plain(values: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """The kernel's plain PyTorch version (any device, any float dtype)."""
    return torch.zeros((num_segments,) + tuple(values.shape[1:]),
                       dtype=values.dtype, device=values.device
                       ).index_add_(0, ids, values)


def _kernel():
    """The C entry point of ``csrc/segment_sum.cu``, built on first use."""
    fn = load_library("segment_sum").gcnn_sorted_segment_sum_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(values: Tensor, ids: Tensor, num_segments: int) -> None:
    if values.dim() != 2:
        raise ValueError(f"values must be (E, F), got shape {tuple(values.shape)}")
    if ids.dim() != 1 or ids.shape[0] != values.shape[0]:
        raise ValueError(f"ids must be ({values.shape[0]},), got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if ids.device != values.device:
        raise ValueError(f"values on {values.device} but ids on {ids.device}")
    if num_segments < 0:
        raise ValueError(f"num_segments={num_segments} < 0")


def segment_sum(values: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Sum the rows of ``values`` (E, F) into ``num_segments`` rows by the
    ASCENDING int32 ``ids`` (E,). Not differentiable by itself: see
    :class:`SortedSegmentSum`."""
    global launches
    _check(values, ids, num_segments)
    if values.device.type == "cpu":
        return segment_sum_plain(values, ids, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {values.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 values, got {values.dtype}")
    if not (values.is_contiguous() and ids.is_contiguous()):
        raise ValueError("values and ids must be contiguous")
    e, f = values.shape
    out = torch.empty((num_segments, f), dtype=torch.float32, device=values.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = fn(values.data_ptr(), ids.data_ptr(), out.data_ptr(), e, f,
                num_segments, stream)
    if rc != 0:
        raise RuntimeError(f"sorted_segment_sum kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


class SortedSegmentSum(torch.autograd.Function):
    """values (E, ...) -> (num_segments, ...) by ascending ``ids``.

    Linear in ``values``; its backward is the gather ``ct[ids]``, run as
    :class:`GatherWithSortedTranspose`, whose own backward is this sum
    again, so derivatives of any order stay on the kernel."""

    @staticmethod
    def forward(ctx, values: Tensor, ids: Tensor, num_segments: int) -> Tensor:
        ctx.save_for_backward(ids)
        flat = values.reshape(values.shape[0], -1).contiguous()
        out = segment_sum(flat, ids, num_segments)
        return out.reshape((num_segments,) + tuple(values.shape[1:]))

    @staticmethod
    def backward(ctx, ct: Tensor):
        (ids,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return GatherWithSortedTranspose.apply(ct, ids, None, ids), None, None


class GatherWithSortedTranspose(torch.autograd.Function):
    """values (N, ...) -> values[indices] (E, ...).

    Its backward, the scatter-add by ``indices``, runs as the sorted sum:
    the cotangent is permuted by ``sender_perm`` (the stable argsort of
    ``indices``; None when ``indices`` is already ascending) and summed by
    ``indices_sorted = indices[sender_perm]``."""

    @staticmethod
    def forward(ctx, values: Tensor, indices: Tensor,
                sender_perm: Optional[Tensor], indices_sorted: Tensor) -> Tensor:
        ctx.save_for_backward(sender_perm if sender_perm is not None
                              else indices_sorted, indices_sorted)
        ctx.has_perm = sender_perm is not None
        ctx.n = values.shape[0]
        return values.index_select(0, indices)

    @staticmethod
    def backward(ctx, ct: Tensor):
        perm, indices_sorted = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        if ctx.has_perm:
            ct = ct.index_select(0, perm)
        return (SortedSegmentSum.apply(ct, indices_sorted, ctx.n),
                None, None, None)
