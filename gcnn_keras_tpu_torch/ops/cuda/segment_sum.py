"""Sorted segment-sum: the hand-written CUDA kernel, its plain version and
its autograd pair; counterpart of ``gcnn_keras_tpu/ops/pallas/segment_sum.py``.

``out[r] = sum_{e : ids[e] = r} values[e]`` for ascending int32 ``ids``.
The kernel (``csrc/segment_sum.cu``) replaces the three TPU variants
``_sorted_segment_sum_pallas`` (``_make_kernel``), ``_v2`` and ``_v3``,
which compute the same function and differ only in their DMA schedule.
It has two instances, float32 and bfloat16 values: each sums in float32
and writes the values' type, as the TPU kernel accumulates in float32 and
writes ``values.dtype``.

Bound on the H100: memory bytes. Each call reads ``values`` and ``ids``
once and writes ``out`` once; at the SchNet serving shapes (E=54784,
F=128, N=8192) that is 28.0 + 0.2 + 4.2 MB, about 9.7 us at 3.35 TB/s.
The design answers it by giving each block the rows whose first edge lies
in its edge range (no search over the ids), staging that range's ids and
values in shared memory with coalesced loads, and summing each row in edge
order with no atomics, in a layout chosen by F (the source's header). At
F = 3 most of a call is the launch itself.

A CPU tensor takes :func:`segment_sum_plain`; a CUDA tensor launches the
kernel or raises. ``launches`` counts the float32 instance's launches and
``launches_bf16`` the bfloat16 one's, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import load_library

Tensor = torch.Tensor

launches = 0
launches_bf16 = 0

# the C entry point of each value type the kernel takes
_ENTRIES = {torch.float32: "gcnn_sorted_segment_sum_f32",
            torch.bfloat16: "gcnn_sorted_segment_sum_bf16"}


def segment_sum_plain(values: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """The kernel's plain PyTorch version (any device, any float dtype):
    ``index_add_`` in the values' type, for bfloat16 in float32 and then
    rounded to bfloat16 once, as the kernel does."""
    acc = torch.float32 if values.dtype == torch.bfloat16 else values.dtype
    return torch.zeros((num_segments,) + tuple(values.shape[1:]),
                       dtype=acc, device=values.device
                       ).index_add_(0, ids, values.to(acc)).to(values.dtype)


def _kernel(dtype: torch.dtype):
    """The C entry point of ``csrc/segment_sum.cu`` for ``dtype`` values,
    built on first use."""
    fn = getattr(load_library("segment_sum"), _ENTRIES[dtype])
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
    global launches, launches_bf16
    _check(values, ids, num_segments)
    if values.device.type == "cpu":
        return segment_sum_plain(values, ids, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {values.device}")
    if values.dtype not in _ENTRIES:
        raise TypeError("the CUDA kernel takes float32 or bfloat16 values (it sums in "
                        f"float32 and writes the values' type), got {values.dtype}")
    if not (values.is_contiguous() and ids.is_contiguous()):
        raise ValueError("values and ids must be contiguous")
    e, f = values.shape
    out = torch.empty((num_segments, f), dtype=values.dtype, device=values.device)
    if out.numel() == 0:
        return out
    fn = _kernel(values.dtype)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = fn(values.data_ptr(), ids.data_ptr(), out.data_ptr(), e, f,
                num_segments, stream)
    if rc != 0:
        raise RuntimeError(f"sorted_segment_sum kernel launch failed: CUDA error {rc}")
    if values.dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


class SortedSegmentSum(torch.autograd.Function):
    """values (E, ...) -> (num_segments, ...) by ascending ``ids``.

    Linear in ``values``; its backward is the gather ``ct[ids]``, run as
    :class:`GatherWithSortedTranspose`, whose own backward is this sum
    again, so derivatives of any order stay on the kernel. Its ``jvp`` is
    the sum of the tangent (the JAX package's ``linear_call``), so forward
    mode launches the kernel too."""

    @staticmethod
    def forward(ctx, values: Tensor, ids: Tensor, num_segments: int) -> Tensor:
        ctx.save_for_backward(ids)
        ctx.save_for_forward(ids)
        ctx.num_segments = num_segments
        flat = values.reshape(values.shape[0], -1).contiguous()
        out = segment_sum(flat, ids, num_segments)
        return out.reshape((num_segments,) + tuple(values.shape[1:]))

    @staticmethod
    def backward(ctx, ct: Tensor):
        (ids,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return GatherWithSortedTranspose.apply(ct, ids, None, ids), None, None

    @staticmethod
    def jvp(ctx, dvalues: Tensor, *_):
        (ids,) = ctx.saved_tensors
        return SortedSegmentSum.apply(dvalues, ids, ctx.num_segments)


class GatherWithSortedTranspose(torch.autograd.Function):
    """values (N, ...) -> values[indices] (E, ...).

    Its backward, the scatter-add by ``indices``, runs as the sorted sum:
    the cotangent is permuted by ``sender_perm`` (the stable argsort of
    ``indices``; None when ``indices`` is already ascending) and summed by
    ``indices_sorted = indices[sender_perm]``. Its ``jvp`` is this gather
    of the tangent, whose transpose is the sorted sum again."""

    @staticmethod
    def forward(ctx, values: Tensor, indices: Tensor,
                sender_perm: Optional[Tensor], indices_sorted: Tensor) -> Tensor:
        ctx.save_for_backward(sender_perm if sender_perm is not None
                              else indices_sorted, indices_sorted)
        ctx.save_for_forward(indices, sender_perm, indices_sorted)
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

    @staticmethod
    def jvp(ctx, dvalues: Tensor, *_):
        indices, perm, indices_sorted = ctx.saved_tensors
        return GatherWithSortedTranspose.apply(dvalues, indices, perm, indices_sorted)
