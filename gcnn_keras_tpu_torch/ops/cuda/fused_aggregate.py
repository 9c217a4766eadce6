"""Fused gather-multiply-segment-sum and the sorted-transpose gather;
counterpart of ``gcnn_keras_tpu/ops/pallas/fused_aggregate.py``.

``out[r] = sum_{e: receivers[e] = r} x[senders[e]] * filt[e]`` for
ascending int32 ``receivers``. The kernel (``csrc/fused_aggregate.cu``)
replaces the TPU kernel ``_fused_gather_mul_segsum``; its header gives the
bound (memory bytes: 11.0 us at the SchNet serving shapes on the H100).

The JAX package gates that kernel on the TPU backend and ``E >= 16384``
(``min_edges``), the TPU kernel's ramp-up. The CUDA kernel has no fixed
cost to amortise, so a CUDA tensor launches it at every size; ``min_edges``
is accepted for the signature and ignored. So are ``max_nodes``, the
Pallas node window (the TPU has no gather, so each block DMAs ``max_nodes``
rows around it; a Hopper thread gathers its row through L2), and
``exact``, the Pallas bf16-split switch (the card sums in float32 FMA).

A CPU tensor takes :func:`fused_gather_mul_segsum_plain`; a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches and
nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..segment import segment_sum
from .autograd import input_needed
from .build import load_library
from .segment_sum import GatherWithSortedTranspose, SortedSegmentSum

Tensor = torch.Tensor

launches = 0

_REVERSE_ONLY = (
    "the custom-VJP gather-multiply-segment-sum (SchNet fused_aggregate='vjp', or "
    "fused_aggregate=True on a batch without sender_perm) is reverse mode only, as the "
    "JAX package's custom_vjp, which jax.jvp refuses: forward mode (the fast force step, "
    "training/fast_force_step.py) does not run it. Use fused_aggregate=True on a batch "
    "with sender_perm (the AD-closed GMS) or the default mode; the parameters are the same")


def fused_gather_mul_segsum_plain(x: Tensor, filt: Tensor, senders: Tensor,
                                  receivers: Tensor, num_segments: int) -> Tensor:
    """The kernel's plain PyTorch version: gather, multiply, ``index_add_``
    (any device, any float dtype)."""
    return torch.zeros((num_segments,) + tuple(filt.shape[1:]), dtype=filt.dtype,
                       device=filt.device).index_add_(
        0, receivers, x.index_select(0, senders) * filt)


def _kernel():
    """The C entry point of ``csrc/fused_aggregate.cu``, built on first use."""
    fn = load_library("fused_aggregate").gcnn_gather_mul_segsum_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: Tensor, filt: Tensor, senders: Tensor, receivers: Tensor,
           num_segments: int) -> None:
    if x.dim() != 2 or filt.dim() != 2 or x.shape[1] != filt.shape[1]:
        raise ValueError(f"x must be (N, F) and filt (E, F), got {tuple(x.shape)} "
                         f"and {tuple(filt.shape)}")
    for name, ids in (("senders", senders), ("receivers", receivers)):
        if ids.dim() != 1 or ids.shape[0] != filt.shape[0]:
            raise ValueError(f"{name} must be ({filt.shape[0]},), got {tuple(ids.shape)}")
        if ids.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {ids.dtype}")
        if ids.device != filt.device:
            raise ValueError(f"filt on {filt.device} but {name} on {ids.device}")
    if x.device != filt.device:
        raise ValueError(f"filt on {filt.device} but x on {x.device}")
    if num_segments < 0:
        raise ValueError(f"num_segments={num_segments} < 0")


def fused_gather_mul_segsum_kernel(x: Tensor, filt: Tensor, senders: Tensor,
                                   receivers: Tensor, num_segments: int) -> Tensor:
    """``out[r] = sum_{e: receivers[e] = r} x[senders[e]] * filt[e]`` for
    ASCENDING int32 ``receivers``, x (N, F), filt (E, F). Senders must lie
    in ``[0, N)`` (the batch's invariant; not checked on the card). Not
    differentiable by itself: see :class:`FusedGatherMulSegsum` and
    ``ops/cuda/bilinear.py`` ``GMS``."""
    global launches
    _check(x, filt, senders, receivers, num_segments)
    if filt.device.type == "cpu":
        return fused_gather_mul_segsum_plain(x, filt, senders, receivers, num_segments)
    if filt.device.type != "cuda":
        raise ValueError(f"no gather-multiply-segment-sum kernel for device {filt.device}")
    if x.dtype != torch.float32 or filt.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 x and filt, got {x.dtype} "
                        f"and {filt.dtype}")
    if not all(t.is_contiguous() for t in (x, filt, senders, receivers)):
        raise ValueError("x, filt, senders and receivers must be contiguous")
    e, f = filt.shape
    out = torch.empty((num_segments, f), dtype=torch.float32, device=filt.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(filt.device):
        stream = torch.cuda.current_stream(filt.device).cuda_stream
        rc = fn(x.data_ptr(), filt.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
                out.data_ptr(), e, f, num_segments, stream)
    if rc != 0:
        raise RuntimeError(f"gather_mul_segsum kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


class FusedGatherMulSegsum(torch.autograd.Function):
    """The custom-VJP route of the JAX package (``fused_gather_mul_segsum``,
    ``fused="vjp"``): the kernel forward; the backward is that file's
    ``f_bwd`` in differentiable PyTorch operations,
    ``d_filt = x[senders] * ct[receivers]`` and ``d_x`` the sum of
    ``ct[receivers] * filt`` by sender, on the sorted segment-sum through
    ``sender_perm`` (``index_add_`` without one). Force training can
    differentiate the backward again; the kernel runs on forward
    applications only. Reverse mode only: a ``custom_vjp`` in the JAX
    package, where ``jax.jvp`` refuses it, so its ``jvp`` raises
    (``_REVERSE_ONLY``)."""

    @staticmethod
    def forward(ctx, x: Tensor, filt: Tensor, senders: Tensor, receivers: Tensor,
                num_segments: int, sender_perm: Optional[Tensor]) -> Tensor:
        ctx.save_for_backward(x, filt, senders, receivers, sender_perm)
        return fused_gather_mul_segsum_kernel(x.contiguous(), filt.contiguous(),
                                              senders, receivers, num_segments)

    @staticmethod
    def backward(ctx, ct: Tensor):
        x, filt, senders, receivers, perm = ctx.saved_tensors
        ct_e = ct.index_select(0, receivers)
        d_x = d_filt = None
        if input_needed(ctx, 0):
            vals = ct_e * filt
            if perm is not None:
                d_x = SortedSegmentSum.apply(vals.index_select(0, perm),
                                             senders.index_select(0, perm), x.shape[0])
            else:
                d_x = torch.zeros_like(x).index_add_(0, senders, vals)
        if input_needed(ctx, 1):
            d_filt = x.index_select(0, senders) * ct_e
        return d_x, d_filt, None, None, None, None

    @staticmethod
    def jvp(ctx, *_):
        raise NotImplementedError(_REVERSE_ONLY)


def gather_mul_segsum_auto(x: Tensor, filt: Tensor, senders: Tensor,
                           receivers: Tensor, num_segments: int,
                           max_nodes: Optional[int] = None,
                           indices_are_sorted: bool = False,
                           min_edges: int = 16384,
                           sender_perm: Optional[Tensor] = None) -> Tensor:
    """:class:`FusedGatherMulSegsum` for sorted 2-D float32 inputs, else the
    unfused chain (gather, multiply, segment-sum). ``max_nodes`` and
    ``min_edges`` have no effect (module docstring)."""
    if (indices_are_sorted and x.dim() == 2 and filt.dim() == 2
            and x.dtype == torch.float32 and filt.dtype == torch.float32):
        return FusedGatherMulSegsum.apply(x, filt, senders.to(torch.int32),
                                          receivers.to(torch.int32), num_segments,
                                          sender_perm)
    return segment_sum(x.index_select(0, senders) * filt, receivers, num_segments,
                       indices_are_sorted=indices_are_sorted)


def gather_with_sorted_transpose(values: Tensor, indices: Tensor,
                                 sender_perm: Optional[Tensor] = None) -> Tensor:
    """``values[(N, ...)][indices (E,)]`` whose transpose (the scatter-add
    every force pass runs) is the sorted segment-sum kernel.

    ``sender_perm``: the stable argsort of ``indices``
    (``batch.edges['sender_perm']``); None when ``indices`` is already
    ascending (receiver gathers). Trailing dims are flattened for the kernel
    and restored."""
    indices_sorted = indices if sender_perm is None \
        else indices.index_select(0, sender_perm)
    return GatherWithSortedTranspose.apply(values, indices, sender_perm,
                                           indices_sorted)
