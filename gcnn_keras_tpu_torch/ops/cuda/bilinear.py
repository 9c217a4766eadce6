"""The AD-closed fused gather-multiply-segment-sum; counterpart of
``gcnn_keras_tpu/ops/pallas/bilinear.py`` (the ``gms`` primitive).

``out[s] = sum_{e: sidx[e] = s} x[gidx[e]] * m[e]`` is bilinear in
``(x, m)``. :class:`GMS` runs its forward on the fused kernel
(``csrc/fused_aggregate.cu``; the plain version on a CPU tensor) and its
backward is exactly the JAX package's ``_gms_transpose``, built from the
port's differentiable Functions:

- ``ct_x``: the receiver gather of ``ct`` (:class:`GatherWithSortedTranspose`,
  no perm), times ``m``, permuted by ``gperm`` (:class:`PermuteRows`), summed
  by ``gidx[gperm]`` (:class:`SortedSegmentSum`);
- ``ct_m``: the receiver gather of ``ct`` times the sender gather of ``x``,
  each a :class:`GatherWithSortedTranspose`.

Each of those is linear with a backward of any order, so the closure holds
to any order (force training differentiates the forces again). In reverse
mode the kernel runs on forward (primal) applications only. Forward mode
(``training/fast_force_step.py``) takes the JAX package's bilinear JVP rule,
``GMS(dx, m) + GMS(x, dm)``: the kernel runs on the tangents too, and a
reverse pass over the tangent reaches the backward above.

Index invariants (GraphBatch): ``sidx`` ascending, ``gperm`` a permutation
that makes ``gidx`` ascending (``batch.edges['sender_perm']``).
``max_nodes`` and ``exact`` are accepted for the signature and have no
effect (``ops/cuda/fused_aggregate.py``).
"""
from __future__ import annotations

import torch

from . import fused_aggregate
from .autograd import input_needed
from .segment_sum import GatherWithSortedTranspose, SortedSegmentSum

Tensor = torch.Tensor


def invert_perm(perm: Tensor) -> Tensor:
    """The inverse of a permutation of ``range(E)``."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


class PermuteRows(torch.autograd.Function):
    """``vals[perm]``, whose backward is the inverse permutation (a gather,
    not a scatter) and whose ``jvp`` is the same permutation of the tangent;
    linear, so of any order."""

    @staticmethod
    def forward(ctx, vals: Tensor, perm: Tensor, inv: Tensor) -> Tensor:
        ctx.save_for_backward(perm, inv)
        ctx.save_for_forward(perm, inv)
        return vals.index_select(0, perm)

    @staticmethod
    def backward(ctx, ct: Tensor):
        perm, inv = ctx.saved_tensors
        return PermuteRows.apply(ct, inv, perm), None, None

    @staticmethod
    def jvp(ctx, dvals: Tensor, *_):
        perm, inv = ctx.saved_tensors
        return PermuteRows.apply(dvals, perm, inv)


class GMS(torch.autograd.Function):
    """``out[s] = sum_{e: sidx[e] = s} x[gidx[e]] * m[e]`` with x (N, F),
    m (E, F); ``gidx_sorted = gidx[gperm]`` and ``inv = invert_perm(gperm)``
    are passed in so that they are computed once. The ``jvp`` launches the
    kernel once for each input that has a tangent (the JAX ``_gms_jvp``)."""

    @staticmethod
    def forward(ctx, x: Tensor, m: Tensor, gidx: Tensor, sidx: Tensor, gperm: Tensor,
                gidx_sorted: Tensor, inv: Tensor) -> Tensor:
        ctx.save_for_backward(x, m, gidx, sidx, gperm, gidx_sorted, inv)
        ctx.save_for_forward(x, m, gidx, sidx, gperm, gidx_sorted, inv)
        # an input without a tangent reaches jvp as None, not as zeros (and
        # an output without a cotangent the backward)
        ctx.set_materialize_grads(False)
        return fused_aggregate.fused_gather_mul_segsum_kernel(
            x.contiguous(), m.contiguous(), gidx, sidx, x.shape[0])

    @staticmethod
    def backward(ctx, ct: Tensor):
        if ct is None:  # materialize_grads is off
            return (None,) * 7
        x, m, gidx, sidx, gperm, gidx_sorted, inv = ctx.saved_tensors
        ct_x = ct_m = None
        need_x, need_m = input_needed(ctx, 0), input_needed(ctx, 1)
        if need_x or need_m:
            ct_e = GatherWithSortedTranspose.apply(ct, sidx, None, sidx)
        if need_x:
            ct_x = SortedSegmentSum.apply(PermuteRows.apply(ct_e * m, gperm, inv),
                                          gidx_sorted, x.shape[0])
        if need_m:
            ct_m = ct_e * GatherWithSortedTranspose.apply(x, gidx, gperm, gidx_sorted)
        return ct_x, ct_m, None, None, None, None, None

    @staticmethod
    def jvp(ctx, dx, dm, *_):
        x, m, *idx = ctx.saved_tensors
        terms = [GMS.apply(a, b, *idx) for a, b in ((dx, m), (x, dm))
                 if a is not None and b is not None]
        return terms[0] if len(terms) == 1 else terms[0] + terms[1]


def gms(x: Tensor, m: Tensor, gidx: Tensor, sidx: Tensor, gperm: Tensor, *,
        max_nodes: int = 0, exact: bool = False) -> Tensor:
    """Fused gather-multiply-segment-sum with derivatives of any order.
    ``sidx`` ascending; ``gperm`` a permutation sorting ``gidx``."""
    gidx, sidx, gperm = (t.to(torch.int32) for t in (gidx, sidx, gperm))
    return GMS.apply(x, m, gidx, sidx, gperm, gidx.index_select(0, gperm),
                     invert_perm(gperm))


def bilinear_gather_mul_segsum(x: Tensor, m: Tensor, senders: Tensor,
                               receivers: Tensor, sender_perm: Tensor,
                               max_nodes: int = 0, exact: bool = False) -> Tensor:
    """``out[r] = sum_{e: recv[e] = r} x[send[e]] * m[e]`` for receiver-sorted
    edges: the fused kernel forward, the unfused sorted-segment-sum
    backward; differentiable to any order."""
    return gms(x, m, senders, receivers, sender_perm, max_nodes=max_nodes, exact=exact)
