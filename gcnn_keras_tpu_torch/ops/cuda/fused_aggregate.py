"""Counterpart of ``gcnn_keras_tpu/ops/pallas/fused_aggregate.py``.

Only ``gather_with_sorted_transpose`` is ported so far. The fused
gather-multiply-segment-sum kernel of that file (``_fused_gather_mul_segsum``)
is not: ``gather_mul_pool_edges(fused=True)`` raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .segment_sum import GatherWithSortedTranspose

Tensor = torch.Tensor


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
