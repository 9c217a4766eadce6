"""Row-partition conversions; counterpart of
``gcnn_keras_tpu/ops/partition.py`` (kgcnn's ``ops/partition.py``). The
port's batches shift their indices once, when built, so no layer needs
these; they serve code carried over from kgcnn."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def row_splits_to_lengths(row_splits: Tensor) -> Tensor:
    return row_splits[1:] - row_splits[:-1]


def lengths_to_row_splits(lengths: Tensor) -> Tensor:
    return torch.cat([lengths.new_zeros((1,)), torch.cumsum(lengths, 0).to(lengths.dtype)])


def lengths_to_value_rowids(lengths: Tensor) -> Tensor:
    return torch.repeat_interleave(torch.arange(lengths.shape[0], device=lengths.device),
                                   lengths)


def value_rowids_to_lengths(rowids: Tensor, num_rows: int) -> Tensor:
    return torch.zeros(num_rows, dtype=rowids.dtype, device=rowids.device).index_add_(
        0, rowids, torch.ones_like(rowids))


def row_splits_to_row_limits(row_splits: Tensor) -> Tensor:
    return row_splits[1:]


def row_splits_to_row_starts(row_splits: Tensor) -> Tensor:
    return row_splits[:-1]


_CONVERT = {
    ("row_splits", "row_length"): row_splits_to_lengths,
    ("row_length", "row_splits"): lengths_to_row_splits,
    ("row_length", "value_rowids"): lengths_to_value_rowids,
    ("row_splits", "row_limits"): row_splits_to_row_limits,
    ("row_splits", "row_starts"): row_splits_to_row_starts,
}


def change_partition_by_name(partition: Tensor, from_kind: str, to_kind: str) -> Tensor:
    """A partition of one kind as another (``row_splits``, ``row_length``,
    ``value_rowids``, ``row_limits``, ``row_starts``), through
    ``row_splits`` where no direct conversion exists."""
    if from_kind == to_kind:
        return partition
    key = (from_kind, to_kind)
    if key in _CONVERT:
        return _CONVERT[key](partition)
    if from_kind == "value_rowids":
        raise ValueError("value_rowids conversion needs num_rows; use "
                         "value_rowids_to_lengths directly")
    as_splits = change_partition_by_name(partition, from_kind, "row_splits") \
        if from_kind != "row_splits" else partition
    return change_partition_by_name(as_splits, "row_splits", to_kind)


def partition_row_indexing(indices: Tensor, target_partition: Tensor,
                           index_partition: Tensor,
                           partition_type_target: str = "row_splits",
                           partition_type_index: str = "value_rowids") -> Tensor:
    """Per-sample indices shifted to disjoint indexing: each index plus the
    first row of its sample in the target partition."""
    if partition_type_target != "row_splits":
        target_partition = change_partition_by_name(
            target_partition, partition_type_target, "row_splits")
    if partition_type_index == "value_rowids":
        rowids = index_partition
    elif partition_type_index == "row_length":
        rowids = lengths_to_value_rowids(index_partition)
    else:
        rowids = lengths_to_value_rowids(row_splits_to_lengths(index_partition))
    shift = target_partition[:-1][rowids.long()]
    return indices + shift.reshape(shift.shape + (1,) * (indices.dim() - 1))
