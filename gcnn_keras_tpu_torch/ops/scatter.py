"""Named scatter dispatch; counterpart of ``gcnn_keras_tpu/ops/scatter.py``
(kgcnn's ``tensor_scatter_nd_ops_by_name``), with JAX's ``.at[]``
semantics: ``indices (..., K)`` address the first K axes of ``target``;
"add" sums duplicates; "max"/"min" take the extremum of the target's entry
and every update to it (an untouched entry keeps the target's value);
"update" writes (one of duplicates wins)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_ADD = ("add", "scatter_add", "tensor_scatter_nd_add")
_MAX = ("max", "scatter_max", "tensor_scatter_nd_max")
_MIN = ("min", "scatter_min", "tensor_scatter_nd_min")
_UPDATE = ("update", "scatter_update")


def tensor_scatter_nd_ops_by_name(name: str, target: Tensor, indices: Tensor,
                                  updates: Tensor) -> Tensor:
    k = indices.shape[-1]
    idx = tuple(indices[..., i].long() for i in range(k))
    if name in _ADD:
        return target.index_put(idx, updates, accumulate=True)
    if name in _UPDATE:
        return target.index_put(idx, updates)
    if name in _MAX or name in _MIN:
        # the first K axes as one, for scatter_reduce along it
        lead, rest = target.shape[:k], tuple(target.shape[k:])
        flat_idx = torch.zeros_like(idx[0])
        for i, size in zip(idx, lead):
            flat_idx = flat_idx * size + i
        flat_idx = flat_idx.reshape(-1)
        src = updates.reshape((flat_idx.shape[0],) + rest)
        index = flat_idx.reshape((-1,) + (1,) * len(rest)).expand_as(src)
        out = target.reshape((-1,) + rest).scatter_reduce(
            0, index, src, reduce="amax" if name in _MAX else "amin", include_self=True)
        return out.reshape(target.shape)
    raise ValueError(f"unknown scatter op {name!r}")
