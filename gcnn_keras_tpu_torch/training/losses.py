"""Masked losses over padded graph batches; counterpart of
``gcnn_keras_tpu/training/losses.py``.

MAE and MSE over valid rows only: flat values, padding rows masked out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _masked_mean(err: Tensor, mask: Tensor) -> Tensor:
    """Mean of ``err`` over rows where ``mask`` is True (trailing feature
    dims of err are averaged too)."""
    m = mask.reshape(tuple(mask.shape) + (1,) * (err.dim() - mask.dim())).to(err.dtype)
    trailing = 1
    for s in err.shape[mask.dim():]:
        trailing *= s
    denom = torch.clamp_min(mask.to(err.dtype).sum() * trailing, 1.0)
    return (err * m).sum() / denom


def masked_graph_mae(pred: Tensor, target: Tensor, graph_mask: Tensor) -> Tensor:
    """MAE over valid graphs (pred/target ``(G, ...)``)."""
    return _masked_mean((pred - target).abs(), graph_mask)


def masked_graph_mse(pred: Tensor, target: Tensor, graph_mask: Tensor) -> Tensor:
    return _masked_mean((pred - target) ** 2, graph_mask)


def masked_node_mae(pred: Tensor, target: Tensor, node_mask: Tensor) -> Tensor:
    """MAE over valid nodes, for forces and charges."""
    return _masked_mean((pred - target).abs(), node_mask)


def masked_node_mse(pred: Tensor, target: Tensor, node_mask: Tensor) -> Tensor:
    return _masked_mean((pred - target) ** 2, node_mask)


def force_loss(pred_force: Tensor, target_force: Tensor, node_mask: Tensor,
               kind: str = "mae") -> Tensor:
    if kind == "mae":
        return masked_node_mae(pred_force, target_force, node_mask)
    return masked_node_mse(pred_force, target_force, node_mask)


def masked_categorical_crossentropy(logits: Tensor, labels: Tensor,
                                    mask: Tensor) -> Tensor:
    """Softmax cross-entropy over valid rows; ``labels`` one-hot or int."""
    if labels.dim() == logits.dim() - 1:
        labels = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    logp = F.log_softmax(logits, dim=-1)
    ce = -(labels * logp).sum(-1)
    m = mask.to(ce.dtype)
    return (ce * m).sum() / torch.clamp_min(m.sum(), 1.0)


def masked_accuracy(logits: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    if labels.dim() == logits.dim():
        labels = labels.argmax(-1)
    correct = (logits.argmax(-1) == labels).to(torch.float32)
    m = mask.to(torch.float32)
    return (correct * m).sum() / torch.clamp_min(m.sum(), 1.0)
