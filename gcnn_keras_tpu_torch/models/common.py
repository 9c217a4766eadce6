"""Shared model-building blocks; counterpart of
``gcnn_keras_tpu/models/common.py`` (``OptionalInputEmbedding`` so far)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


class OptionalInputEmbedding(nn.Module):
    """Embedding lookup iff the input has no feature dimension: integer
    ``(N,)`` -> ``(N, output_dim)``; a float ``(N, F)`` passes through.
    The table starts as U(-0.05, 0.05), the keras default."""

    def __init__(self, input_dim: int = 95, output_dim: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(nn.init.uniform_(
            torch.empty(input_dim, output_dim), -0.05, 0.05, generator=generator))

    def forward(self, x: Tensor) -> Tensor:
        if not x.is_floating_point() and x.dim() == 1:
            return F.embedding(x, self.weight)
        return x
