"""Weight initializers; counterpart of ``gcnn_keras_tpu/ops/initializers.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

Tensor = torch.Tensor


def glorot_orthogonal_(w: Tensor, generator: Optional[torch.Generator] = None,
                       scale: float = 2.0) -> Tensor:
    """DimeNet's initializer, in place: an orthogonal draw from
    ``generator``, rescaled to the variance ``scale / (fan_in + fan_out)``.
    ``w`` is a port ``Dense`` weight, ``(out, in)``; the flax kernel is its
    transpose, ``(in, out)``, whose orthogonal draw this one is: the rows
    of a flax kernel with more rows than columns are orthonormal columns
    here. The variance is over all entries, so it is the same either
    way."""
    if w.dim() != 2:
        raise ValueError("glorot_orthogonal expects 2D weights")
    fan_out, fan_in = w.shape
    with torch.no_grad():
        kernel = nn.init.orthogonal_(torch.empty(fan_in, fan_out), generator=generator)
        target = scale / (fan_in + fan_out)
        kernel = kernel * torch.sqrt(target / torch.clamp_min(kernel.var(unbiased=False), 1e-12))
        w.copy_(kernel.T)
    return w
