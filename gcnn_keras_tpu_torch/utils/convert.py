"""Load the JAX package's flax parameters into the port's modules.

The port names its submodules after the flax parameter tree, so a module at
``interaction_0.cfconv.filter_1`` takes ``interaction_0/cfconv/filter_1``.
Four node types carry weights in their own layout:

- ``Dense``: ``<path>/Dense_0/kernel`` (in, out), transposed into
  ``weight`` (out, in), and ``<path>/Dense_0/bias``;
- ``RelationalDense``: ``<path>/kernel`` (R, in, out) and ``<path>/bias``
  (R, out), as they are;
- ``OptionalInputEmbedding``: ``<path>/Embed_0/embedding``; its flax name
  is ``OptionalInputEmbedding_0`` where the port says ``embedding``;
- ``GraphLayerNorm``: ``<path>/LayerNorm_0/scale`` and
  ``<path>/LayerNorm_0/bias``.

Any other module's own parameters are bare flax leaves of the same name,
``<path>/<name>``, as they are: the per-element tables ``hardness_j`` and
``sigma`` of the HDNNP4th electrostatics.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..layers.mlp import Dense, RelationalDense
from ..layers.norm import GraphLayerNorm
from ..models.common import OptionalInputEmbedding

_FLAX_NAMES = {"embedding": "OptionalInputEmbedding_0"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _flax_path(name: str) -> str:
    return "/".join(_FLAX_NAMES.get(p, p) for p in name.split("."))


def params_from_jax(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a flax parameter tree (nested dict of numpy arrays, with or
    without the top-level ``"params"``) into ``model`` in place. Raises if
    a port parameter has no flax leaf, a flax leaf is left over, or a shape
    differs."""
    flat = _flatten(tree.get("params", tree))
    used, filled = set(), set()

    def take(key: str, target: torch.Tensor, transpose: bool = False) -> None:
        if key not in flat:
            raise KeyError(f"flax parameter {key!r} missing")
        arr = flat[key].T if transpose else flat[key]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{key}: flax shape {arr.shape} vs port "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.tensor(arr))
        used.add(key)
        filled.add(id(target))

    for name, module in model.named_modules():
        base = _flax_path(name)

        def leaf(*parts: str) -> str:
            return "/".join((base,) + parts if base else parts)
        if isinstance(module, Dense):
            take(leaf("Dense_0", "kernel"), module.weight, transpose=True)
            if module.bias is not None:
                take(leaf("Dense_0", "bias"), module.bias)
        elif isinstance(module, RelationalDense):
            take(leaf("kernel"), module.kernel)
            if module.bias is not None:
                take(leaf("bias"), module.bias)
        elif isinstance(module, OptionalInputEmbedding):
            take(leaf("Embed_0", "embedding"), module.weight)
        elif isinstance(module, GraphLayerNorm):
            for pname, p in module.named_parameters(recurse=False):
                take(leaf("LayerNorm_0", pname), p)
        else:
            for pname, p in module.named_parameters(recurse=False):
                take(leaf(pname), p)
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"flax parameters with no port counterpart: {left}")
    unfilled = [n for n, p in model.named_parameters() if id(p) not in filled]
    if unfilled:
        raise KeyError(f"port parameters with no flax counterpart: {unfilled}")
    return model
