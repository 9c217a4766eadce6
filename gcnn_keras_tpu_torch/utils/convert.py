"""Load the JAX package's flax parameters into the port's modules.

The port names its submodules after the flax parameter tree, so a module at
``interaction_0.cfconv.filter_1`` takes ``interaction_0/cfconv/filter_1``.
Four node types carry weights in their own layout:

- ``Dense``: ``<path>/Dense_0/kernel`` (in, out), transposed into
  ``weight`` (out, in), and ``<path>/Dense_0/bias``;
- ``RelationalDense``: ``<path>/kernel`` (R, in, out) and ``<path>/bias``
  (R, out), as they are;
- ``OptionalInputEmbedding``: ``<path>/Embed_0/embedding``; its flax name
  is ``OptionalInputEmbedding_0`` where the port says ``embedding``, and
  ``OptionalInputEmbedding_1`` (the zoo's edge input, called second) where
  it says ``edge_embedding``;
- ``GraphLayerNorm``: ``<path>/LayerNorm_0/scale`` and
  ``<path>/LayerNorm_0/bias``.

Any other module's own parameters are bare flax leaves of the same name,
``<path>/<name>``, as they are: the per-element tables ``hardness_j`` and
``sigma`` of the HDNNP4th electrostatics, ``scale`` and ``bias`` of
``GraphBatchNorm``, the keras-layout ``kernel``, ``recurrent_kernel`` and
``bias`` of the GRUs (``KerasGRUCellUpdate``, ``KerasGRUSequencePooling``)
and of ``Set2Set``'s LSTM, and the ``kernel`` and ``bias`` of the flax
``nn.Dense`` leaves of ``GRUUpdate``'s cell (``<path>/GRUCell_0/ir/kernel``
...: the port names its submodules after them). MEGAN's heads are port
``Dense`` modules named as the flax ones, ``att_i/head_k_linear``. The
flax ``nn.Embed`` tables of DimeNet++ and MXMNet are bare leaves too,
``embed_z/embedding`` (``models/dimenet_pp.py`` ``NodeEmbedding``). A
module called at two sites (MXMNet's ``x_edge_mlp``, ``linear`` and
``h_mlp``) is one flax leaf and one port parameter: ``named_modules``
gives it once. ``flax_leaf_names`` gives each port parameter's flax path.

``GraphBatchNorm``'s running ``mean`` and ``var`` are the flax
``batch_stats`` collection, ``batch_stats/<path>/mean`` and ``/var``; they
load into the module's buffers of the same names.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..layers.mlp import Dense, RelationalDense
from ..layers.norm import GraphBatchNorm, GraphLayerNorm
from ..models.common import OptionalInputEmbedding

_FLAX_NAMES = {"embedding": "OptionalInputEmbedding_0",
               "edge_embedding": "OptionalInputEmbedding_1"}


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


def _flax_leaves(model: nn.Module) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    """``(flax leaf path, port parameter, transposed)`` of each parameter
    of ``model``, in module order."""
    for name, module in model.named_modules():
        base = _flax_path(name)

        def leaf(*parts: str) -> str:
            return "/".join((base,) + parts if base else parts)
        if isinstance(module, Dense):
            yield leaf("Dense_0", "kernel"), module.weight, True
            if module.bias is not None:
                yield leaf("Dense_0", "bias"), module.bias, False
        elif isinstance(module, RelationalDense):
            yield leaf("kernel"), module.kernel, False
            if module.bias is not None:
                yield leaf("bias"), module.bias, False
        elif isinstance(module, OptionalInputEmbedding):
            yield leaf("Embed_0", "embedding"), module.weight, False
        elif isinstance(module, GraphLayerNorm):
            for pname, p in module.named_parameters(recurse=False):
                yield leaf("LayerNorm_0", pname), p, False
        else:
            for pname, p in module.named_parameters(recurse=False):
                yield leaf(pname), p, False


def flax_leaf_names(model: nn.Module) -> Dict[str, str]:
    """Each parameter's name in ``model.named_parameters()`` -> its flax
    leaf path (under the top-level ``"params"``)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: key for key, p, _ in _flax_leaves(model)}


def _batch_stats(model: nn.Module) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    """``(flax batch_stats path, port buffer, False)`` of each running
    statistic of ``model``'s ``GraphBatchNorm`` modules."""
    for name, module in model.named_modules():
        if isinstance(module, GraphBatchNorm):
            base = _flax_path(name)
            for bname in ("mean", "var"):
                yield "/".join(p for p in (base, bname) if p), getattr(module, bname), False


def _copy_leaves(flat: Dict[str, np.ndarray],
                 leaves: Iterator[Tuple[str, torch.Tensor, bool]], what: str) -> set:
    """Copy each leaf of ``flat`` into its port tensor; raises if a port
    tensor has no flax leaf, a flax leaf is left over, or a shape differs.
    Returns the ids of the tensors filled."""
    used, filled = set(), set()
    for key, target, transpose in leaves:
        if key not in flat:
            raise KeyError(f"flax {what} {key!r} missing")
        arr = flat[key].T if transpose else flat[key]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{key}: flax shape {arr.shape} vs port "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.tensor(arr))
        used.add(key)
        filled.add(id(target))
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"flax {what}s with no port counterpart: {left}")
    return filled


def params_from_jax(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a flax variable tree (nested dict of numpy arrays: the
    ``"params"`` collection, or the parameters alone, and the
    ``"batch_stats"`` collection where the model has ``GraphBatchNorm``
    modules) into ``model`` in place. Raises if a port parameter or running
    statistic has no flax leaf, a flax leaf is left over, or a shape
    differs."""
    params = tree.get("params", {k: v for k, v in tree.items() if k != "batch_stats"})
    _copy_leaves(_flatten(tree.get("batch_stats", {})), _batch_stats(model),
                 "batch_stats leaf")
    filled = _copy_leaves(_flatten(params), _flax_leaves(model), "parameter")
    unfilled = [n for n, p in model.named_parameters() if id(p) not in filled]
    if unfilled:
        raise KeyError(f"port parameters with no flax counterpart: {unfilled}")
    return model
