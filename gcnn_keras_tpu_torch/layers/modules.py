"""The kgcnn basic-module names; counterpart of
``gcnn_keras_tpu/layers/modules.py``: kgcnn's 'Lazy' ragged arithmetic is
plain tensor arithmetic on flat batches. ``Dense`` (and its kgcnn name
``DenseEmbedding``) is the port's, which takes its input width first."""
from __future__ import annotations

import torch

from ..models.common import OptionalInputEmbedding  # noqa: F401
from ..ops.activ import get_activation
from .mlp import Dense, Dense as DenseEmbedding  # noqa: F401


def Activation(activation):
    fn = get_activation(activation)
    return lambda x: fn(x)


def LazyAdd():
    return lambda inputs: sum(inputs[1:], inputs[0])


def LazySubtract():
    return lambda inputs: inputs[0] - inputs[1]


def LazyMultiply():
    def call(inputs):
        out = inputs[0]
        for x in inputs[1:]:
            out = out * x
        return out
    return call


def LazyAverage():
    return lambda inputs: sum(inputs[1:], inputs[0]) / len(inputs)


def LazyConcatenate(axis=-1):
    return lambda inputs: torch.cat(inputs, dim=axis)


def ExpandDims(axis=-1):
    return lambda x: torch.unsqueeze(x, axis)


def ZerosLike():
    return lambda x: torch.zeros_like(x)
