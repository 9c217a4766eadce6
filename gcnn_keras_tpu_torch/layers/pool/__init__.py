"""Readout pools; counterpart of ``gcnn_keras_tpu/layers/pool/``: its
``Set2Set``, ``PoolingLocalEdgesLSTM`` and the top-k pools
(``PoolingTopK``, ``UnPoolingTopK``, ``AdjacencyPower``)."""
from .lstm import PoolingLocalEdgesLSTM
from .set2set import Set2Set
from .topk import AdjacencyPower, PoolingTopK, UnPoolingTopK

__all__ = ["AdjacencyPower", "PoolingLocalEdgesLSTM", "PoolingTopK", "Set2Set",
           "UnPoolingTopK"]
