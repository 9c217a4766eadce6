"""Readout pools; counterpart of ``gcnn_keras_tpu/layers/pool/`` (its
``Set2Set``; ``PoolingLocalEdgesLSTM`` and the top-k pools are not ported
yet)."""
from .set2set import Set2Set

__all__ = ["Set2Set"]
