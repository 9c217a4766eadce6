"""The kgcnn gather names; counterpart of ``gcnn_keras_tpu/layers/gather.py``.
Each name builds a function of ``(batch, nodes)``; the gathers are plain
(``index_select``), as the JAX package's."""
from __future__ import annotations

import torch

from .aggr import gather_nodes, gather_state


def GatherNodes(split_indices=(0, 1), concat_axis=-1):
    """Both edge ends (0: receiver, 1: sender), concatenated along
    ``concat_axis`` (None: the list)."""
    def call(batch, nodes):
        parts = [gather_nodes(nodes, batch.receivers if idx == 0 else batch.senders)
                 for idx in split_indices]
        return torch.cat(parts, dim=concat_axis) if concat_axis is not None else parts
    return call


def GatherNodesSelection(selection_index, index_source=None):
    """The node features at the selected index columns, a list.

    ``index_source``: ``"edges"`` (column 0 the receiver, 1 the sender),
    ``"angles"`` (the columns of the (A, 3) angle triples), or None: angles
    where the batch has them and the selection needs them (a column >= 2,
    or all three), for every selected column alike (a [0, 2] selection reads
    angle columns 0 and 2), else edges."""
    def call(batch, nodes):
        sel = list(selection_index) if isinstance(selection_index, (list, tuple)) \
            else [selection_index]
        source = index_source
        if source is None:
            wants_angles = any(i >= 2 for i in sel) or len(sel) == 3
            source = "angles" if (batch.angles is not None and wants_angles) else "edges"
        if source == "angles":
            if batch.angles is None:
                raise ValueError("GatherNodesSelection(index_source='angles') needs "
                                 "batch.angles")
            return [gather_nodes(nodes, batch.angles[:, i]) for i in sel]
        idx_arrays = {0: batch.receivers, 1: batch.senders}
        return [gather_nodes(nodes, idx_arrays[i]) for i in sel]
    return call


def GatherNodesIngoing():
    """The receivers' features."""
    def call(batch, nodes):
        return gather_nodes(nodes, batch.receivers)
    return call


def GatherNodesOutgoing():
    """The senders' features."""
    def call(batch, nodes):
        return gather_nodes(nodes, batch.senders)
    return call


def GatherState():
    """A per-graph state broadcast to the nodes."""
    def call(batch, state):
        return gather_state(state, batch)
    return call
