"""EGNN, the E(n)-equivariant GNN; counterpart of
``gcnn_keras_tpu/models/egnn.py``.

Each of ``depth`` layers forms the messages ``m_ij = edge_mlp_i([h_i, h_j,
|x_i - x_j|, e_ij])`` (optionally gated by ``att_i``), moves the
coordinates by the mean over each receiver's edges of ``(x_i - x_j)
coord_mlp_i(m_ij)`` and updates ``h`` by ``node_mlp_i([h, sum_j m_ij])``
(with a skip). Both pools onto the receivers run on the sorted segment-sum
kernel, the mean with its ``bincount``; the readout sums per graph
(kernel #1), then ``out_mlp``. The last layer's coordinate update is
computed and not read, as in the JAX model (its ``coord_mlp`` loads with
the tree).

Inputs: ``in_features`` as in ``models/sage.py`` (None: integer node
numbers, embedded); with ``use_edge_attributes`` the batch's float
``edge_attributes`` of width ``edge_in_features`` join the message input
(0, the default: the batches have none; a batch that disagrees raises).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import gather_nodes, pool_edges_to_nodes, pool_nodes_to_graph
from ..layers.mlp import MLP, Dense
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding, mlp_width
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 95, "output_dim": 64}},
    depth=4,
    node_mlp_initialize=None,
    use_edge_attributes=True,
    edge_mlp_kwargs={"units": [64, 64], "activation": ["swish", "linear"]},
    edge_attention_kwargs=None,
    use_normalized_difference=False,
    expand_distance_kwargs=None,
    coord_mlp_kwargs={"units": [64, 1], "activation": ["swish", "linear"]},
    pooling_coord_kwargs={"pooling_method": "mean"},
    pooling_edge_kwargs={"pooling_method": "sum"},
    node_normalize_kwargs=None,
    node_mlp_kwargs={"units": [64, 64], "activation": ["swish", "linear"]},
    use_skip=True,
    node_pooling_kwargs={"pooling_method": "sum"},
    output_embedding="graph",
    output_mlp={"units": [64, 1], "activation": ["swish", "linear"]},
    in_features=None,
    edge_in_features=0,
)


def _mlp(in_features: int, kw: Dict[str, Any], generator) -> MLP:
    return MLP(in_features, kw["units"], activation=kw["activation"], generator=generator)


class EGNN(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        self.embedding, h_width = input_embedding(cfg["input_embedding"]["node"],
                                                  cfg["in_features"], generator)
        self.node_init = None
        if cfg.get("node_mlp_initialize"):
            self.node_init = _mlp(h_width, cfg["node_mlp_initialize"], generator)
            h_width = self.node_init.out_features
        self.edge_width = cfg["edge_in_features"] if cfg["use_edge_attributes"] else 0
        m_width = mlp_width(cfg["edge_mlp_kwargs"]["units"])
        for i in range(cfg["depth"]):
            self.add_module(f"edge_mlp_{i}", _mlp(2 * h_width + 1 + self.edge_width,
                                                  cfg["edge_mlp_kwargs"], generator))
            if cfg.get("edge_attention_kwargs"):
                self.add_module(f"att_{i}", Dense(m_width, 1, activation="sigmoid",
                                                  generator=generator))
            self.add_module(f"coord_mlp_{i}", _mlp(m_width, cfg["coord_mlp_kwargs"],
                                                   generator))
            self.add_module(f"node_mlp_{i}", _mlp(h_width + m_width, cfg["node_mlp_kwargs"],
                                                  generator))
            h_width = mlp_width(cfg["node_mlp_kwargs"]["units"])
        self.out_mlp = _mlp(h_width, cfg["output_mlp"], generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        zx = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        h = embed_input(zx, self.embedding, cfg["in_features"])
        if self.node_init is not None:
            h = self.node_init(h)
        x = batch.nodes["node_coordinates"]
        ed = edge_input(batch, None, cfg["edge_in_features"]) \
            if cfg["use_edge_attributes"] else None
        emask = batch.edge_mask[:, None]
        for i in range(cfg["depth"]):
            hi = gather_nodes(h, batch.receivers)
            hj = gather_nodes(h, batch.senders)
            diff = x[batch.receivers] - x[batch.senders]
            d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
            # the euclidean norm, guarded as the JAX model guards it
            norm = torch.where(d2 > 1e-12, torch.sqrt(d2.clamp_min(1e-12)),
                               torch.full_like(d2, 1e-6))
            feats = [hi, hj, norm] + ([] if ed is None else [ed])
            m_ij = getattr(self, f"edge_mlp_{i}")(torch.cat(feats, dim=-1))
            if cfg.get("edge_attention_kwargs"):
                m_ij = m_ij * getattr(self, f"att_{i}")(m_ij)
            m_ij = m_ij * emask.to(m_ij.dtype)
            phi_x = getattr(self, f"coord_mlp_{i}")(m_ij)
            if cfg["use_normalized_difference"]:
                diff = diff / torch.sqrt(d2.clamp_min(1e-12))
            x = x + pool_edges_to_nodes(batch, diff * phi_x, **cfg["pooling_coord_kwargs"])
            agg = pool_edges_to_nodes(batch, m_ij, **cfg["pooling_edge_kwargs"])
            hu = getattr(self, f"node_mlp_{i}")(torch.cat([h, agg], dim=-1))
            h = h + hu if cfg["use_skip"] else hu
        if cfg["output_embedding"] == "graph":
            h = h * batch.node_mask[:, None].to(h.dtype)
            h = pool_nodes_to_graph(batch, h, **cfg["node_pooling_kwargs"])
        return {"output": self.out_mlp(h)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> EGNN:
    """EGNN with the JAX package's defaults updated by ``kwargs``, weights
    drawn from ``generator`` (seed 0 if None) on the CPU, moved to
    ``device`` (the CUDA card unless ``"cpu"``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return EGNN(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
