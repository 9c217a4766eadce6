"""CMPNN, communicative message passing; counterpart of
``gcnn_keras_tpu/models/cmpnn.py``.

``node_init`` on the nodes and ``edge_init`` on the edge features alone;
then ``depth - 1`` rounds: each node adds the product of the sum and the
max of its incoming edge messages (the booster), and each directed edge
j -> i takes ``edge_act(edge_dense_k(n_j - h_{i->j}) + h0_e)``, the reverse
edge's message from ``edge_pair_index``. A last booster ``m`` goes with the
nodes and their initial state into ``node_out`` (``[m || n || n0]``); for
``output_embedding="graph"`` the nodes are read out per graph by the keras
GRU sequence pool ``gru_final`` (``use_final_gru``, the default; else
pooled by ``pooling_kwargs``), then the output MLP. The sums onto the nodes
are the sorted segment-sum kernel, the maxima ``scatter_reduce``; the
readout launches no kernel.

The batch needs ``batch_graphs(compute_reverse_edges=True)``, as DMPNN
(``ValueError`` without). The JAX model feeds its edge features to a Dense
as they are, so they are floats: ``edge_in_features`` is their width (0,
the default: batches without them, one zero per edge, as in JAX); None
raises. ``in_features`` as in ``models/sage.py`` (None: integer node
numbers, embedded).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import gather_nodes, pool_edges_to_nodes, pool_nodes_to_graph
from ..layers.conv.basic import KerasGRUSequencePooling
from ..layers.mlp import MLP, Dense
from ..ops.activ import get_activation
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding
from .dmpnn import reverse_edges
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 5, "output_dim": 64}},
    node_initialize={"units": 300, "activation": "relu"},
    edge_initialize={"units": 300, "activation": "relu"},
    edge_dense={"units": 300, "activation": "linear"},
    edge_activation={"activation": "relu"},
    node_dense={"units": 300, "activation": "linear"},
    verbose=10, depth=5,
    dropout=None,
    use_final_gru=True,
    pooling_gru={"units": 300},
    pooling_kwargs={"pooling_method": "sum"},
    output_embedding="graph",
    output_mlp={"units": [300, 100, 1], "activation": ["relu", "relu", "linear"]},
    in_features=None,
    edge_in_features=0,
)


class CMPNN(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        if cfg["edge_in_features"] is None:
            raise ValueError("CMPNN takes float edge_attributes: give their width "
                             "(edge_in_features; 0 for batches without them)")
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        units = cfg["node_initialize"]["units"]
        e_units = cfg["edge_initialize"]["units"]
        self.node_init = Dense(width, units, activation=cfg["node_initialize"]["activation"],
                               generator=generator)
        self.edge_init = Dense(cfg["edge_in_features"] or 1, e_units,
                               activation=cfg["edge_initialize"]["activation"],
                               generator=generator)
        for i in range(cfg["depth"] - 1):
            self.add_module(f"edge_dense_{i}", Dense(
                units, cfg["edge_dense"]["units"], activation=cfg["edge_dense"]["activation"],
                generator=generator))
        self._edge_act = get_activation(cfg.get("edge_activation",
                                                {"activation": "relu"})["activation"])
        self.node_out = Dense(e_units + 2 * units, cfg["node_dense"]["units"],
                              activation=cfg["node_dense"]["activation"], generator=generator)
        width = cfg["node_dense"]["units"]
        self.gru_final = None
        if cfg["output_embedding"] == "graph" and cfg["use_final_gru"]:
            self.gru_final = KerasGRUSequencePooling(width, cfg["pooling_gru"]["units"],
                                                     generator=generator)
            width = cfg["pooling_gru"]["units"]
        self.out_mlp = MLP(width, cfg["output_mlp"]["units"],
                           activation=cfg["output_mlp"]["activation"], generator=generator)

    def _booster(self, batch: GraphBatch, h_e: Tensor) -> Tensor:
        """The product of the sum and the max of each node's incoming
        messages."""
        return pool_edges_to_nodes(batch, h_e, **self.config["pooling_kwargs"]) \
            * pool_edges_to_nodes(batch, h_e, mode="max")

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        pair = reverse_edges(batch, "CMPNN").long()
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = self.node_init(embed_input(x, self.embedding, cfg["in_features"]))
        n0 = n
        ed = edge_input(batch, None, cfg["edge_in_features"])
        if ed is None:
            ed = n.new_zeros(batch.n_edge, 1)
        h_e = he0 = self.edge_init(ed)
        for i in range(cfg["depth"] - 1):
            n = n + self._booster(batch, h_e)
            msg = gather_nodes(n, batch.senders) - h_e.index_select(0, pair)
            h_e = self._edge_act(getattr(self, f"edge_dense_{i}")(msg) + he0)
        n = self.node_out(torch.cat([self._booster(batch, h_e), n, n0], dim=-1))
        if cfg["output_embedding"] == "graph":
            n = n * batch.node_mask[:, None].to(n.dtype)
            n = self.gru_final(batch, n) if self.gru_final is not None else \
                pool_nodes_to_graph(batch, n, **cfg["pooling_kwargs"])
        return {"output": self.out_mlp(n)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> CMPNN:
    """CMPNN with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return CMPNN(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
