"""GNN-FiLM; counterpart of ``gcnn_keras_tpu/models/gnnfilm.py``.

Each of ``depth`` layers sends ``gamma * (W_r h_j) + beta`` along every
edge, ``W_r`` (``w_rel_i``) by the edge's relation and ``gamma``,
``beta`` (``gamma_i``, ``beta_i``, sigmoid by default) computed from the
receiver by relation, sums the messages onto the receivers and then
activates; then the output MLP, on the nodes mean-pooled per graph for
``output_embedding="graph"``. Relations as ``models/rgcn.py`` takes them
(20 by default: the per-relation loop of ``RelationalDense``).
``in_features``: the width of float node features (None: integer node
numbers).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import gather_nodes, pool_edges_to_nodes
from ..layers.mlp import MLP, RelationalDense
from ..ops.activ import get_activation
from ..utils.devices import DeviceLike, resolve_device
from .common import embed_input, input_embedding
from .registry import update_model_kwargs
from .rgcn import edge_relations, graph_readout

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64}},
    dense_relation_kwargs={"units": 64, "num_relations": 20},
    dense_modulation_kwargs={"units": 64, "num_relations": 20, "activation": "sigmoid"},
    activation_kwargs={"activation": "swish"},
    depth=5,
    output_embedding="graph",
    output_mlp={"units": [64, 1], "activation": ["relu", "linear"]},
    in_features=None,
)


class GNNFilm(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        self._act = get_activation(cfg["activation_kwargs"]["activation"])
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        rel, mod = cfg["dense_relation_kwargs"], cfg["dense_modulation_kwargs"]
        mod_act = mod.get("activation", "sigmoid")
        for i in range(cfg["depth"]):
            self.add_module(f"w_rel_{i}", RelationalDense(
                width, rel["units"], rel["num_relations"],
                activation=rel.get("activation", "linear"), generator=generator))
            for name in ("gamma", "beta"):
                self.add_module(f"{name}_{i}", RelationalDense(
                    width, mod["units"], mod["num_relations"], activation=mod_act,
                    generator=generator))
            width = rel["units"]
        out = cfg["output_mlp"]
        self.out_mlp = MLP(width, out["units"], activation=out["activation"],
                           generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = embed_input(x, self.embedding, cfg["in_features"])
        rel = edge_relations(batch)
        for i in range(cfg["depth"]):
            msg = getattr(self, f"w_rel_{i}")(gather_nodes(n, batch.senders), rel)
            hi = gather_nodes(n, batch.receivers)
            gamma = getattr(self, f"gamma_{i}")(hi, rel)
            beta = getattr(self, f"beta_{i}")(hi, rel)
            # modulate, pool, then activate
            n = self._act(pool_edges_to_nodes(batch, gamma * msg + beta))
        return {"output": self.out_mlp(graph_readout(cfg, batch, n))}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> GNNFilm:
    """GNN-FiLM with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return GNNFilm(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
