"""INorp, the interaction network; counterpart of
``gcnn_keras_tpu/models/inorp.py``.

Each of ``depth`` layers runs ``edge_mlp_i`` on ``[n_j, n_i, e_ij]``, pools
its output onto the receivers (``pooling_args``, sum by default) and runs
``node_mlp_i`` on ``[n, pooled, u]``, ``u`` the node's graph state; then
the output MLP, on the nodes pooled per graph by ``pooling_args`` for
``output_embedding="graph"``.

Inputs and widths at build: ``in_features`` and ``edge_in_features`` as
``models/sage.py`` takes them (without edge attributes, ``edge_in_features``
0, the edges carry 8 zeros, as in the JAX model); ``graph_in_features``
the width of ``globals['graph_attributes']`` ``(G, k)``, taken as floats
(0, the default: batches without them, and 8 zeros per graph). The JAX
model embeds neither graph attributes nor anything by
``input_embedding["graph"]``; neither does this one. ``use_set2set=True``
reads the graph out by ``Set2Set(**set2set_args)`` (unsorted sums,
``index_add_``, as in JAX), which needs the nodes as wide as its
``channels``: the last of ``node_mlp_args["units"]``. The defaults (50 and
32) do not agree, so the port raises ``ValueError`` when built, where the
JAX model fails at its first call.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import gather_nodes, gather_state, pool_edges_to_nodes, pool_nodes_to_graph
from ..layers.mlp import MLP
from ..layers.pool.set2set import Set2Set
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding, mlp_width
from .registry import update_model_kwargs

Tensor = torch.Tensor

# the zeros that stand in for absent edge or graph attributes, per row
ABSENT_WIDTH = 8

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 15, "output_dim": 64},
                     "graph": {"input_dim": 32, "output_dim": 32}},
    set2set_args={"channels": 32, "T": 3},
    node_mlp_args={"units": [100, 50], "activation": ["relu", "linear"]},
    edge_mlp_args={"units": [100, 100, 100, 100, 50], "activation": "relu"},
    pooling_args={"pooling_method": "sum"},
    depth=3, use_set2set=False,
    output_embedding="graph",
    output_mlp={"units": [1], "activation": ["linear"]},
    in_features=None,
    edge_in_features=None,
    graph_in_features=0,
)


class INorp(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unknown output_embedding {cfg['output_embedding']}")
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        self.edge_embedding, e_width = input_embedding(
            cfg["input_embedding"].get("edge", {"input_dim": 15, "output_dim": 64}),
            cfg["edge_in_features"], generator)
        e_width = e_width or ABSENT_WIDTH
        g_width = cfg["graph_in_features"] or ABSENT_WIDTH
        edge, node, out = cfg["edge_mlp_args"], cfg["node_mlp_args"], cfg["output_mlp"]
        for i in range(cfg["depth"]):
            self.add_module(f"edge_mlp_{i}", MLP(2 * width + e_width, edge["units"],
                                                 activation=edge["activation"],
                                                 generator=generator))
            self.add_module(f"node_mlp_{i}", MLP(width + mlp_width(edge["units"]) + g_width,
                                                 node["units"], activation=node["activation"],
                                                 generator=generator))
            width = mlp_width(node["units"])
        self.set2set = None
        if cfg["use_set2set"] and cfg["output_embedding"] == "graph":
            channels = cfg["set2set_args"]["channels"]
            if width != channels:
                raise ValueError(f"INorp(use_set2set=True): Set2Set reads nodes as wide as "
                                 f"set2set_args' channels ({channels}); node_mlp_args gives "
                                 f"{width}")
            self.set2set = Set2Set(**cfg["set2set_args"], generator=generator)
            width = 2 * channels
        self.out_mlp = MLP(width, out["units"], activation=out["activation"],
                           generator=generator)

    def _graph_state(self, batch: GraphBatch, dtype: torch.dtype) -> Tensor:
        us, k = batch.globals.get("graph_attributes"), self.config["graph_in_features"]
        if (us is None) != (k == 0) or (us is not None and (us.dim() != 2 or us.shape[1] != k)):
            raise ValueError(f"the model was built with graph_in_features={k}, got "
                             f"graph_attributes {None if us is None else tuple(us.shape)} "
                             "(0 builds it for batches without them)")
        if us is None:
            return torch.zeros(batch.n_graphs, ABSENT_WIDTH, dtype=dtype,
                               device=batch.graph_id.device)
        return us.to(dtype)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = embed_input(x, self.embedding, cfg["in_features"])
        ed = edge_input(batch, self.edge_embedding, cfg["edge_in_features"])
        if ed is None:
            ed = n.new_zeros(batch.n_edge, ABSENT_WIDTH)
        us = gather_state(self._graph_state(batch, n.dtype), batch)
        for i in range(cfg["depth"]):
            # [outgoing, ingoing, edge], the reference's order
            eu = torch.cat([gather_nodes(n, batch.senders), gather_nodes(n, batch.receivers),
                            ed], dim=-1)
            eu = getattr(self, f"edge_mlp_{i}")(eu)
            pooled = pool_edges_to_nodes(batch, eu, **cfg["pooling_args"])
            n = getattr(self, f"node_mlp_{i}")(torch.cat([n, pooled, us], dim=-1))
        if cfg["output_embedding"] == "graph":
            n = n * batch.node_mask[:, None].to(n.dtype)
            # the readout pools by pooling_args too
            n = self.set2set(batch, n) if self.set2set is not None else \
                pool_nodes_to_graph(batch, n, **cfg["pooling_args"])
        return {"output": self.out_mlp(n)}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> INorp:
    """INorp with the JAX package's defaults updated by ``kwargs``, as
    ``models/gin.py`` ``make_model`` builds GIN."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return INorp(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
