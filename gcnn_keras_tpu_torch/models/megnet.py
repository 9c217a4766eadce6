"""MEGNet; counterpart of ``gcnn_keras_tpu/models/megnet.py``
(``make_model``, ``make_crystal_model``: one model).

Nodes, edges and the graph state each pass a dense block
(``node_ff_i``, ``edge_ff_i``, ``state_ff_i``; from the second block on
with ``has_ff``); each ``MEGnetBlock`` (kgcnn's ``megnet_conv.py``)
updates the edges from ``[n_i, n_j, e, u]`` (``edge_mlp``), the nodes from
``[mean of their edges, n, u]`` (``node_mlp``) and the state from ``[mean
of the graph's edges, mean of its nodes, u]`` (``env_mlp``), each MLP's
last layer linear; the blocks add their input before the dense block
back. The means onto the receivers and the graphs run on kernel #1 (each
with a ``bincount``); the edges' mean per graph is unsorted
(``index_add_``), as in JAX. The readout projects nodes and edges to the
``Set2Set`` channels (``set2set_proj_nodes``, ``set2set_proj_edges``) and
reads each by its own ``Set2Set`` (the edges by ``edge_graph_id``), or
without ``use_set2set`` takes their means; then ``out_mlp`` on
``[nodes, edges, state]``.

Edges: their lengths (``edge_distances``: through the lattice images of a
periodic batch) in a Gaussian basis, or with ``make_distance=False`` the
batch's float ``edge_attributes`` (``edge_in_features``). The state is the
batch's float ``globals['graph_attributes']`` ``(G, k)`` for
``graph_in_features`` k, or 16 zeros a graph for 0 (the default), as in
the JAX model; a batch that disagrees raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import (gather_nodes, gather_state, pool_edges_to_graph,
                           pool_edges_to_nodes, pool_nodes_to_graph)
from ..layers.geometry import edge_distances, gauss_basis
from ..layers.mlp import MLP, Dense
from ..layers.pool.set2set import Set2Set
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, embed_input, input_embedding, mlp_width
from .registry import update_model_kwargs

Tensor = torch.Tensor

# the state of a batch without graph attributes: zeros of this width
ABSENT_STATE_WIDTH = 16

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "graph": {"input_dim": 100, "output_dim": 64}},
    make_distance=True, expand_distance=True,
    gauss_args={"bins": 20, "distance_max": 4.0, "offset": 0.0, "sigma": 0.4},
    meg_block_args={"node_embed": [64, 32, 32], "edge_embed": [64, 32, 32],
                    "env_embed": [64, 32, 32], "activation": "softplus2"},
    set2set_args={"channels": 16, "T": 3, "pooling_method": "sum",
                  "init_qstar": "0"},
    node_ff_args={"units": [64, 32], "activation": "softplus2"},
    edge_ff_args={"units": [64, 32], "activation": "softplus2"},
    state_ff_args={"units": [64, 32], "activation": "softplus2"},
    nblocks=3,
    has_ff=True,
    dropout=None,
    use_set2set=True,
    output_embedding="graph",
    output_mlp={"units": [32, 16, 1], "activation": ["softplus2", "softplus2", "linear"]},
    in_features=None,
    edge_in_features=0,
    graph_in_features=0,
)


class MEGnetBlock(nn.Module):
    def __init__(self, n_width: int, e_width: int, u_width: int,
                 node_embed=(64, 32, 32), edge_embed=(64, 32, 32), env_embed=(64, 32, 32),
                 activation: Any = "softplus2", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge_mlp = MLP(2 * n_width + e_width + u_width, list(edge_embed),
                            activation=activation, last_linear=True, generator=generator)
        ep = mlp_width(list(edge_embed))
        self.node_mlp = MLP(ep + n_width + u_width, list(node_embed), activation=activation,
                            last_linear=True, generator=generator)
        self.env_mlp = MLP(ep + mlp_width(list(node_embed)) + u_width, list(env_embed),
                           activation=activation, last_linear=True, generator=generator)

    def forward(self, batch: GraphBatch, n: Tensor, e: Tensor, u: Tensor):
        ue = u.index_select(0, batch.edge_graph_id)
        ep = self.edge_mlp(torch.cat([gather_nodes(n, batch.receivers),
                                      gather_nodes(n, batch.senders), e, ue], dim=-1))
        eu = pool_edges_to_nodes(batch, ep, mode="mean")
        np_ = self.node_mlp(torch.cat([eu, n, gather_state(u, batch)], dim=-1))
        uc = torch.cat([pool_edges_to_graph(batch, ep, mode="mean"),
                        pool_nodes_to_graph(batch, np_, mode="mean"), u], dim=-1)
        return np_, ep, self.env_mlp(uc)


class Megnet(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        self.embedding, n_width = input_embedding(cfg["input_embedding"]["node"],
                                                  cfg["in_features"], generator)
        if cfg["make_distance"]:
            e_width = cfg["gauss_args"]["bins"] if cfg["expand_distance"] else 1
        elif not cfg["edge_in_features"]:
            raise ValueError("Megnet without make_distance reads float edge_attributes: "
                             "give their width (edge_in_features)")
        else:
            e_width = cfg["edge_in_features"]
        u_width = cfg["graph_in_features"] or ABSENT_STATE_WIDTH
        widths = {"node": n_width, "edge": e_width, "state": u_width}
        for kind in ("node", "edge", "state"):
            ff = cfg[f"{kind}_ff_args"]
            self.add_module(f"{kind}_ff_0", MLP(widths[kind], ff["units"],
                                                activation=ff["activation"],
                                                generator=generator))
            widths[kind] = mlp_width(ff["units"])
        block = dict(cfg["meg_block_args"])
        for i in range(cfg["nblocks"]):
            if cfg["has_ff"] and i > 0:
                for kind in ("node", "edge", "state"):
                    ff = cfg[f"{kind}_ff_args"]
                    self.add_module(f"{kind}_ff_{i}", MLP(widths[kind], ff["units"],
                                                          activation=ff["activation"],
                                                          generator=generator))
            # the block's input: the dense blocks' outputs (of the widths of
            # their units) or the residual stream itself, as wide
            self.add_module(f"block_{i}", MEGnetBlock(widths["node"], widths["edge"],
                                                      widths["state"], **block,
                                                      generator=generator))
        self.set2set_nodes = None
        if cfg["use_set2set"]:
            channels = cfg["set2set_args"]["channels"]
            self.set2set_proj_nodes = Dense(widths["node"], channels, generator=generator)
            self.set2set_proj_edges = Dense(widths["edge"], channels, generator=generator)
            self.set2set_nodes = Set2Set(**cfg["set2set_args"], generator=generator)
            self.set2set_edges = Set2Set(**cfg["set2set_args"], generator=generator)
            read = 4 * channels
        else:
            read = widths["node"] + widths["edge"]
        out = cfg["output_mlp"]
        self.out_mlp = MLP(read + widths["state"], out["units"], activation=out["activation"],
                           generator=generator)

    def _state(self, batch: GraphBatch, dtype: torch.dtype) -> Tensor:
        us, k = batch.globals.get("graph_attributes"), self.config["graph_in_features"]
        if (us is None) != (k == 0) or (us is not None and (us.dim() != 2 or us.shape[1] != k)):
            raise ValueError(f"the model was built with graph_in_features={k}, got "
                             f"graph_attributes {None if us is None else tuple(us.shape)} "
                             "(0 builds it for batches without them)")
        if us is None:
            return torch.zeros(batch.n_graphs, ABSENT_STATE_WIDTH, dtype=dtype,
                               device=batch.graph_id.device)
        return us.to(dtype)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = embed_input(x, self.embedding, cfg["in_features"])
        if cfg["make_distance"]:
            ed = edge_distances(batch)
            if cfg["expand_distance"]:
                ed = gauss_basis(ed, **cfg["gauss_args"])
        else:
            ed = edge_input(batch, None, cfg["edge_in_features"])
        ed = ed * batch.edge_mask[:, None].to(ed.dtype)
        vp, ep, up = self.node_ff_0(n), self.edge_ff_0(ed), \
            self.state_ff_0(self._state(batch, n.dtype))
        for i in range(cfg["nblocks"]):
            if cfg["has_ff"] and i > 0:
                v1, e1, u1 = (getattr(self, f"{kind}_ff_{i}")(t) for kind, t in
                              (("node", vp), ("edge", ep), ("state", up)))
            else:
                v1, e1, u1 = vp, ep, up
            v2, e2, u2 = getattr(self, f"block_{i}")(batch, v1, e1, u1)
            # the residual adds the value before the dense block
            vp, ep, up = v2 + vp, e2 + ep, u2 + up
        if self.set2set_nodes is not None:
            vp_p = self.set2set_proj_nodes(vp) * batch.node_mask[:, None].to(vp.dtype)
            ep_p = self.set2set_proj_edges(ep) * batch.edge_mask[:, None].to(ep.dtype)
            node_read = self.set2set_nodes(batch, vp_p)
            edge_read = self.set2set_edges(batch, ep_p, segment_ids=batch.edge_graph_id,
                                           num_segments=batch.n_graphs, mask=batch.edge_mask)
        else:
            node_read = pool_nodes_to_graph(batch, vp, mode="mean")
            edge_read = pool_edges_to_graph(batch, ep, mode="mean")
        return {"output": self.out_mlp(torch.cat([node_read, edge_read, up], dim=-1))}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> Megnet:
    """MEGNet with the JAX package's defaults updated by ``kwargs``, weights
    drawn from ``generator`` (seed 0 if None) on the CPU, moved to
    ``device`` (the CUDA card unless ``"cpu"``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return Megnet(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)


def make_crystal_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
                       **kwargs) -> Megnet:
    """The same model as :func:`make_model`, as in the JAX package; a batch
    with ``range_image`` and ``graph_lattice`` measures its edges through
    the images."""
    return make_model(device=device, generator=generator, **kwargs)
