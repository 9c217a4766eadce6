"""Graph U-Net; counterpart of ``gcnn_keras_tpu/models/unet.py``
(``GraphUnet``, ``make_model``).

The whole U runs on a padded per-graph form, nodes ``(G, M, F)`` and a
weighted adjacency ``(G, M, M)`` (``adj[g, i, j]`` the edge from sender j
to receiver i, set by a scatter), as in the JAX package; every step is a
batched matmul (``torch.matmul``: JAX takes XLA's dot here, no Pallas
kernel, and the port launches no kernel of its own):

- a GCN step (``_gcn``): a Dense on the nodes, the mean over each
  receiver's present senders (``adj != 0``), the activation;
- reconnect: ``A @ A`` with the entries above 1e-7 kept;
- gPool: the score ``n . p / ||p||`` (``p`` the raw parameter
  ``topk_{i}_score``); the ``round(k n)`` lowest scores of each graph's
  current nodes are removed (round half to even, ties by slot index), the
  survivors gated by ``sigmoid(score)``; the adjacency keeps the rows and
  columns of the survivors; removed nodes stay as zeroed slots;
- on the way up each level adds the stored nodes of the level below (the
  skip) before its GCN step on that level's adjacency.

The graph output is the output MLP of the nodes' mean per graph; a node
output (any other ``output_embedding``) the MLP of the flat nodes
(``padded_to_flat``).

Inputs: ``nodes['node_attributes']`` or ``nodes['node_number']`` (embedded
where integers); the edge weights are column 0 of ``edge_attributes``, else
of ``edge_weights`` (integer 1-D attributes embedded first by
``input_embedding["edge"]``), else 1 per edge. Widths at build:
``in_features`` the width of float node features (None: integer node
numbers); ``edge_in_features`` None for integer edge attributes (embedded),
the width of float ones (1 for a 1-D column), 0 for batches without them.

An ``output_mlp`` whose ``use_bias`` list is not as long as its ``units``
raises ``ValueError`` when built: the JAX ``MLP`` asserts at the model's
first call (``hyper_mutag.py``'s Unet, whose three units meet
``model_default``'s two biases).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch, flat_to_padded, padded_to_flat
from ..layers.mlp import MLP, Dense, glorot_uniform_
from ..ops.activ import get_activation
from ..utils.devices import DeviceLike, resolve_device
from .common import OptionalInputEmbedding, embed_input, input_embedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

_EPS = 1e-7  # tf.keras.backend.epsilon(), the reconnect threshold

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 5, "output_dim": 64}},
    hidden_dim={"units": 32, "use_bias": True, "activation": "linear"},
    top_k_args={"k": 0.3, "kernel_initializer": "ones"},
    activation="relu",
    use_reconnect=True,
    depth=4,
    pooling_args={"pooling_method": "mean"},
    gather_args={},
    output_embedding="graph",
    output_mlp={"use_bias": [True, False], "units": [25, 1],
                "activation": ["relu", "sigmoid"]},
    in_features=None,
    edge_in_features=None,
)


def _gcn(n: Tensor, adj: Tensor, dense: Dense, act) -> Tensor:
    """The Dense of the senders, averaged over each receiver's present
    edges (``adj != 0``); a receiver without any gets 0."""
    h = dense(n)
    presence = (adj != 0).to(h.dtype)
    count = presence.sum(-1, keepdim=True)
    summed = torch.matmul(presence, h)
    return act(torch.where(count > 0, summed / count.clamp_min(1.0), 0.0))


def top_k_keep(score: Tensor, mask: Tensor, k: float) -> Tensor:
    """gPool's selection ``(G, M)``: 1 where a node of ``mask`` survives the
    removal of the ``round(k n)`` lowest ``score`` s of its graph's ``n``
    nodes; ties by slot index."""
    n_remove = torch.round(k * mask.sum(1))
    big = torch.where(mask > 0, score, torch.inf)
    slot = torch.arange(score.shape[1], device=score.device)
    lower = (big[:, None, :] < big[:, :, None]) | (
        (big[:, None, :] == big[:, :, None]) & (slot[None, None, :] < slot[None, :, None]))
    rank = (lower & (mask[:, None, :] > 0)).sum(-1)
    return (rank >= n_remove[:, None]).to(score.dtype) * mask


def edge_weights(batch: GraphBatch, embedding: Optional[OptionalInputEmbedding],
                 edge_in_features: Optional[int], dtype: torch.dtype) -> Tensor:
    """The edges' weights ``(E,)`` (module docstring), 0 on padding edges;
    raises ``ValueError`` where the batch disagrees with
    ``edge_in_features``."""
    ed = batch.edges.get("edge_attributes", batch.edges.get("edge_weights"))
    if ed is None:
        got = 0
    elif ed.dim() == 1 and not ed.is_floating_point():
        got = None
    else:
        got = 1 if ed.dim() == 1 else ed.shape[-1]
    if got != edge_in_features:
        raise ValueError(f"the model was built with edge_in_features={edge_in_features}, the "
                         f"batch's edge values call for {got} (None: integer edge attributes, "
                         "embedded; 0: none)")
    if ed is None:
        ew = batch.edge_mask.to(dtype)
    else:
        if embedding is not None:
            ed = embedding(ed)
        ew = ed.reshape(ed.shape[0], -1)[:, 0].to(dtype)
    return ew * batch.edge_mask.to(ew.dtype)


class GraphUnet(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        out = cfg["output_mlp"]
        units = out["units"] if isinstance(out["units"], (list, tuple)) else [out["units"]]
        use_bias = out.get("use_bias", True)
        if isinstance(use_bias, (list, tuple)) and len(use_bias) != len(units):
            raise ValueError(f"output_mlp: use_bias {list(use_bias)} is not as long as units "
                             f"{list(units)} (the JAX model fails at its first call)")
        hid = cfg["hidden_dim"]
        self.embedding, width = input_embedding(cfg["input_embedding"]["node"],
                                                cfg["in_features"], generator)
        self.edge_embedding = OptionalInputEmbedding(**cfg["input_embedding"]["edge"],
                                                     generator=generator) \
            if cfg["edge_in_features"] is None else None

        def dense(fan_in):
            return Dense(fan_in, hid["units"], activation=hid["activation"],
                         use_bias=hid["use_bias"], generator=generator)
        self.proj = dense(width)
        ones = cfg["top_k_args"].get("kernel_initializer", "ones") == "ones"
        for i in range(cfg["depth"]):
            self.add_module(f"down_{i}", dense(hid["units"]))
            p = torch.ones(1, hid["units"]) if ones \
                else glorot_uniform_(torch.empty(1, hid["units"]), generator)
            self.register_parameter(f"topk_{i}_score", nn.Parameter(p))
        for i in range(cfg["depth"]):
            self.add_module(f"up_{i}", dense(hid["units"]))
        self.out_mlp = MLP(hid["units"], units, activation=out["activation"],
                           use_bias=use_bias, generator=generator)
        self._act = get_activation(cfg["activation"])

    def forward(self, batch: GraphBatch, train: bool = False,
                selection: Optional[List[Tensor]] = None) -> Dict[str, Tensor]:
        """``{"output"}``, and ``"keep"`` and ``"score"`` (``(depth, G, M)``:
        each level's selection and scores). ``selection``, a list of
        ``depth`` keep masks, takes their place of the level's own."""
        cfg = self.config
        k = cfg["top_k_args"].get("k", 0.1)
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n_flat = embed_input(x, self.embedding, cfg["in_features"])
        ew = edge_weights(batch, self.edge_embedding, cfg["edge_in_features"], n_flat.dtype)

        G, M = batch.n_graphs, max(batch.max_nodes, 1)
        n = flat_to_padded(n_flat, batch)
        valid = flat_to_padded(batch.node_mask[:, None].to(n.dtype), batch)[..., 0]
        ri = batch.node_loc[batch.receivers].clamp_max(M - 1).long()
        si = batch.node_loc[batch.senders].clamp_max(M - 1).long()
        adj = ew.new_zeros((G, M, M)).index_put_((batch.edge_graph_id.long(), ri, si), ew)

        n = self.proj(n)
        skip_n, skip_adj = [n], [adj]
        cur_n, cur_adj, cur_mask = n, adj, valid
        keeps, scores = [], []
        for i in range(cfg["depth"]):
            cur_n = _gcn(cur_n, cur_adj, getattr(self, f"down_{i}"), self._act)
            if cfg["use_reconnect"]:
                a2 = torch.matmul(cur_adj, cur_adj)
                cur_adj = torch.where(a2 > _EPS, a2, 0.0)
            p = getattr(self, f"topk_{i}_score")
            score = (cur_n * p[0]).sum(-1) / torch.sqrt((p * p).sum()).clamp_min(1e-12)
            keep = top_k_keep(score, cur_mask, k) if selection is None \
                else selection[i].to(score.dtype)
            cur_n = cur_n * (torch.sigmoid(score) * keep)[..., None]
            cur_adj = cur_adj * keep[:, :, None] * keep[:, None, :]
            cur_mask = keep
            skip_n.append(cur_n)
            skip_adj.append(cur_adj)
            keeps.append(keep)
            scores.append(score)
        for i in range(cfg["depth"], 0, -1):
            cur_n = _gcn(cur_n + skip_n[i - 1], skip_adj[i - 1], getattr(self, f"up_{i - 1}"),
                         self._act)
        if cfg["output_embedding"] == "graph":
            tot = (cur_n * valid[..., None]).sum(1)
            out = self.out_mlp(tot / valid.sum(1).clamp_min(1.0)[:, None])
        else:
            out = self.out_mlp(padded_to_flat(cur_n, batch))
        none = valid.new_zeros((0, G, M))
        return {"output": out, "keep": torch.stack(keeps) if keeps else none,
                "score": torch.stack(scores) if scores else none}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> GraphUnet:
    """The Graph U-Net with the JAX package's defaults updated by
    ``kwargs`` (with ``in_features`` and ``edge_in_features``, see the
    module docstring), on ``device`` (the CUDA card unless
    ``device="cpu"``); weights from ``generator`` (a CPU
    ``torch.Generator``; seed 0 if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return GraphUnet(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
