"""MAT, the Molecule Attention Transformer; counterpart of
``gcnn_keras_tpu/models/mat.py`` (``mat_distance_matrix``,
``MATAttentionHead``, ``MAT``, ``make_model``).

A pre-norm transformer on padded per-graph tensors ``(G, M, F)``
(``flat_to_padded``), whose attention is a mix of per-feature-channel
self-attention, an ``exp(-d^2)`` distance matrix and the adjacency
projected to one channel:

- ``mat_distance_matrix``: squared distances; the ``exp`` transform adds
  1e7 to the masked pairs before ``exp(-d2)``, ``softmax`` subtracts 1e7
  before a softmax over ``j``; both mask again after.
- ``MATAttentionHead``: ``qk[g,i,j,f] = q[g,i,f] k[g,j,f] / units**-0.5``
  (the reference divides by its scale), a masked softmax over ``j``, then
  ``att = la qk + ld dist + ladj adj`` and ``out[g,i,f] = sum_j
  att[g,i,j,f] v[g,j,f]``.
- The dense adjacency sums each edge's values into ``(graph, receiver,
  sender)`` by an accumulating scatter (duplicate edges add, as XLA's
  scatter-add), then the bias-free ``adj_proj`` to one channel.
- Each layer: ``LayerNorm(1e-3)`` (flax's), the heads merged by concat
  (or a sum) and a bias-free Dense, a residual; ``LayerNorm``, the
  feed-forward MLP and a bias-free Dense, a masked residual.

The JAX package computes MAT in XLA (no Pallas kernel), so the port's is
plain PyTorch; it launches no kernel of the port.

Inputs: ``nodes['node_attributes']`` or ``nodes['node_number']`` (embedded
by ``node_embed`` where they are integers), ``node_coordinates`` if the
batch has them (else the distance term is 0), and ``edge_weights`` or
``edge_attributes`` as the adjacency's values (else 1 per edge). Widths at
build: ``in_features`` is the width of float node features (None: integer
node numbers); ``edge_in_features`` that of the edge values (1 for a 1-D
column; 0: batches without them). Dropout is not applied, as in JAX. A
graph output (``output_embedding="graph"``) pools the nodes by a sum; any
other is a node output, padded, ``(G, M, units)``, as JAX returns it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch, flat_to_padded
from ..layers.casting import dense_adjacency
from ..layers.mlp import MLP, FlaxDense
from ..layers.norm import LayerNorm
from ..utils.devices import DeviceLike, resolve_device
from .common import embed_input, input_embedding, mlp_width
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    name="MAT",
    input_embedding={"node": {"input_dim": 95, "output_dim": 64},
                     "edge": {"input_dim": 95, "output_dim": 64}},
    use_edge_embedding=False,
    max_atoms=None,
    distance_matrix_kwargs={"trafo": "exp"},
    attention_kwargs={"units": 8, "lambda_attention": 0.3,
                      "lambda_distance": 0.3, "lambda_adjacency": None,
                      "dropout": 0.1, "add_identity": False},
    feed_forward_kwargs={"units": [32, 32, 32],
                         "activation": ["relu", "relu", "linear"]},
    embedding_units=32,
    depth=5,
    heads=8,
    merge_heads="concat",
    verbose=10,
    pooling_kwargs={"pooling_method": "sum"},
    output_embedding="graph",
    output_to_tensor=True,
    output_mlp={"use_bias": [True, True, True], "units": [32, 16, 1],
                "activation": ["relu", "relu", "linear"]},
    in_features=None,
    edge_in_features=0,
)

_EPS_INV = 1e7  # 1 / keras.backend.epsilon()


def mat_distance_matrix(xyz: Tensor, pair_mask: Tensor,
                        trafo: Optional[str] = "exp") -> Tensor:
    """``MATDistanceMatrix``: ``xyz (G, M, 3)``, ``pair_mask (G, M, M, 1)``
    -> ``(G, M, M, 1)``."""
    diff = xyz[:, None, :, :] - xyz[:, :, None, :]
    dist = torch.sum(diff * diff, dim=-1, keepdim=True)
    if trafo == "exp":
        dist = dist + torch.where(pair_mask > 0, 0.0, _EPS_INV)
        dist = torch.exp(-dist)
    elif trafo == "softmax":
        dist = dist + torch.where(pair_mask > 0, 0.0, -_EPS_INV)
        dist = torch.softmax(dist, dim=2)
    return dist * pair_mask


class MATAttentionHead(nn.Module):
    """One per-feature-channel attention head over ``in_features`` wide
    nodes, ``dense_q``, ``dense_k`` and ``dense_v`` flax Denses of
    ``units``."""

    def __init__(self, in_features: int, units: int = 8, lambda_attention: float = 0.3,
                 lambda_distance: float = 0.3, lambda_adjacency: Optional[float] = None,
                 add_identity: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.units = units
        self.lambda_attention = lambda_attention
        self.lambda_distance = lambda_distance
        self.lambda_adjacency = (lambda_adjacency if lambda_adjacency is not None
                                 else 1.0 - lambda_attention - lambda_distance)
        self.add_identity = add_identity
        for name in ("dense_q", "dense_k", "dense_v"):
            self.add_module(name, FlaxDense.lecun(in_features, units, True, generator))

    def forward(self, h: Tensor, dist: Tensor, adj: Tensor, h_mask: Tensor) -> Tensor:
        q, k = self.dense_q(h), self.dense_k(h)
        v = self.dense_v(h) * h_mask
        qk = q[:, :, None, :] * k[:, None, :, :] / (self.units ** -0.5)
        qk_mask = h_mask[:, None, :, :] * h_mask[:, :, None, :]
        qk = qk + torch.where(qk_mask > 0, 0.0, -_EPS_INV)
        qk = torch.softmax(qk, dim=2) * qk_mask
        if self.add_identity:
            adj = adj + torch.eye(adj.shape[1], dtype=adj.dtype, device=adj.device)[None, :, :, None]
        att = (self.lambda_attention * qk + self.lambda_distance * dist
               + self.lambda_adjacency * adj)
        return torch.einsum("gijf,gjf->gif", att, v) * h_mask


def adjacency_values(batch: GraphBatch, edge_in_features: int, dtype: torch.dtype) -> Tensor:
    """The adjacency's values ``(E, C)``: ``edge_weights``, else
    ``edge_attributes``, a 1-D column as ``(E, 1)``, else the edge mask;
    raises ``ValueError`` where the batch disagrees with
    ``edge_in_features``."""
    ew = batch.edges.get("edge_weights", batch.edges.get("edge_attributes"))
    width = 0 if ew is None else (1 if ew.dim() == 1 else ew.shape[-1])
    if width != edge_in_features:
        raise ValueError(f"the model was built with edge_in_features={edge_in_features}, "
                         f"the batch's edge_weights/edge_attributes are {width} wide "
                         "(0 builds it for batches without them)")
    if ew is None:
        return batch.edge_mask.to(dtype)[:, None]
    return (ew[:, None] if ew.dim() == 1 else ew).to(dtype)


class MAT(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        u = cfg["embedding_units"]
        att_kwargs = dict(cfg["attention_kwargs"])
        att_kwargs.pop("dropout", None)
        heads = att_kwargs.pop("num_heads", None) or cfg["heads"]
        self.node_embed, width = input_embedding(cfg["input_embedding"]["node"],
                                                 cfg["in_features"], generator)
        self.adj_proj = FlaxDense.lecun(max(cfg["edge_in_features"], 1), 1, False, generator)
        self.proj = FlaxDense.lecun(width, u, False, generator)
        self.heads = heads
        merged = att_kwargs.get("units", 8) * (
            1 if cfg["merge_heads"] in ("add", "sum", "reduce_sum") else heads)
        ff = cfg["feed_forward_kwargs"]
        for i in range(cfg["depth"]):
            self.add_module(f"ln1_{i}", LayerNorm(u))
            for j in range(heads):
                self.add_module(f"att_{i}_{j}", MATAttentionHead(u, **att_kwargs,
                                                                 generator=generator))
            self.add_module(f"merge_{i}", FlaxDense.lecun(merged, u, False, generator))
            self.add_module(f"ln2_{i}", LayerNorm(u))
            self.add_module(f"ff_{i}", MLP(u, ff["units"], activation=ff["activation"],
                                           generator=generator))
            self.add_module(f"ff_proj_{i}", FlaxDense.lecun(mlp_width(ff["units"]), u, False,
                                                            generator))
        self.ln_out = LayerNorm(u)
        out = cfg["output_mlp"]
        use_bias = out.get("use_bias", True)
        units = out["units"] if isinstance(out["units"], (list, tuple)) else [out["units"]]
        if isinstance(use_bias, (list, tuple)) and len(use_bias) != len(units):
            use_bias = True
        self.out_mlp = MLP(u, units, activation=out["activation"], use_bias=use_bias,
                           generator=generator)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        nd = embed_input(x, self.node_embed, cfg["in_features"])
        n = flat_to_padded(nd, batch)
        mask = flat_to_padded(batch.node_mask.to(n.dtype), batch)
        h_mask = mask[:, :, None]
        pair_mask = h_mask[:, None, :, :] * h_mask[:, :, None, :]
        G, M = n.shape[0], n.shape[1]
        if "node_coordinates" in batch.nodes:
            xyz = flat_to_padded(batch.nodes["node_coordinates"], batch)
            dist = mat_distance_matrix(xyz, pair_mask, **cfg["distance_matrix_kwargs"])
        else:
            dist = n.new_zeros((G, M, M, 1))
        adj = dense_adjacency(batch, adjacency_values(batch, cfg["edge_in_features"], n.dtype), M)
        adj = self.adj_proj(adj)

        h = self.proj(n)
        for i in range(cfg["depth"]):
            hn = getattr(self, f"ln1_{i}")(h)
            hs = [getattr(self, f"att_{i}_{j}")(hn, dist, adj, h_mask)
                  for j in range(self.heads)]
            hu = sum(hs) if cfg["merge_heads"] in ("add", "sum", "reduce_sum") \
                else torch.cat(hs, dim=-1)
            h = h + getattr(self, f"merge_{i}")(hu)
            hn = getattr(self, f"ln2_{i}")(h)
            hu = getattr(self, f"ff_proj_{i}")(getattr(self, f"ff_{i}")(hn))
            h = h + hu * h_mask
        out = self.ln_out(h)
        if cfg["output_embedding"] == "graph":
            return {"output": self.out_mlp(torch.sum(out * h_mask, dim=1))}
        return {"output": self.out_mlp(out) * h_mask}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> MAT:
    """MAT with the JAX package's defaults updated by ``kwargs`` (with
    ``in_features`` and ``edge_in_features``, see the module docstring), on
    ``device`` (the CUDA card unless ``device="cpu"``); weights from
    ``generator`` (a CPU ``torch.Generator``; seed 0 if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return MAT(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
