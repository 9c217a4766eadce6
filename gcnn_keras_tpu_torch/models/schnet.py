"""SchNet model; counterpart of ``gcnn_keras_tpu/models/schnet.py``.
``interaction_args`` selects the CFconv's execution mode
(``fused_aggregate``, ``accurate_cfconv``, ``fused_chain``;
``layers/conv/schnet.py``); every mode keeps the default parameter tree.
With ``fused_chain`` the interactions recompute the Gaussian basis from the
positions, so the model needs ``make_distance`` and ``expand_distance`` and
computes the edge basis only when a batch takes the default path.

Three more options, each on the same parameter tree:
- ``dtype="bfloat16"``: the interactions' Dense layers compute in bfloat16
  (``layers/conv/schnet.py``); the geometry, the embedding and the readout
  stay float32.
- ``dense_block=True``: the interactions run on ``(G, M, F)`` padded
  blocks over a dense adjacency (``layers/dense_block.py``), for small
  non-periodic molecules; it needs ``make_distance`` and
  ``expand_distance`` (distances come from the coordinates of each pair)
  and a sum or mean pool.
- ``remat=True``: each interaction runs under
  ``torch.utils.checkpoint(use_reentrant=False)`` (the JAX package's
  ``nn.remat``): its activations are not kept but recomputed in the
  backward, kernels included, so a kernel's launches per training step
  grow by the forward launches of the interactions recomputed. While its
  inputs carry forward-mode tangents (the fast force step's surrogate,
  ``training/fast_force_step.py``) an interaction runs unchecked: the
  checkpoint's recomputation in a later reverse pass runs without those
  tangents and saves other tensors than the forward did, which the
  checkpoint refuses (JAX's ``remat`` composes with ``jvp``).

Periodic support is implicit: a batch that carries ``edges['range_image']``
and ``globals['graph_lattice']`` gets the lattice shift in its edge vectors.
Submodule names follow the flax parameter tree (``embed_to_units``,
``interaction_i/{pre,cfconv/filter_1,...}``, ``last_mlp/dense_k``,
``output_mlp/dense_k``) so that ``utils/convert.py`` can map one onto the
other.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from ..batch import GraphBatch, flat_to_padded, padded_to_flat
from ..layers.aggr import pool_nodes_to_graph
from ..layers.conv.schnet import SchNetInteraction, SchNetInteractionDense
from ..layers.dense_block import dense_adjacency, dense_pair_distances, padded_node_mask
from ..layers.geometry import edge_distances, gauss_basis
from ..layers.mlp import MLP, Dense
from ..utils.devices import DeviceLike, resolve_device
from .common import OptionalInputEmbedding
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 64}},
    make_distance=True,
    expand_distance=True,
    gauss_args={"bins": 20, "distance_max": 4.0, "offset": 0.0, "sigma": 0.4},
    interaction_args={"units": 128, "use_bias": True,
                      "activation": "shifted_softplus", "cfconv_pool": "sum"},
    node_pooling_args={"pooling_method": "sum"},
    depth=4,
    last_mlp={"units": [128, 64], "activation": ["shifted_softplus", "shifted_softplus"]},
    output_embedding="graph",
    use_output_mlp=True,
    output_mlp={"units": [64, 1], "activation": ["shifted_softplus", "linear"]},
    dtype=None,
    dense_block=False,
    remat=False,
)


def _has_tangent(args) -> bool:
    """Whether an interaction's arguments carry a forward-mode tangent: a
    tensor's own, or a batch's coordinates'."""
    tensors = [a.nodes.get("node_coordinates") if isinstance(a, GraphBatch) else a
               for a in args]
    return any(isinstance(t, Tensor) and fwAD.unpack_dual(t).tangent is not None
               for t in tensors)


class Schnet(nn.Module):
    def __init__(self, config: Dict[str, Any],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg["output_embedding"] not in ("graph", "node"):
            raise ValueError(f"unsupported output_embedding {cfg['output_embedding']}")
        dense = bool(cfg.get("dense_block"))
        if dense:
            if not (cfg["make_distance"] and cfg["expand_distance"]):
                raise ValueError("dense_block=True requires make_distance and "
                                 "expand_distance (distances are recomputed "
                                 "densely from coordinates)")
            pool = cfg["node_pooling_args"].get("pooling_method", "sum")
            if cfg["output_embedding"] == "graph" and pool not in ("sum", "mean"):
                raise ValueError(f"dense_block pooling {pool!r} unsupported (sum|mean)")
        self.config = cfg
        emb = cfg["input_embedding"]["node"]
        self.embedding = OptionalInputEmbedding(**emb, generator=generator)
        units = cfg["interaction_args"]["units"]
        self.embed_to_units = Dense(emb["output_dim"], units, activation="linear",
                                    generator=generator)
        in_basis = cfg["gauss_args"]["bins"] if cfg["expand_distance"] else 1
        inter_args = dict(cfg["interaction_args"])
        if inter_args.get("fused_chain"):
            # the kernels recompute the basis from the positions: only valid
            # when the basis really is gauss(distance(positions))
            if not (cfg["make_distance"] and cfg["expand_distance"]):
                raise ValueError("fused_chain requires make_distance and "
                                 "expand_distance")
            inter_args["gauss_args"] = cfg["gauss_args"]
        inter = SchNetInteractionDense if dense else SchNetInteraction
        for i in range(cfg["depth"]):
            self.add_module(f"interaction_{i}", inter(
                **inter_args, in_basis=in_basis, generator=generator, dtype=cfg.get("dtype")))
        self.last_mlp = MLP(units, cfg["last_mlp"]["units"],
                            activation=cfg["last_mlp"]["activation"],
                            generator=generator)
        self.output_mlp = MLP(self.last_mlp.out_features, cfg["output_mlp"]["units"],
                              activation=cfg["output_mlp"]["activation"],
                              generator=generator) if cfg["use_output_mlp"] else None

    def _interact(self, inter: nn.Module, *args) -> Tensor:
        if self.config.get("remat") and not _has_tangent(args):
            return checkpoint(inter, *args, use_reentrant=False)
        return inter(*args)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        z = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        n = self.embedding(z)
        if cfg.get("dense_block"):
            return self._dense_forward(batch, n)
        interactions = [getattr(self, f"interaction_{i}") for i in range(cfg["depth"])]
        ed = None  # the fused chain computes its own basis
        if not all(inter.cfconv.takes_chain(batch) for inter in interactions):
            ed = edge_distances(batch) if cfg["make_distance"] \
                else batch.edges["edge_distance"]
            if cfg["expand_distance"]:
                ed = gauss_basis(ed, **cfg["gauss_args"])
            # zero the basis on padding edges so filters see exact zeros
            ed = ed * batch.edge_mask[:, None].to(ed.dtype)
        n = self.embed_to_units(n)
        for inter in interactions:
            n = self._interact(inter, batch, n, ed)
        n = self.last_mlp(n)
        if cfg["output_embedding"] == "graph":
            out = n * batch.node_mask[:, None].to(n.dtype)
            out = pool_nodes_to_graph(batch, out, **cfg["node_pooling_args"])
        else:
            out = n
        if self.output_mlp is not None:
            out = self.output_mlp(out)
        return {"output": out}

    def _dense_forward(self, batch: GraphBatch, n: Tensor) -> Dict[str, Tensor]:
        """The dense-block path: the flat path's arithmetic and parameters
        on ``(G, M, F)`` blocks, the distances of every pair of a molecule
        from the coordinates, no gather or scatter in the interactions."""
        cfg = self.config
        if "range_image" in batch.edges:
            raise ValueError("dense_block=True does not support periodic "
                             "batches (range_image present): use the flat "
                             "path for crystals")
        adj = dense_adjacency(batch)  # (G, M, M)
        d = dense_pair_distances(batch.nodes["node_coordinates"], batch, adj)
        ed = gauss_basis(d[..., None], **cfg["gauss_args"]) * adj[..., None]
        x = flat_to_padded(self.embed_to_units(n), batch)  # (G, M, U)
        for i in range(cfg["depth"]):
            x = self._interact(getattr(self, f"interaction_{i}"), adj, x, ed)
        x = self.last_mlp(x)
        if cfg["output_embedding"] == "graph":
            nmask = padded_node_mask(batch)  # (G, M)
            out = (x * nmask[..., None].to(x.dtype)).sum(1)
            if cfg["node_pooling_args"].get("pooling_method", "sum") == "mean":
                out = out / nmask.sum(1).clamp_min(1.0)[:, None]
        else:
            out = padded_to_flat(x, batch)
        if self.output_mlp is not None:
            out = self.output_mlp(out)
        return {"output": out}


def make_model(device: DeviceLike = None,
               generator: Optional[torch.Generator] = None, **kwargs) -> Schnet:
    """SchNet with the JAX package's defaults updated by ``kwargs``, on
    ``device`` (the CUDA card unless ``device="cpu"``). Weights are drawn
    from ``generator`` (a CPU ``torch.Generator``; seed 0 if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cfg = update_model_kwargs(model_default, kwargs)
    return Schnet(cfg, generator=generator).to(dev)


def make_crystal_model(device: DeviceLike = None,
                       generator: Optional[torch.Generator] = None,
                       **kwargs) -> Schnet:
    """Periodic variant: the same module; periodicity comes from the batch
    carrying ``range_image`` + ``graph_lattice``."""
    return make_model(device=device, generator=generator, **kwargs)
