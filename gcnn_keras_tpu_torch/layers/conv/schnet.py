"""SchNet continuous-filter convolution and interaction block; counterpart
of ``gcnn_keras_tpu/layers/conv/schnet.py``.

- CFconv: filter = Dense(act) -> Dense(linear) on the radial basis; gather
  the sending nodes' features; multiply; sum onto receivers.
- Interaction: x + post_2(post_1(CFconv(pre(x)))), ``pre`` without bias.

Execution modes of the CFconv, all on one parameter set:
- default: the filter, then the unfused gather-multiply-sum;
- ``fused_aggregate=True``: the filter, then the fused
  gather-multiply-segment-sum kernel (``ops/cuda/bilinear.py``; the JAX
  package's MD default), differentiable to any order;
- ``accurate_cfconv=True``: the whole basis -> filter -> multiply -> sum
  chain in the fused cfconv kernel (``ops/cuda/fused_cfconv.py``), float32
  throughout, first-order only (energies and forces; a force loss raises);
- ``fused_chain=True``: the whole positions -> basis -> filter -> multiply
  -> sum chain in the fused interaction-chain kernels
  (``ops/cuda/fused_interaction.py``), differentiable to the second order
  (energy+force training); the edge basis is not used. A batch the
  kernels cannot take (periodic, or not sorted by receiver) takes the
  default path.

``dtype="bfloat16"`` computes the interaction's Dense layers in bfloat16
over float32 parameters (the JAX package's mixed precision): the messages
and their sums are bfloat16 (the sorted segment-sum's bfloat16 instance,
float32 inside), and the residual adds back in float32. As the JAX package
(whose fused kernels take float32 only), ``fused_aggregate`` then takes the
unfused chain, and ``fused_chain`` raises; ``accurate_cfconv``, the float32
accuracy mode of the fused cfconv kernel, raises too.

``SchNetCFconvDense``/``SchNetInteractionDense`` are the dense-block forms
(``layers/dense_block.py``): the same parameters, over ``(G, M, F)`` padded
node blocks and a ``(G, M, M)`` adjacency, with no gather or scatter.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ...batch import GraphBatch
from ...ops.cuda.fused_cfconv import fused_cfconv_auto
from ...ops.cuda.fused_interaction import (CFStatic, cfconv_fused_chain,
                                           fused_chain_ineligibility)
from ..aggr import gather_mul_pool_edges, gather_sender_nodes
from ..mlp import Dense, compute_dtype

Tensor = torch.Tensor


def _is_ssp(activation) -> bool:
    """True for either spelling of the reference filter activation."""
    return activation in ("shifted_softplus", "kgcnn>shifted_softplus")


class SchNetCFconv(nn.Module):
    def __init__(self, units: int, in_basis: int,
                 activation: Any = "shifted_softplus", use_bias: bool = True,
                 cfconv_pool: str = "sum", fused_aggregate: bool = False,
                 accurate_cfconv: bool = False, fused_chain: bool = False,
                 gauss_args: Any = None,
                 generator: Optional[torch.Generator] = None, dtype: Any = None):
        super().__init__()
        lower = compute_dtype(dtype) is not None  # computes below float32
        reference = _is_ssp(activation) and use_bias and cfconv_pool == "sum"
        if accurate_cfconv and not reference:
            raise ValueError(
                "accurate_cfconv requires the reference cfconv config "
                "(shifted_softplus filter, use_bias=True, sum pooling)")
        if accurate_cfconv and lower:
            raise ValueError(
                "accurate_cfconv is the fused cfconv kernel's float32 accuracy mode; "
                "it takes no dtype (use the default or fused_aggregate with bfloat16)")
        # the fused chain's Gaussian basis (None: the chain is not used)
        self.chain_static = None
        if fused_chain:
            if not reference or lower:
                raise ValueError(
                    "fused_chain requires the reference cfconv config "
                    "(shifted_softplus filter, use_bias=True, sum pooling, f32)")
            if not gauss_args:
                raise ValueError(
                    "fused_chain needs gauss_args (the model passes them "
                    "only when make_distance and expand_distance are True)")
            ga = dict(gauss_args)
            self.chain_static = CFStatic(bins=int(ga.get("bins", 20)),
                                         distance_max=float(ga.get("distance_max", 4.0)),
                                         offset=float(ga.get("offset", 0.0)),
                                         sigma=float(ga.get("sigma", 0.4)), units=units)
            if self.chain_static.bins != in_basis:
                raise ValueError(f"fused_chain: {self.chain_static.bins} bins but a "
                                 f"filter of {in_basis} inputs")
        self.cfconv_pool = cfconv_pool
        # the fused gms kernel takes float32 (the JAX gate sends other types
        # to the unfused chain); "vjp" stays "vjp", the custom-VJP route
        self.fused_aggregate = False if lower else fused_aggregate
        self.accurate_cfconv = accurate_cfconv
        self.filter_1 = Dense(in_basis, units, activation=activation,
                              use_bias=use_bias, generator=generator, dtype=dtype)
        self.filter_2 = Dense(units, units, activation="linear",
                              use_bias=use_bias, generator=generator, dtype=dtype)

    def takes_chain(self, batch: GraphBatch) -> bool:
        """Whether this cfconv runs the fused chain on ``batch``."""
        return self.chain_static is not None and not fused_chain_ineligibility(batch)

    def filter_weights(self):
        """``(W1, b1, W2, b2)`` of the filter in the flax (in, out) layout."""
        return (self.filter_1.weight.t(), self.filter_1.bias,
                self.filter_2.weight.t(), self.filter_2.bias)

    def forward(self, batch: GraphBatch, nodes: Tensor,
                edge_basis: Optional[Tensor]) -> Tensor:
        if self.takes_chain(batch):
            return cfconv_fused_chain(
                nodes, batch.nodes["node_coordinates"], *self.filter_weights(),
                batch.senders, batch.receivers, batch.edge_mask, self.chain_static)
        if self.accurate_cfconv:
            if batch.part_axis is not None:
                # the fused cfconv sums every edge it is given, and a
                # shard's padding edges point at a slot that may be real
                raise ValueError("accurate_cfconv on an edge-partitioned batch: the fused "
                                 "cfconv does not mask padding edges; use the default cfconv")
            return fused_cfconv_auto(
                edge_basis, gather_sender_nodes(batch, nodes), batch.receivers,
                nodes.shape[0], *self.filter_weights())
        f = self.filter_2(self.filter_1(edge_basis))
        return gather_mul_pool_edges(batch, nodes, f, mode=self.cfconv_pool,
                                     fused=self.fused_aggregate)


class SchNetCFconvDense(SchNetCFconv):
    """The cfconv on ``(G, M, F)`` padded blocks over a ``(G, M, M)``
    adjacency (``layers/dense_block.py``): the filter MLP on every pair, a
    masked product and a sum over the senders, no gather or scatter. Its
    parameters are :class:`SchNetCFconv`'s; the flat modes' options
    (``fused_aggregate``, ``accurate_cfconv``, ``fused_chain``,
    ``gauss_args``) are taken and unused, as in the JAX package."""

    def __init__(self, units: int, in_basis: int, activation: Any = "shifted_softplus",
                 use_bias: bool = True, cfconv_pool: str = "sum",
                 fused_aggregate: bool = False, accurate_cfconv: bool = False,
                 fused_chain: bool = False, gauss_args: Any = None,
                 generator: Optional[torch.Generator] = None, dtype: Any = None):
        if cfconv_pool not in ("sum", "mean"):
            raise ValueError(f"dense-block cfconv_pool {cfconv_pool!r} unsupported (sum|mean)")
        super().__init__(units, in_basis, activation=activation, use_bias=use_bias,
                         cfconv_pool=cfconv_pool, generator=generator, dtype=dtype)

    def forward(self, adj: Tensor, nodes_p: Tensor, basis_p: Tensor) -> Tensor:
        f = self.filter_2(self.filter_1(basis_p))  # (G, M, M, U)
        agg = (f * nodes_p[:, None, :, :] * adj[..., None].to(f.dtype)).sum(2)
        if self.cfconv_pool == "mean":
            agg = agg / adj.sum(2).clamp_min(1.0)[..., None].to(agg.dtype)
        return agg


class SchNetInteraction(nn.Module):
    cfconv_class = SchNetCFconv

    def __init__(self, units: int = 128, in_basis: int = 20,
                 activation: Any = "shifted_softplus", use_bias: bool = True,
                 cfconv_pool: str = "sum", fused_aggregate: bool = False,
                 accurate_cfconv: bool = False, fused_chain: bool = False,
                 gauss_args: Any = None,
                 generator: Optional[torch.Generator] = None, dtype: Any = None):
        super().__init__()
        self.pre = Dense(units, units, activation="linear", use_bias=False,
                         generator=generator, dtype=dtype)
        self.cfconv = self.cfconv_class(units, in_basis, activation=activation,
                                        use_bias=use_bias, cfconv_pool=cfconv_pool,
                                        fused_aggregate=fused_aggregate,
                                        accurate_cfconv=accurate_cfconv,
                                        fused_chain=fused_chain, gauss_args=gauss_args,
                                        generator=generator, dtype=dtype)
        self.post_1 = Dense(units, units, activation=activation,
                            use_bias=use_bias, generator=generator, dtype=dtype)
        self.post_2 = Dense(units, units, activation="linear",
                            use_bias=use_bias, generator=generator, dtype=dtype)

    def forward(self, batch: GraphBatch, nodes: Tensor,
                edge_basis: Optional[Tensor]) -> Tensor:
        x = self.pre(nodes)
        x = self.cfconv(batch, x, edge_basis)
        x = self.post_2(self.post_1(x))
        return nodes + x.to(nodes.dtype)


class SchNetInteractionDense(SchNetInteraction):
    """:class:`SchNetInteraction` on ``(G, M, F)`` padded node blocks, with
    the same parameters; ``forward(adj, nodes_p, basis_p)``."""

    cfconv_class = SchNetCFconvDense

    def forward(self, adj: Tensor, nodes_p: Tensor, basis_p: Tensor) -> Tensor:
        x = self.cfconv(adj, self.pre(nodes_p), basis_p)
        x = self.post_2(self.post_1(x))
        return nodes_p + x.to(nodes_p.dtype)
