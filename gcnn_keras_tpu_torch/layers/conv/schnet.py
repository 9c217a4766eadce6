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
from ..mlp import Dense

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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        reference = _is_ssp(activation) and use_bias and cfconv_pool == "sum"
        if accurate_cfconv and not reference:
            raise ValueError(
                "accurate_cfconv requires the reference cfconv config "
                "(shifted_softplus filter, use_bias=True, sum pooling)")
        # the fused chain's Gaussian basis (None: the chain is not used)
        self.chain_static = None
        if fused_chain:
            if not reference:
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
        self.fused_aggregate = fused_aggregate
        self.accurate_cfconv = accurate_cfconv
        self.filter_1 = Dense(in_basis, units, activation=activation,
                              use_bias=use_bias, generator=generator)
        self.filter_2 = Dense(units, units, activation="linear",
                              use_bias=use_bias, generator=generator)

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
            return fused_cfconv_auto(
                edge_basis, gather_sender_nodes(batch, nodes), batch.receivers,
                nodes.shape[0], *self.filter_weights())
        f = self.filter_2(self.filter_1(edge_basis))
        return gather_mul_pool_edges(batch, nodes, f, mode=self.cfconv_pool,
                                     fused=self.fused_aggregate)


class SchNetInteraction(nn.Module):
    def __init__(self, units: int = 128, in_basis: int = 20,
                 activation: Any = "shifted_softplus", use_bias: bool = True,
                 cfconv_pool: str = "sum", fused_aggregate: bool = False,
                 accurate_cfconv: bool = False, fused_chain: bool = False,
                 gauss_args: Any = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pre = Dense(units, units, activation="linear", use_bias=False,
                         generator=generator)
        self.cfconv = SchNetCFconv(units, in_basis, activation=activation,
                                   use_bias=use_bias, cfconv_pool=cfconv_pool,
                                   fused_aggregate=fused_aggregate,
                                   accurate_cfconv=accurate_cfconv,
                                   fused_chain=fused_chain, gauss_args=gauss_args,
                                   generator=generator)
        self.post_1 = Dense(units, units, activation=activation,
                            use_bias=use_bias, generator=generator)
        self.post_2 = Dense(units, units, activation="linear",
                            use_bias=use_bias, generator=generator)

    def forward(self, batch: GraphBatch, nodes: Tensor,
                edge_basis: Optional[Tensor]) -> Tensor:
        x = self.pre(nodes)
        x = self.cfconv(batch, x, edge_basis)
        x = self.post_2(self.post_1(x))
        return nodes + x
