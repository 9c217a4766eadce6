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
- ``fused_chain=True`` raises: its kernels (TPU kernels #5-#7) wait for
  slice 6.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ...batch import GraphBatch
from ...ops.cuda.fused_cfconv import fused_cfconv_auto
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
                 accurate_cfconv: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if accurate_cfconv and (not _is_ssp(activation) or not use_bias
                                or cfconv_pool != "sum"):
            raise ValueError(
                "accurate_cfconv requires the reference cfconv config "
                "(shifted_softplus filter, use_bias=True, sum pooling)")
        self.cfconv_pool = cfconv_pool
        self.fused_aggregate = fused_aggregate
        self.accurate_cfconv = accurate_cfconv
        self.filter_1 = Dense(in_basis, units, activation=activation,
                              use_bias=use_bias, generator=generator)
        self.filter_2 = Dense(units, units, activation="linear",
                              use_bias=use_bias, generator=generator)

    def forward(self, batch: GraphBatch, nodes: Tensor, edge_basis: Tensor) -> Tensor:
        if self.accurate_cfconv:
            # the filter's own weights, in the flax (in, out) layout
            return fused_cfconv_auto(
                edge_basis, gather_sender_nodes(batch, nodes), batch.receivers,
                nodes.shape[0], self.filter_1.weight.t(), self.filter_1.bias,
                self.filter_2.weight.t(), self.filter_2.bias)
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
        if fused_chain:
            raise NotImplementedError(
                "SchNet fused_chain=True needs the fused interaction-chain "
                "kernels (TPU kernels #5-#7, ops/pallas/fused_interaction.py), "
                "which wait for slice 6")
        self.pre = Dense(units, units, activation="linear", use_bias=False,
                         generator=generator)
        self.cfconv = SchNetCFconv(units, in_basis, activation=activation,
                                   use_bias=use_bias, cfconv_pool=cfconv_pool,
                                   fused_aggregate=fused_aggregate,
                                   accurate_cfconv=accurate_cfconv,
                                   generator=generator)
        self.post_1 = Dense(units, units, activation=activation,
                            use_bias=use_bias, generator=generator)
        self.post_2 = Dense(units, units, activation="linear",
                            use_bias=use_bias, generator=generator)

    def forward(self, batch: GraphBatch, nodes: Tensor, edge_basis: Tensor) -> Tensor:
        x = self.pre(nodes)
        x = self.cfconv(batch, x, edge_basis)
        x = self.post_2(self.post_1(x))
        return nodes + x
