"""SchNet continuous-filter convolution and interaction block; counterpart
of ``gcnn_keras_tpu/layers/conv/schnet.py`` on its default (unfused) path.

- CFconv: filter = Dense(act) -> Dense(linear) on the radial basis; gather
  the sending nodes' features; multiply; sum onto receivers.
- Interaction: x + post_2(post_1(CFconv(pre(x)))), ``pre`` without bias.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ...batch import GraphBatch
from ..aggr import gather_mul_pool_edges
from ..mlp import Dense

Tensor = torch.Tensor

# opt-in modes of the JAX package whose TPU kernels are not ported yet
_UNPORTED_MODES = {
    "fused_aggregate": "the fused gather-multiply-segment-sum kernel "
                       "(ops/pallas/fused_aggregate.py, bilinear.py gms)",
    "accurate_cfconv": "the fused cfconv kernel (ops/pallas/fused_cfconv.py)",
    "fused_chain": "the fused interaction-chain kernels "
                   "(ops/pallas/fused_interaction.py)",
}


def reject_unported_modes(**modes) -> None:
    for name, on in modes.items():
        if on:
            raise NotImplementedError(
                f"SchNet {name}=True needs {_UNPORTED_MODES[name]}, "
                "which is not ported yet")


class SchNetCFconv(nn.Module):
    def __init__(self, units: int, in_basis: int,
                 activation: Any = "shifted_softplus", use_bias: bool = True,
                 cfconv_pool: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfconv_pool = cfconv_pool
        self.filter_1 = Dense(in_basis, units, activation=activation,
                              use_bias=use_bias, generator=generator)
        self.filter_2 = Dense(units, units, activation="linear",
                              use_bias=use_bias, generator=generator)

    def forward(self, batch: GraphBatch, nodes: Tensor, edge_basis: Tensor) -> Tensor:
        f = self.filter_2(self.filter_1(edge_basis))
        return gather_mul_pool_edges(batch, nodes, f, mode=self.cfconv_pool)


class SchNetInteraction(nn.Module):
    def __init__(self, units: int = 128, in_basis: int = 20,
                 activation: Any = "shifted_softplus", use_bias: bool = True,
                 cfconv_pool: str = "sum", fused_aggregate: bool = False,
                 accurate_cfconv: bool = False, fused_chain: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        reject_unported_modes(fused_aggregate=fused_aggregate,
                              accurate_cfconv=accurate_cfconv,
                              fused_chain=fused_chain)
        self.pre = Dense(units, units, activation="linear", use_bias=False,
                         generator=generator)
        self.cfconv = SchNetCFconv(units, in_basis, activation=activation,
                                   use_bias=use_bias, cfconv_pool=cfconv_pool,
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
