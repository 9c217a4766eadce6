"""Generic GNN convolutions: GIN and GINE, the GAT and GATv2 attention
heads, the relational GCN convolution and the GRU updates; counterpart of
``gcnn_keras_tpu/layers/conv/basic.py``.

Each sum onto the receivers runs on the sorted segment-sum kernel, the
attention heads' softmax-weighted one too, and each sender gather
(``gather_sender_nodes``) has that kernel as its transpose. A torch module
needs its input widths when it is built, where flax reads them from the
first call: ``in_features`` (the node features) and, for the attention
heads, ``edge_features`` (0 for none).

The GRUs: ``KerasGRUCellUpdate`` (NMPN, AttentiveFP, HamNet) and
``KerasGRUSequencePooling`` (CMPNN's readout) hold keras's layout as their
own parameters, ``kernel`` (F, 3U) with the gates [z | r | h],
``recurrent_kernel`` (U, 3U) and ``bias`` (2, 3U) as [input, recurrent],
with keras's ``reset_after=True``; ``GRUUpdate`` is flax's ``GRUCell``,
whose Denses ``GRUCell_0/{ir,iz,in,hr,hz,hn}`` hold flax's ``kernel``
(in, out) and ``bias``. None of them is ``torch.nn.GRUCell``, which orders
its gates [r | z | n] and splits its biases another way.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from ...batch import GraphBatch, flat_to_padded
from ...ops.activ import get_activation
from ..aggr import (gather_nodes, gather_sender_nodes, pool_edges_to_nodes,
                    pool_edges_to_nodes_attention)
from ..mlp import Dense, FlaxDense, RelationalDense, lecun_normal_

Tensor = torch.Tensor


class GIN(nn.Module):
    """``h_i' = (1 + eps) h_i + sum_j h_j``; ``epsilon_k`` is a learned
    scalar (zero at start) with ``epsilon_learnable``, else 0."""

    def __init__(self, pooling_method: str = "sum", epsilon_learnable: bool = False):
        super().__init__()
        self.pooling_method = pooling_method
        self.register_parameter(
            "epsilon_k", nn.Parameter(torch.zeros(())) if epsilon_learnable else None)

    def _combine(self, nodes: Tensor, agg: Tensor) -> Tensor:
        eps = 0.0 if self.epsilon_k is None else self.epsilon_k
        return (1.0 + eps) * nodes + agg

    def forward(self, batch: GraphBatch, nodes: Tensor) -> Tensor:
        hj = gather_sender_nodes(batch, nodes)
        return self._combine(nodes, pool_edges_to_nodes(batch, hj, mode=self.pooling_method))


class GINE(GIN):
    """GIN with edge features: ``sum_j act(h_j + e_ij)``."""

    def __init__(self, pooling_method: str = "sum", epsilon_learnable: bool = False,
                 activation: Any = "relu"):
        super().__init__(pooling_method, epsilon_learnable)
        self._act = get_activation(activation)

    def forward(self, batch: GraphBatch, nodes: Tensor, edges: Tensor) -> Tensor:
        msg = self._act(gather_sender_nodes(batch, nodes) + edges)
        return self._combine(nodes, pool_edges_to_nodes(batch, msg, mode=self.pooling_method))


class _AttentionHead(nn.Module):
    """What both heads share: ``linear_trafo`` (W), the edge features'
    place in the attention input, and the softmax-weighted sum of the
    senders' ``W n_j`` (gathered once) onto each receiver."""

    def __init__(self, in_features: int, units: int, edge_features: int = 0,
                 use_edge_features: bool = False, use_final_activation: bool = True,
                 activation: Any = "leaky_relu", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear_trafo = Dense(in_features, units, use_bias=use_bias, generator=generator)
        self.edge_features = edge_features if use_edge_features else 0
        self.use_final_activation = use_final_activation
        self._act = get_activation(activation)

    def _attention_input(self, parts, edges: Optional[Tensor]) -> Tensor:
        if self.edge_features:
            if edges is None or edges.shape[-1] != self.edge_features:
                raise ValueError(f"the head was built for edge features of width "
                                 f"{self.edge_features}, got "
                                 f"{None if edges is None else tuple(edges.shape)}")
            parts = parts + [edges]
        return torch.cat(parts, dim=-1)

    def _aggregate(self, batch: GraphBatch, wn_out: Tensor, a_ij: Tensor) -> Tensor:
        h = pool_edges_to_nodes_attention(batch, wn_out, a_ij)
        return self._act(h) if self.use_final_activation else h


class AttentionHeadGAT(_AttentionHead):
    """GAT head: ``a_ij = act(alpha^T [W n_i || W n_j (|| e_ij)])``, softmax
    over each receiver's edges, ``m_i = sum_j a_ij W n_j``."""

    def __init__(self, in_features: int, units: int, edge_features: int = 0,
                 use_edge_features: bool = False, use_final_activation: bool = True,
                 activation: Any = "leaky_relu", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, units, edge_features, use_edge_features,
                         use_final_activation, activation, use_bias, generator)
        self.alpha = Dense(2 * units + self.edge_features, 1, activation=activation,
                           use_bias=False, generator=generator)

    def forward(self, batch: GraphBatch, nodes: Tensor,
                edges: Optional[Tensor] = None) -> Tensor:
        wn = self.linear_trafo(nodes)
        wn_out = gather_sender_nodes(batch, wn)
        e_ij = self._attention_input([gather_nodes(wn, batch.receivers), wn_out], edges)
        return self._aggregate(batch, wn_out, self.alpha(e_ij))


class AttentionHeadGATV2(_AttentionHead):
    """GATv2 head: ``a_ij = alpha^T act(V [n_i || n_j (|| e_ij)])``
    (``alpha_activation`` is V), softmax over each receiver's edges,
    ``m_i = sum_j a_ij W n_j``."""

    def __init__(self, in_features: int, units: int, edge_features: int = 0,
                 use_edge_features: bool = False, use_final_activation: bool = True,
                 activation: Any = "leaky_relu", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, units, edge_features, use_edge_features,
                         use_final_activation, activation, use_bias, generator)
        self.alpha_activation = Dense(2 * in_features + self.edge_features, units,
                                      activation=activation, use_bias=use_bias,
                                      generator=generator)
        self.alpha = Dense(units, 1, use_bias=False, generator=generator)

    def forward(self, batch: GraphBatch, nodes: Tensor,
                edges: Optional[Tensor] = None) -> Tensor:
        wn = self.linear_trafo(nodes)
        e_ij = self._attention_input(
            [gather_nodes(nodes, batch.receivers), gather_sender_nodes(batch, nodes)], edges)
        return self._aggregate(batch, gather_sender_nodes(batch, wn),
                               self.alpha(self.alpha_activation(e_ij)))


class MultiHeadGATV2(nn.Module):
    """``num_heads`` GATv2 heads ``head_i`` (no final activation each),
    concatenated or averaged, then the activation."""

    def __init__(self, in_features: int, units: int, num_heads: int = 4,
                 edge_features: int = 0, use_edge_features: bool = True,
                 concat_heads: bool = True, activation: Any = "leaky_relu",
                 use_bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.concat_heads = concat_heads
        self._act = get_activation(activation)
        for i in range(num_heads):
            self.add_module(f"head_{i}", AttentionHeadGATV2(
                in_features, units, edge_features, use_edge_features=use_edge_features,
                use_final_activation=False, activation=activation, use_bias=use_bias,
                generator=generator))

    def forward(self, batch: GraphBatch, nodes: Tensor,
                edges: Optional[Tensor] = None) -> Tensor:
        heads = [getattr(self, f"head_{i}")(batch, nodes, edges) for i in range(self.num_heads)]
        out = torch.cat(heads, dim=-1) if self.concat_heads else sum(heads) / self.num_heads
        return self._act(out)


def matmul_messages(trafo: Tensor, edges: Tensor) -> Tensor:
    """Per-edge matrix product: ``(E, F', F) @ (E, F) -> (E, F')``."""
    return torch.einsum("euf,ef->eu", trafo, edges)


class RelationalGCNConv(nn.Module):
    """R-GCN: ``h_i' = act(W0 h_i + sum_j w_ij W_{r_ij} h_j)``:
    ``self_dense`` (W0), ``rel_dense`` (a ``RelationalDense``, with a bias
    per relation) on the gathered senders, times the edge weights where
    given, summed onto the receivers."""

    def __init__(self, in_features: int, units: int, num_relations: int,
                 activation: Any = "relu", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self_dense = Dense(in_features, units, use_bias=use_bias, generator=generator)
        self.rel_dense = RelationalDense(in_features, units, num_relations,
                                         use_bias=use_bias, generator=generator)
        self._act = get_activation(activation)

    def forward(self, batch: GraphBatch, nodes: Tensor, edge_relations: Tensor,
                edge_weights: Optional[Tensor] = None) -> Tensor:
        rel_msg = self.rel_dense(gather_sender_nodes(batch, nodes), edge_relations)
        if edge_weights is not None:
            rel_msg = rel_msg * edge_weights.reshape(edge_weights.shape[0], -1)[:, :1]
        return self._act(self.self_dense(nodes) + pool_edges_to_nodes(batch, rel_msg))


def _keras_gru_weights(module: nn.Module, in_features: int, units: int,
                       generator: Optional[torch.Generator]) -> None:
    """keras's GRU parameters on ``module``, drawn as the JAX package draws
    them: ``kernel`` lecun-normal, ``recurrent_kernel`` orthogonal, ``bias``
    zeros."""
    module.kernel = nn.Parameter(lecun_normal_(torch.empty(in_features, 3 * units),
                                               in_features, generator))
    module.recurrent_kernel = nn.Parameter(nn.init.orthogonal_(
        torch.empty(units, 3 * units), generator=generator))
    module.bias = nn.Parameter(torch.zeros(2, 3 * units))


def _keras_gru_step(xw: Tensor, state: Tensor, recurrent_kernel: Tensor,
                    recurrent_bias: Tensor) -> Tensor:
    """One keras GRU step (``reset_after=True``) from the input's projection
    ``xw = x @ kernel + bias[0]``."""
    xz, xr, xh = xw.chunk(3, dim=-1)
    rz, rr, rh = (state @ recurrent_kernel + recurrent_bias).chunk(3, dim=-1)
    z = torch.sigmoid(xz + rz)
    r = torch.sigmoid(xr + rr)
    return z * state + (1.0 - z) * torch.tanh(xh + r * rh)


class KerasGRUCellUpdate(nn.Module):
    """One keras ``GRUCell`` step: the new state of ``state`` (U wide) given
    ``inputs`` (``in_features`` wide)."""

    def __init__(self, in_features: int, units: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _keras_gru_weights(self, in_features, units, generator)

    def forward(self, state: Tensor, inputs: Tensor) -> Tensor:
        return _keras_gru_step(inputs @ self.kernel + self.bias[0], state,
                               self.recurrent_kernel, self.bias[1])


class KerasGRUSequencePooling(nn.Module):
    """Graph readout: a keras GRU from a zero state over each graph's nodes
    in order, ``(N, in_features) -> (G, units)``, its last state per graph.
    The graphs are padded to ``batch.max_nodes`` (``flat_to_padded``) and
    each of the ``max_nodes`` steps keeps a graph's state where it has no
    node left (``h (1 - m) + h_new m``), as the JAX ``lax.scan`` does; the
    loop's length is the batch's, so it needs no sync with the host."""

    def __init__(self, in_features: int, units: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.units = units
        _keras_gru_weights(self, in_features, units, generator)

    def forward(self, batch: GraphBatch, nodes: Tensor) -> Tensor:
        xw = flat_to_padded(nodes, batch) @ self.kernel + self.bias[0]  # (G, M, 3U)
        mask = flat_to_padded(batch.node_mask.to(nodes.dtype), batch)  # (G, M)
        h = nodes.new_zeros(xw.shape[0], self.units)
        for t in range(xw.shape[1]):
            m = mask[:, t, None]
            h_new = _keras_gru_step(xw[:, t], h, self.recurrent_kernel, self.bias[1])
            h = h * (1 - m) + h_new * m
        return h


class GRUUpdate(nn.Module):
    """flax's ``GRUCell`` as a node update, the state ``nodes`` (``units``
    wide) and the input ``messages`` (``in_features`` wide):
    ``r = sigmoid(ir(x) + hr(h))``, ``z = sigmoid(iz(x) + hz(h))``,
    ``n = tanh(in(x) + r hn(h))``, ``h' = (1 - z) n + z h``; the input
    Denses and ``hn`` carry a bias. Its weights start as flax draws them:
    input kernels lecun-normal, recurrent ones orthogonal. No model of the
    JAX package uses it."""

    def __init__(self, in_features: int, units: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cell = nn.Module()
        for gate in ("r", "z", "n"):
            cell.add_module(f"i{gate}", FlaxDense.lecun(in_features, units, True, generator))
        for gate in ("r", "z", "n"):
            cell.add_module(f"h{gate}", FlaxDense(nn.init.orthogonal_(
                torch.empty(units, units), generator=generator), gate == "n"))
        self.GRUCell_0 = cell

    def forward(self, nodes: Tensor, messages: Tensor) -> Tensor:
        cell = self.GRUCell_0
        gate = {name: getattr(cell, name) for name in ("ir", "iz", "in", "hr", "hz", "hn")}
        r = torch.sigmoid(gate["ir"](messages) + gate["hr"](nodes))
        z = torch.sigmoid(gate["iz"](messages) + gate["hz"](nodes))
        n = torch.tanh(gate["in"](messages) + r * gate["hn"](nodes))
        return (1.0 - z) * n + z * nodes
