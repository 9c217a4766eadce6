"""Set2Set readout; counterpart of ``gcnn_keras_tpu/layers/pool/set2set.py``.

An order-invariant LSTM-attention pool over each graph's nodes (or edges),
``(N, channels) -> (G, 2 channels)``:
- ``q*_0``: with ``init_qstar="mean"`` the per-graph mean ``q0``, one
  attention round on it gives ``r0``, ``q*_0 = [q0 || r0]``; with ``"0"``
  zeros;
- each of ``T`` rounds runs one keras ``LSTM`` step on ``q*`` from a zero
  state (keras's LSTM starts afresh at each call), ``q = o tanh(i tanh(c))``
  with the gates [i, f, c, o] of ``q* @ kernel + bias``, then attends:
  ``e_i = pool(m_i * q)`` over the features (``pooling_method`` mean or
  sum: any other name), a softmax over each graph's real entries, ``r = sum a_i m_i``,
  ``q* = [q || r]``.

The weights are keras's: ``kernel`` (2c, 4c), ``recurrent_kernel`` (c, 4c)
and ``bias`` (4c,). The recurrent kernel meets only the zero state, so it
is never read; it is kept so that the JAX package's tree loads whole. As in
the JAX layer, the mean and the attention sum take the segment ids as
unsorted: ``index_add_``, not the sorted segment-sum kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...batch import GraphBatch
from ...ops.segment import segment_ops_by_name, segment_softmax, segment_sum
from ..mlp import lecun_normal_

Tensor = torch.Tensor


class Set2Set(nn.Module):
    def __init__(self, channels: int, T: int = 3, pooling_method: str = "mean",
                 init_qstar: str = "mean", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels, self.T = channels, T
        self.pooling_method, self.init_qstar = pooling_method, init_qstar
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(2 * channels, 4 * channels),
                                                 2 * channels, generator))
        self.recurrent_kernel = nn.Parameter(nn.init.orthogonal_(
            torch.empty(channels, 4 * channels), generator=generator))
        self.bias = nn.Parameter(torch.zeros(4 * channels))

    def _lstm_step(self, qstar: Tensor) -> Tensor:
        zi, _, zc, zo = (qstar @ self.kernel + self.bias).chunk(4, dim=-1)
        return torch.sigmoid(zo) * torch.tanh(torch.sigmoid(zi) * torch.tanh(zc))

    def forward(self, batch: GraphBatch, values: Tensor,
                segment_ids: Optional[Tensor] = None, num_segments: Optional[int] = None,
                mask: Optional[Tensor] = None) -> Tensor:
        seg = segment_ids if segment_ids is not None else batch.graph_id
        num = num_segments if num_segments is not None else batch.n_graphs
        m_mask = mask if mask is not None else batch.node_mask
        m = values * m_mask.reshape(m_mask.shape + (1,) * (values.dim() - 1)).to(values.dtype)
        seg_long = seg.long()

        def attend(q: Tensor) -> Tensor:
            prod = m * q[seg_long]
            et = prod.mean(-1, keepdim=True) if self.pooling_method == "mean" \
                else prod.sum(-1, keepdim=True)
            return segment_sum(m * segment_softmax(et, seg, num, mask=m_mask), seg, num)

        if self.init_qstar == "mean":
            q0 = segment_ops_by_name("mean", m, seg, num)
            qstar = torch.cat([q0, attend(q0)], dim=-1)
        else:
            qstar = m.new_zeros(num, 2 * self.channels)
        for _ in range(self.T):
            q = self._lstm_step(qstar)
            qstar = torch.cat([q, attend(q)], dim=-1)
        return qstar
