"""MXMNet, the multiplex molecular graph network; counterpart of
``gcnn_keras_tpu/models/mxmnet.py`` (kgcnn's ``MXMNet.py`` and
``mxmnet_conv.py``).

Two tracks a depth step:

- ``MXMGlobalMP`` on the range graph (the batch's second edge set,
  ``senders2``/``receivers2``; the primary set where the batch has none)
  with a Bessel basis of its lengths: ``propagate`` twice, with the same
  ``x_edge_mlp`` and ``linear`` both times (one parameter each, its
  gradient the sum over both uses), each a mean over the receivers' real
  edges;
- ``MXMLocalMP`` on the bond graph (the primary edges) with a Bessel basis
  and the spherical basis over two pair lists, ``angle_edges`` (pairing
  ``jk``) and ``angle_edges_2`` (``ik`` with self pairs, the second vector
  negated); its ``h_mlp`` serves the entry and the update (one parameter);
  it emits ``t`` per node through ``y_mlp`` and ``y_W`` (zeros by default,
  ``output_kernel_initializer``).

The output is the sum of the steps' ``t``, summed per graph (kernel #1),
then ``output_mlp``. Every other sum is over ids the JAX package does not
mark sorted (XLA's scatter there): ``index_add_`` here.

Inputs: integer ``node_number`` (or ``node_attributes``) embedded by a
table of ``input_dim + 1`` rows, uniform in +-sqrt(3); ``in_features`` a
width for float node features taken as they are. With
``use_edge_attributes`` the float ``edge_attributes`` of width
``edge_in_features`` join the local Bessel basis. A batch without both
pair lists raises ``ValueError`` (the JAX model asserts).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import pool_nodes_to_graph
from ..layers.geometry import bessel_basis_kgcnn
from ..layers.mlp import MLP, Dense
from ..ops.segment import segment_sum
from ..utils.devices import DeviceLike, resolve_device
from .common import edge_input, mlp_width
from .dimenet_pp import (NodeEmbedding, ResidualLayer, SphericalBasisLayer, guarded_norm,
                         pair_cosines)
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 32},
                     "edge": {"input_dim": 32, "output_dim": 32}},
    bessel_basis_local={"num_radial": 16, "cutoff": 5.0, "envelope_exponent": 5},
    bessel_basis_global={"num_radial": 16, "cutoff": 5.0, "envelope_exponent": 5},
    spherical_basis_local={"num_spherical": 7, "num_radial": 6, "cutoff": 5.0,
                           "envelope_exponent": 5},
    mlp_rbf_kwargs={"units": 32, "activation": "swish"},
    mlp_sbf_kwargs={"units": 32, "activation": "swish"},
    global_mp_kwargs={"units": 32},
    local_mp_kwargs={"units": 32, "output_units": 1,
                     "output_kernel_initializer": "zeros"},
    use_edge_attributes=False,
    depth=3,
    node_pooling_args={"pooling_method": "sum"},
    output_embedding="graph",
    use_output_mlp=True,
    output_mlp={"use_bias": [True], "units": [1], "activation": ["linear"]},
    in_features=None,
    edge_in_features=0,
)


def _mean_onto(values: Tensor, mask: Tensor, ids: Tensor, num: int) -> Tensor:
    """The mean of the real rows of ``values`` by ``ids`` (unsorted)."""
    w = mask[:, None].to(values.dtype)
    s = segment_sum(values * w, ids, num)
    cnt = segment_sum(mask.to(values.dtype), ids, num)
    return s / torch.clamp_min(cnt, 1.0)[:, None]


class MXMGlobalMP(nn.Module):
    """kgcnn's ``MXMGlobalMP`` (``mxmnet_conv.py:12``) over ``in_features``
    node states and ``edge_features`` per range edge."""

    def __init__(self, in_features: int, edge_features: int, units: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.h_mlp = Dense(in_features, units, activation="swish", generator=g)
        self.res1 = ResidualLayer(units, generator=g)
        self.mlp = Dense(units, units, activation="swish", generator=g)
        self.res2 = ResidualLayer(units, generator=g)
        self.res3 = ResidualLayer(units, generator=g)
        self.x_edge_mlp = Dense(2 * units + edge_features, units, activation="swish",
                                generator=g)
        self.linear = Dense(edge_features, units, use_bias=False, generator=g)

    def forward(self, h: Tensor, edge_attr: Tensor, senders: Tensor, receivers: Tensor,
                edge_mask: Tensor) -> Tensor:
        def propagate(x: Tensor) -> Tensor:
            x_edge = self.x_edge_mlp(torch.cat([x.index_select(0, receivers),
                                                x.index_select(0, senders), edge_attr], dim=-1))
            x_edge = self.linear(edge_attr) * x_edge
            return _mean_onto(x_edge, edge_mask, receivers, x.shape[0]) + x

        res_h = h
        h = self.res1(propagate(self.h_mlp(h)))
        h = self.mlp(h) + res_h
        h = self.res3(self.res2(h))
        return propagate(h)


class MXMLocalMP(nn.Module):
    """kgcnn's ``MXMLocalMP`` (``mxmnet_conv.py:86``): two directional
    mixings, the sum onto the receivers, the update through the shared
    ``h_mlp``, and the output ``t``."""

    def __init__(self, rbf_features: int, sbf_features: int, units: int = 64,
                 output_units: int = 1, activation: str = "swish",
                 output_kernel_initializer: str = "zeros", pooling_method: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, u, act = generator, units, activation
        self.pooling_method = pooling_method
        self.h_mlp = Dense(u, u, activation=act, generator=g)  # the entry's and the update's
        self.mlp_kj = Dense(2 * u + rbf_features, u, activation=act, generator=g)
        self.lin_rbf1 = Dense(rbf_features, u, use_bias=False, generator=g)
        self.mlp_sbf1 = MLP(sbf_features, [u, u], activation=act, generator=g)
        self.mlp_ji_1 = Dense(2 * u + rbf_features, u, activation=act, generator=g)
        self.mlp_jj = Dense(u, u, activation=act, generator=g)
        self.lin_rbf2 = Dense(rbf_features, u, use_bias=False, generator=g)
        self.mlp_sbf2 = MLP(sbf_features, [u, u], activation=act, generator=g)
        self.mlp_ji_2 = Dense(u, u, activation=act, generator=g)
        self.lin_rbf_out = Dense(rbf_features, u, use_bias=False, generator=g)
        self.res1 = ResidualLayer(u, generator=g)
        self.res2 = ResidualLayer(u, generator=g)
        self.res3 = ResidualLayer(u, generator=g)
        self.y_mlp = MLP(u, [u, u, u], activation=act, generator=g)
        self.y_W = Dense(u, output_units, generator=g)
        if output_kernel_initializer == "zeros":
            nn.init.zeros_(self.y_W.weight)

    def _pool_pairs(self, values: Tensor, pairs: Tensor, mask: Tensor, n_edge: int) -> Tensor:
        if self.pooling_method == "mean":
            return _mean_onto(values, mask, pairs[:, 0], n_edge)
        return segment_sum(values * mask[:, None].to(values.dtype), pairs[:, 0], n_edge)

    def forward(self, batch: GraphBatch, h: Tensor, rbf: Tensor, sbf1: Tensor, sbf2: Tensor):
        e = batch.n_edge
        res_h = h
        h = self.h_mlp(h)
        m = torch.cat([h.index_select(0, batch.receivers), h.index_select(0, batch.senders),
                       rbf], dim=-1)
        # mixing over the pairing (ij, jk)
        m_kj = (self.mlp_kj(m) * self.lin_rbf1(rbf)).index_select(0, batch.angle_edges[:, 1])
        m_kj = self._pool_pairs(m_kj * self.mlp_sbf1(sbf1), batch.angle_edges,
                                batch.angle_edge_mask, e)
        m = self.mlp_ji_1(m) + m_kj
        # mixing over the pairing (ij, ik)
        m_jj = (self.mlp_jj(m) * self.lin_rbf2(rbf)).index_select(0, batch.angle_edges_2[:, 1])
        m_jj = self._pool_pairs(m_jj * self.mlp_sbf2(sbf2), batch.angle_edges_2,
                                batch.angle_edge_mask_2, e)
        m = self.mlp_ji_2(m) + m_jj
        m = self.lin_rbf_out(rbf) * m
        if self.pooling_method == "mean":
            h = _mean_onto(m, batch.edge_mask, batch.receivers, batch.n_node)
        else:
            h = segment_sum(m * batch.edge_mask[:, None].to(m.dtype), batch.receivers,
                            batch.n_node)
        h = self.h_mlp(self.res1(h)) + res_h
        h = self.res3(self.res2(h))
        return h, self.y_W(self.y_mlp(h))


class MXMNet(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        g = generator
        emb = cfg["input_embedding"]["node"]
        self.embed_z = None
        if cfg["in_features"] is None:
            # kgcnn's EmbeddingDimeBlock: input_dim + 1 rows, uniform +-sqrt(3)
            self.embed_z = NodeEmbedding(emb["input_dim"] + 1, emb["output_dim"],
                                         math.sqrt(3.0), g)
            h_width = emb["output_dim"]
        else:
            h_width = cfg["in_features"]
        bbl, bbg, sph = (cfg["bessel_basis_local"], cfg["bessel_basis_global"],
                         cfg["spherical_basis_local"])
        self.sbf_layer = SphericalBasisLayer(sph["num_spherical"], sph["num_radial"],
                                             sph["cutoff"], sph.get("envelope_exponent", 5))
        rk, sk = cfg["mlp_rbf_kwargs"], cfg["mlp_sbf_kwargs"]
        rbf_l_width = bbl["num_radial"] + (cfg["edge_in_features"]
                                           if cfg["use_edge_attributes"] else 0)
        self.mlp_rbf_l = MLP(rbf_l_width, rk["units"], activation=rk["activation"], generator=g)
        n_sbf = sph["num_spherical"] * sph["num_radial"]
        self.mlp_sbf_1 = MLP(n_sbf, sk["units"], activation=sk["activation"], generator=g)
        self.mlp_sbf_2 = MLP(n_sbf, sk["units"], activation=sk["activation"], generator=g)
        self.mlp_rbf_g = MLP(bbg["num_radial"], rk["units"], activation=rk["activation"],
                             generator=g)
        r_width, s_width = mlp_width(rk["units"]), mlp_width(sk["units"])
        out_width = cfg["local_mp_kwargs"].get("output_units", 1)
        for i in range(cfg["depth"]):
            self.add_module(f"global_{i}", MXMGlobalMP(h_width, r_width,
                                                       **cfg["global_mp_kwargs"], generator=g))
            h_width = cfg["global_mp_kwargs"]["units"]
            self.add_module(f"local_{i}", MXMLocalMP(r_width, s_width, **cfg["local_mp_kwargs"],
                                                     generator=g))
            h_width = cfg["local_mp_kwargs"]["units"]
        self.output_mlp = None
        if cfg.get("use_output_mlp", True):
            om = cfg["output_mlp"]
            self.output_mlp = MLP(out_width, om["units"], activation=om["activation"],
                                  use_bias=om.get("use_bias", True), generator=g)

    def _basis(self, distance: Tensor, kw: Dict[str, Any], mask: Tensor) -> Tensor:
        rbf = bessel_basis_kgcnn(distance[:, None], num_radial=kw["num_radial"],
                                 cutoff=kw["cutoff"],
                                 envelope_exponent=kw.get("envelope_exponent", 5))
        return rbf * mask[:, None].to(rbf.dtype)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        if batch.angle_edges is None or batch.angle_edges_2 is None:
            raise ValueError("MXMNet needs both angle-pair lists: set_angle_pairs_kgcnn with "
                             "edge_pairing 'jk' and 'ik' (allow_self_edges), batched by "
                             "angle_edge_index_key and angle_edge_index_key_2")
        pos = batch.nodes["node_coordinates"]
        x = batch.nodes.get("node_attributes", batch.nodes.get("node_number"))
        if self.embed_z is not None:
            if x.is_floating_point() or x.dim() != 1:
                raise ValueError("MXMNet was built for integer node numbers; give make_model "
                                 "the feature width (in_features)")
            h = self.embed_z(x)
        else:
            if x.dim() != 2 or x.shape[1] != cfg["in_features"]:
                raise ValueError(f"MXMNet was built for float node features of width "
                                 f"{cfg['in_features']} (in_features), got {tuple(x.shape)}")
            h = x
        vec = pos.index_select(0, batch.receivers) - pos.index_select(0, batch.senders)
        d_l = guarded_norm(vec)
        rbf_l = self._basis(d_l, cfg["bessel_basis_local"], batch.edge_mask)
        sbf = []
        for pairs, mask, flip in ((batch.angle_edges, batch.angle_edge_mask, False),
                                  (batch.angle_edges_2, batch.angle_edge_mask_2, True)):
            # pairing 2 negates its second vector (kgcnn's vector_scale [1, -1])
            s = self.sbf_layer(d_l.index_select(0, pairs[:, 1]), pair_cosines(vec, pairs, flip))
            sbf.append(s * mask[:, None].to(s.dtype))
        if batch.senders2 is not None:
            snd_g, rcv_g, mask_g = batch.senders2, batch.receivers2, batch.edge2_mask
        else:
            snd_g, rcv_g, mask_g = batch.senders, batch.receivers, batch.edge_mask
        d_g = guarded_norm(pos.index_select(0, rcv_g) - pos.index_select(0, snd_g))
        rbf_g = self._basis(d_g, cfg["bessel_basis_global"], mask_g)
        if cfg["use_edge_attributes"]:
            ed = edge_input(batch, None, cfg["edge_in_features"])
            if ed is not None:
                rbf_l = torch.cat([rbf_l, ed], dim=-1)
        rbf_l, rbf_g = self.mlp_rbf_l(rbf_l), self.mlp_rbf_g(rbf_g)
        sbf1, sbf2 = self.mlp_sbf_1(sbf[0]), self.mlp_sbf_2(sbf[1])
        t_sum = 0.0
        for i in range(cfg["depth"]):
            h = getattr(self, f"global_{i}")(h, rbf_g, snd_g, rcv_g, mask_g)
            h, t = getattr(self, f"local_{i}")(batch, h, rbf_l, sbf1, sbf2)
            t_sum = t_sum + t
        out = t_sum * batch.node_mask[:, None].to(h.dtype)
        if cfg["output_embedding"] == "graph":
            out = pool_nodes_to_graph(batch, out, **cfg["node_pooling_args"])
        if self.output_mlp is not None:
            out = self.output_mlp(out)
        return {"output": out}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> MXMNet:
    """MXMNet with the JAX package's defaults updated by ``kwargs``,
    weights drawn from ``generator`` (seed 0 if None) on the CPU, moved to
    ``device`` (the CUDA card unless ``"cpu"``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return MXMNet(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)
