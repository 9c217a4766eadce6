"""DimeNet++; counterpart of ``gcnn_keras_tpu/models/dimenet_pp.py``
(kgcnn's ``DimeNetPP.py`` and ``dimenet_conv.py``).

Directional message passing on the edges. Each edge's length enters
kgcnn's Bessel basis (``rbf``); each pair of edges of ``angle_edges``
(``set_angle_edge_pairs``: ``(e1, e2)`` with ``e2``'s sender the receiver
of ``e1``) enters the joint spherical basis of ``e2``'s length and the
angle between the two edges (``SphericalBasisLayer``). The embedding
block makes a message per edge from its two atoms and ``rbf``; each of
``num_blocks`` interaction blocks mixes the down-projected messages over
the pairs (``sbf``-weighted, summed onto ``e1``: the ids are not sorted,
so ``index_add_``, as the JAX package takes XLA's scatter) and refines
them through residual layers; an output block after the embedding and
after each interaction sums its messages onto their receivers (kernel
#1) and maps them to ``num_targets``; the readout sums (``extensive``) or
averages them per graph (kernel #1), then the optional ``output_mlp``.

Every Dense of the blocks starts from ``glorot_orthogonal``; the output
blocks' last layer (``out``) from zeros by default (``output_init``), so a
fresh model's output is 0 until a step moves those heads. The Bessel
frequencies are the closed form ``n pi``, not parameters (kgcnn trains
them from those values), as in the JAX package.

A batch without ``angle_edges`` raises ``ValueError`` (the JAX model
asserts). ``make_crystal_model`` is the same model: it measures each edge
as ``x_recv - x_send`` and reads no ``range_image``, as the JAX model does.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..layers.aggr import pool_edges_to_nodes, pool_nodes_to_graph
from ..layers.geometry import bessel_basis_kgcnn
from ..layers.mlp import MLP, Dense
from ..ops.initializers import glorot_orthogonal_
from ..ops.polynom import legendre_pn_all, spherical_bessel_jn_diagonal, spherical_bessel_zeros
from ..ops.segment import segment_sum
from ..utils.devices import DeviceLike, resolve_device
from .registry import update_model_kwargs

Tensor = torch.Tensor

model_default = dict(
    input_embedding={"node": {"input_dim": 95, "output_dim": 128}},
    emb_size=128, out_emb_size=256, int_emb_size=64, basis_emb_size=8,
    num_blocks=4, num_spherical=7, num_radial=6,
    cutoff=5.0, envelope_exponent=5,
    num_before_skip=1, num_after_skip=2, num_dense_output=3,
    num_targets=1, activation="swish",
    extensive=True, output_init="zeros",
    output_embedding="graph",
    output_mlp={},
)


@functools.lru_cache(maxsize=None)
def _sbf_constants(num_spherical: int, num_radial: int):
    """The spherical basis's constants: the first ``num_radial`` zeros
    ``z_ln`` of each ``j_l`` and the norms ``sqrt(2) / |j_{l+1}(z_ln)|``,
    float32, ``(L, n)`` each."""
    from scipy.special import spherical_jn
    zeros = spherical_bessel_zeros(num_spherical, num_radial)
    norms = np.zeros_like(zeros)
    for l in range(num_spherical):
        for n in range(num_radial):
            norms[l, n] = math.sqrt(2.0) / abs(spherical_jn(l + 1, zeros[l, n]))
    return zeros.astype(np.float32), norms.astype(np.float32)


def clip_unit(c: Tensor) -> Tensor:
    """``c`` clipped to [-1, 1] as ``jnp.clip``, whose gradient at a bound
    is halved (``torch.clamp`` passes it whole); a self pair's cosine sits
    on one."""
    return torch.minimum(torch.maximum(c, c.new_full((), -1.0)), c.new_full((), 1.0))


def guarded_norm(v: Tensor) -> Tensor:
    """``|v|`` over the last axis with the squared norm floored at 1e-12:
    a padding pair's zero vector gets a finite gradient."""
    return torch.sqrt(torch.sum(v * v, dim=-1).clamp_min(1e-12))


def pair_cosines(vec: Tensor, pairs: Tensor, flip: bool = False) -> Tensor:
    """The cosine of the angle between ``vec[pairs[:, 0]]`` and
    ``vec[pairs[:, 1]]`` (negated with ``flip``), clipped to [-1, 1]."""
    v1 = vec.index_select(0, pairs[:, 0])
    v2 = vec.index_select(0, pairs[:, 1])
    if flip:
        v2 = -v2
    return clip_unit(torch.sum(v1 * v2, dim=-1) / (guarded_norm(v1) * guarded_norm(v2)))


class SphericalBasisLayer(nn.Module):
    """kgcnn's ``SphericalBasisLayer`` (``dimenet_conv.py:380``): ``sbf_ln =
    norm_ln j_l(z_ln d / c) Y_l0(alpha) env(d / c)`` per pair, ``(P, L n)``,
    with kgcnn's envelope ``1/u + a u^(p-1) + b u^p + c u^(p+1)`` (p =
    exponent + 1), 0 from the cutoff on."""

    def __init__(self, num_spherical: int = 7, num_radial: int = 6, cutoff: float = 5.0,
                 envelope_exponent: int = 5):
        super().__init__()
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.cutoff, self.envelope_exponent = cutoff, envelope_exponent
        zeros, norms = _sbf_constants(num_spherical, num_radial)
        self.register_buffer("zeros", torch.from_numpy(zeros), persistent=False)
        self.register_buffer("norms", torch.from_numpy(norms), persistent=False)
        self.register_buffer("yl_scale", torch.tensor(
            [math.sqrt((2 * l + 1) / (4 * math.pi)) for l in range(num_spherical)],
            dtype=torch.float32), persistent=False)

    def forward(self, d_kj: Tensor, cos_alpha: Tensor) -> Tensor:
        rho = d_kj / self.cutoff
        pe = self.envelope_exponent + 1
        a = -(pe + 1) * (pe + 2) / 2.0
        b = float(pe * (pe + 2))
        c = -pe * (pe + 1) / 2.0
        safe = rho.clamp_min(1e-12)
        env = 1.0 / safe + a * safe ** (pe - 1) + b * safe ** pe + c * safe ** (pe + 1)
        env = torch.where(rho < 1.0, env, torch.zeros_like(env))
        rad = spherical_bessel_jn_diagonal(rho[:, None, None] * self.zeros) * self.norms
        ang = legendre_pn_all(cos_alpha, self.num_spherical) * self.yl_scale
        out = rad * ang[:, :, None] * env[:, None, None]
        return out.reshape(-1, self.num_spherical * self.num_radial)


def _dense(in_features: int, units: int, generator, activation: Any = "linear",
           use_bias: bool = True, orthogonal: bool = True) -> Dense:
    """A ``Dense`` whose kernel starts from ``glorot_orthogonal``."""
    layer = Dense(in_features, units, activation=activation, use_bias=use_bias,
                  generator=generator)
    if orthogonal:
        glorot_orthogonal_(layer.weight, generator)
    return layer


class ResidualLayer(nn.Module):
    """``x + dense_2(dense_1(x))``, both ``glorot_orthogonal`` with a bias."""

    def __init__(self, units: int, activation: Any = "swish",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_1 = _dense(units, units, generator, activation)
        self.dense_2 = _dense(units, units, generator, activation)

    def forward(self, x: Tensor) -> Tensor:
        return x + self.dense_2(self.dense_1(x))


class DimNetInteractionPPBlock(nn.Module):
    def __init__(self, emb_size: int = 128, int_emb_size: int = 64, basis_emb_size: int = 8,
                 num_before_skip: int = 1, num_after_skip: int = 2, activation: Any = "swish",
                 num_radial: int = 6, num_sbf: int = 42,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, act = generator, activation
        self.rbf_1 = _dense(num_radial, basis_emb_size, g, use_bias=False)
        self.rbf_2 = _dense(basis_emb_size, emb_size, g, use_bias=False)
        self.sbf_1 = _dense(num_sbf, basis_emb_size, g, use_bias=False)
        self.sbf_2 = _dense(basis_emb_size, int_emb_size, g, use_bias=False)
        self.ji = _dense(emb_size, emb_size, g, act)
        self.kj = _dense(emb_size, emb_size, g, act)
        self.down = _dense(emb_size, int_emb_size, g, act, use_bias=False)
        self.up = _dense(int_emb_size, emb_size, g, act, use_bias=False)
        self.num_before_skip, self.num_after_skip = num_before_skip, num_after_skip
        for i in range(num_before_skip):
            self.add_module(f"res_before_{i}", ResidualLayer(emb_size, act, g))
        self.skip = _dense(emb_size, emb_size, g, act)
        for i in range(num_after_skip):
            self.add_module(f"res_after_{i}", ResidualLayer(emb_size, act, g))

    def forward(self, batch: GraphBatch, m: Tensor, rbf: Tensor, sbf: Tensor) -> Tensor:
        rbf_ = self.rbf_2(self.rbf_1(rbf))
        sbf_ = self.sbf_2(self.sbf_1(sbf))
        x_ji = self.ji(m)
        x_kj = self.down(self.kj(m) * rbf_)
        # the down-projected messages at e2, summed onto e1 over the pairs
        mix = x_kj.index_select(0, batch.angle_edges[:, 1]) * sbf_
        mix = mix * batch.angle_edge_mask[:, None].to(mix.dtype)
        x_kj = self.up(segment_sum(mix, batch.angle_edges[:, 0], batch.n_edge))
        m2 = x_ji + x_kj
        for i in range(self.num_before_skip):
            m2 = getattr(self, f"res_before_{i}")(m2)
        m = m + self.skip(m2)
        for i in range(self.num_after_skip):
            m = getattr(self, f"res_after_{i}")(m)
        return m


class DimNetOutputBlock(nn.Module):
    def __init__(self, emb_size: int = 128, out_emb_size: int = 256, num_dense: int = 3,
                 num_targets: int = 1, activation: Any = "swish", output_init: str = "zeros",
                 num_radial: int = 6, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.rbf = _dense(num_radial, emb_size, g, use_bias=False)
        self.up = _dense(emb_size, out_emb_size, g, use_bias=False)
        self.num_dense = num_dense
        for i in range(num_dense):
            self.add_module(f"dense_{i}", _dense(out_emb_size, out_emb_size, g, activation))
        self.out = _dense(out_emb_size, num_targets, g, use_bias=False,
                          orthogonal=output_init != "zeros")
        if output_init == "zeros":
            nn.init.zeros_(self.out.weight)

    def forward(self, batch: GraphBatch, m: Tensor, rbf: Tensor) -> Tensor:
        x = pool_edges_to_nodes(batch, self.rbf(rbf) * m, mode="sum")
        x = self.up(x)
        for i in range(self.num_dense):
            x = getattr(self, f"dense_{i}")(x)
        return self.out(x)


class NodeEmbedding(nn.Module):
    """A flax ``nn.Embed``'s table, ``embedding`` (rows, width), uniform
    in ``[-limit, limit]``."""

    def __init__(self, rows: int, width: int, limit: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Parameter(nn.init.uniform_(torch.empty(rows, width), -limit, limit,
                                                       generator=generator))

    def forward(self, z: Tensor) -> Tensor:
        return self.embedding.index_select(0, z.long())


class DimeNetPP(nn.Module):
    def __init__(self, config: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        g, act = generator, cfg["activation"]
        emb, nr = cfg["emb_size"], cfg["num_radial"]
        self.sbf = SphericalBasisLayer(cfg["num_spherical"], nr, cfg["cutoff"],
                                       cfg["envelope_exponent"])
        # kgcnn's embedding block draws its table from keras's 'uniform'
        self.embed_z = NodeEmbedding(cfg["input_embedding"]["node"]["input_dim"], emb, 0.05, g)
        self.embed_rbf = Dense(nr, emb, activation=act, generator=g)
        self.embed_out = Dense(3 * emb, emb, activation=act, generator=g)
        out_kw = dict(num_dense=cfg["num_dense_output"], num_targets=cfg["num_targets"],
                      activation=act, output_init=cfg["output_init"], num_radial=nr,
                      generator=g)
        self.output_0 = DimNetOutputBlock(emb, cfg["out_emb_size"], **out_kw)
        for b in range(cfg["num_blocks"]):
            self.add_module(f"interaction_{b}", DimNetInteractionPPBlock(
                emb, cfg["int_emb_size"], cfg["basis_emb_size"], cfg["num_before_skip"],
                cfg["num_after_skip"], act, nr, cfg["num_spherical"] * nr, g))
            self.add_module(f"output_{b + 1}",
                            DimNetOutputBlock(emb, cfg["out_emb_size"], **out_kw))
        self.output_mlp = None
        om = cfg.get("output_mlp")
        if cfg.get("use_output_mlp", True) and om:
            self.output_mlp = MLP(cfg["num_targets"], om["units"], activation=om["activation"],
                                  use_bias=om.get("use_bias", True), generator=g)

    def forward(self, batch: GraphBatch, train: bool = False) -> Dict[str, Tensor]:
        cfg = self.config
        if batch.angle_edges is None:
            raise ValueError("DimeNetPP needs angle_edges: set_angle_edge_pairs on each graph, "
                             "then batch_graphs(..., angle_edge_index_key='angle_indices')")
        pos = batch.nodes["node_coordinates"]
        vec = pos.index_select(0, batch.receivers) - pos.index_select(0, batch.senders)
        d = guarded_norm(vec)
        rbf = bessel_basis_kgcnn(d[:, None], num_radial=cfg["num_radial"],
                                 cutoff=cfg["cutoff"],
                                 envelope_exponent=cfg["envelope_exponent"])
        rbf = rbf * batch.edge_mask[:, None].to(rbf.dtype)
        # kgcnn's EdgeAngle: the angle between the pair's two edge vectors,
        # the distance of the second
        pairs = batch.angle_edges
        sbf = self.sbf(d.index_select(0, pairs[:, 1]), pair_cosines(vec, pairs))
        sbf = sbf * batch.angle_edge_mask[:, None].to(sbf.dtype)
        hz = self.embed_z(batch.nodes["node_number"])
        m = self.embed_out(torch.cat([hz.index_select(0, batch.receivers),
                                      hz.index_select(0, batch.senders),
                                      self.embed_rbf(rbf)], dim=-1))
        out = self.output_0(batch, m, rbf)
        for b in range(cfg["num_blocks"]):
            m = getattr(self, f"interaction_{b}")(batch, m, rbf, sbf)
            out = out + getattr(self, f"output_{b + 1}")(batch, m, rbf)
        out = out * batch.node_mask[:, None].to(out.dtype)
        if cfg["output_embedding"] == "graph":
            out = pool_nodes_to_graph(batch, out, mode="sum" if cfg["extensive"] else "mean")
        if self.output_mlp is not None:
            out = self.output_mlp(out)
        return {"output": out}


def make_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
               **kwargs) -> DimeNetPP:
    """DimeNet++ with the JAX package's defaults updated by ``kwargs``,
    weights drawn from ``generator`` (seed 0 if None) on the CPU, moved to
    ``device`` (the CUDA card unless ``"cpu"``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return DimeNetPP(update_model_kwargs(model_default, kwargs), generator=generator).to(dev)


def make_crystal_model(device: DeviceLike = None, generator: Optional[torch.Generator] = None,
                       **kwargs) -> DimeNetPP:
    """The same model as :func:`make_model`, as in the JAX package: its
    edge vectors read no lattice images."""
    return make_model(device=device, generator=generator, **kwargs)
