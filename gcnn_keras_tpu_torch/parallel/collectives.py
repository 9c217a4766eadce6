"""The collectives of the SPMD paths, as autograd Functions; counterpart of
the ``jax.lax`` collectives the JAX package calls inside ``shard_map``
(``psum``, ``all_gather(tiled=True)``, ``ppermute``).

Each Function's backward is made of these Functions, so that a force loss
(a second reverse pass) runs through them: ``Psum`` is its own transpose
(JAX's ``psum`` under ``check_vma=False``: the partitioned models
differentiate ``E / n_shards``, ``parallel/partitioned.py``), the tiled
all-gather and the reduce-scatter of the sum are each other's transpose,
and a ring ``PPermute`` by ``shift`` has the permutation by ``-shift`` as
its transpose.

Transport: NCCL takes CUDA tensors, gloo CPU tensors and, for
``all_reduce`` and ``broadcast`` alone, CUDA tensors too. Where CUDA ranks
share one card over gloo, the other collectives stage the tensor through
page-locked host memory and copy the result back; the compute stays on the
card. ``Mesh.transport`` counts each collective by its route.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh

Tensor = torch.Tensor

# the tags of the ring permutations, by direction: at 2 ranks the left and
# the right neighbour are one peer
_TAGS = {1: 11, -1: 12}


def _staged(mesh: Mesh, t: Tensor, op: str) -> bool:
    """Whether ``op`` on ``t`` goes through host memory (a CUDA tensor over
    gloo; gloo's ``all_reduce`` and ``broadcast`` take it directly), counted
    in ``mesh.transport``."""
    staged = t.is_cuda and mesh.backend == "gloo"
    mesh.transport["staged" if staged else "direct"][op] += 1
    return staged


def _to_host(t: Tensor) -> Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(t: Tensor, mesh: Mesh) -> Tensor:
    """Sum ``t`` over the ranks, in place (no autograd)."""
    if mesh.size > 1:
        mesh.transport["direct"]["all_reduce"] += 1
        dist.all_reduce(t, group=mesh.group)
    return t


def broadcast_(t: Tensor, mesh: Mesh, src: int = 0) -> Tensor:
    """Rank ``src``'s ``t`` on every rank, in place (no autograd)."""
    if mesh.size > 1:
        mesh.transport["direct"]["broadcast"] += 1
        dist.broadcast(t, src, group=mesh.group)
    return t


def all_gather_tiled(t: Tensor, mesh: Mesh) -> Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order (no
    autograd; every rank's ``t`` has one shape)."""
    if mesh.size == 1:
        return t.clone()
    t = t.contiguous()
    if _staged(mesh, t, "all_gather"):
        h = _to_host(t)
        parts = [torch.empty_like(h) for _ in range(mesh.size)]
        dist.all_gather(parts, h, group=mesh.group)
        return torch.cat(parts, dim=0).to(t.device)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=0)


def reduce_scatter_tiled(t: Tensor, mesh: Mesh) -> Tensor:
    """This rank's slab (dim 0 cut in ``mesh.size`` equal parts) of the sum
    of every rank's ``t`` (no autograd)."""
    if mesh.size == 1:
        return t.clone()
    t = t.contiguous()
    n = t.shape[0] // mesh.size
    staged = _staged(mesh, t, "reduce_scatter")
    src = _to_host(t) if staged else t
    out = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=mesh.group)
    return out.to(t.device) if staged else out


def ring_permute(t: Tensor, mesh: Mesh, shift: int) -> Tensor:
    """``t`` of rank ``r - shift`` on rank ``r`` (modulo the ranks), by one
    send and one receive a rank (no autograd). Each call completes before
    it returns, and each direction has its own tag, so the two halos of
    ``sender_node_table`` cannot swap at 2 ranks."""
    if mesh.size == 1:
        return t.clone()
    t = t.contiguous()
    dst, src = (mesh.rank + shift) % mesh.size, (mesh.rank - shift) % mesh.size
    staged = _staged(mesh, t, "ppermute")
    send = _to_host(t) if staged else t
    recv = torch.empty_like(send)
    tag = _TAGS.get(shift, 10 + shift % mesh.size)
    ops = [dist.P2POp(dist.isend, send, dst, group=mesh.group, tag=tag),
           dist.P2POp(dist.irecv, recv, src, group=mesh.group, tag=tag)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device) if staged else recv


class Psum(torch.autograd.Function):
    """``jax.lax.psum``: the sum over the ranks, its own transpose."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: Mesh) -> Tensor:
        ctx.mesh = mesh
        return all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g: Tensor):
        return Psum.apply(g, ctx.mesh), None


class AllGatherTiled(torch.autograd.Function):
    """``jax.lax.all_gather(tiled=True)``; its transpose is the
    reduce-scatter of the sum."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: Mesh) -> Tensor:
        ctx.mesh = mesh
        return all_gather_tiled(x, mesh)

    @staticmethod
    def backward(ctx, g: Tensor):
        return ReduceScatterTiled.apply(g, ctx.mesh), None


class ReduceScatterTiled(torch.autograd.Function):
    """The reduce-scatter of the sum; its transpose is the tiled
    all-gather."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: Mesh) -> Tensor:
        ctx.mesh = mesh
        return reduce_scatter_tiled(x, mesh)

    @staticmethod
    def backward(ctx, g: Tensor):
        return AllGatherTiled.apply(g, ctx.mesh), None


class PPermute(torch.autograd.Function):
    """``jax.lax.ppermute`` over the ring by ``shift``; its transpose is the
    permutation by ``-shift``."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: Mesh, shift: int) -> Tensor:
        ctx.mesh, ctx.shift = mesh, shift
        return ring_permute(x, mesh, shift)

    @staticmethod
    def backward(ctx, g: Tensor):
        return PPermute.apply(g, ctx.mesh, -ctx.shift), None, None


def psum(x: Tensor, mesh: Mesh) -> Tensor:
    return x if mesh.size == 1 else Psum.apply(x, mesh)


def all_gather(x: Tensor, mesh: Mesh) -> Tensor:
    return x if mesh.size == 1 else AllGatherTiled.apply(x, mesh)


def ppermute(x: Tensor, mesh: Mesh, shift: int) -> Tensor:
    return x if mesh.size == 1 else PPermute.apply(x, mesh, shift)


def psum_tensors(tensors: Sequence[Tensor], mesh: Mesh) -> List[Tensor]:
    """Each tensor's sum over the ranks (``jax.lax.psum`` of a tree), by one
    all-reduce of the flattened tensors (no autograd)."""
    tensors = list(tensors)
    if mesh.size == 1 or not tensors:
        return tensors
    if len({t.dtype for t in tensors}) > 1:
        return [psum_tensors([t], mesh)[0] for t in tensors]
    flat = all_reduce_(torch.cat([t.detach().reshape(-1) for t in tensors]), mesh)
    return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def pmean_tensors(tensors: Sequence[Tensor], mesh: Mesh) -> List[Tensor]:
    """Each tensor's mean over the ranks (``jax.lax.pmean`` of a tree)."""
    if mesh.size == 1:
        return list(tensors)
    return [t / mesh.size for t in psum_tensors(tensors, mesh)]


def pmean_metrics(metrics: Dict[str, Tensor], mesh: Mesh) -> Dict[str, Tensor]:
    """Each metric's mean over the ranks."""
    if mesh.size == 1 or not metrics:
        return dict(metrics)
    names = list(metrics)
    vals = pmean_tensors([torch.as_tensor(metrics[k], dtype=torch.float32,
                                          device=mesh.device) for k in names], mesh)
    return dict(zip(names, vals))


def broadcast_tensors_(tensors: Sequence[Tensor], mesh: Mesh, src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank, in place, by one
    broadcast of the flattened tensors."""
    tensors = list(tensors)
    if mesh.size == 1 or not tensors:
        return
    if len({t.dtype for t in tensors}) > 1:
        for t in tensors:
            broadcast_tensors_([t], mesh, src)
        return
    with torch.no_grad():
        flat = broadcast_(torch.cat([t.detach().reshape(-1) for t in tensors]), mesh, src)
        for v, t in zip(flat.split([t.numel() for t in tensors]), tensors):
            t.copy_(v.view(t.shape))


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every rank's ``obj`` (picklable), in rank order."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out
