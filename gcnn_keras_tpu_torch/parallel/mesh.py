"""The device mesh and batch sharding; counterpart of
``gcnn_keras_tpu/parallel/mesh.py``.

The JAX package runs one process over a mesh of devices and places each
device's sub-batch with a ``NamedSharding``. PyTorch runs one process per
device (a rank) in a ``torch.distributed`` process group, so a :class:`Mesh`
here is this rank's view of the group: its size, this rank's index, this
rank's device and the backend (NCCL between CUDA ranks, gloo between CPU
ranks, or CUDA ranks that share one card). A "stacked batch with a leading
device axis" becomes, on each rank, that rank's own sub-batch:
``stack_batches`` stacks D batches on the host and ``shard_stacked_batch``
hands each rank its slice on its device.
"""
from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..batch import GraphBatch
from ..utils.devices import DeviceLike, resolve_device


class Mesh:
    """One rank's view of a 1-D mesh of ``size`` ranks along ``axis``.

    ``group`` is the process group (None: the default group, or no group
    at all when ``size`` is 1); ``backend`` its backend (None without a
    group); ``n_hosts`` the JAX processes the ranks stand for: 1 for ranks
    started together for one run (``n_devices``), the group's size for
    ranks that a launcher started as separate hosts (``distributed``).
    ``transport`` counts each collective by how it reached the backend:
    ``direct``, or ``staged`` through page-locked host memory (CUDA tensors
    over gloo, for the collectives gloo takes on the CPU only)."""

    def __init__(self, size: int, rank: int, device: torch.device,
                 backend: Optional[str] = None, group=None, axis: str = "data",
                 n_hosts: int = 1):
        self.size, self.rank, self.device = int(size), int(rank), torch.device(device)
        self.backend, self.group, self.axis, self.n_hosts = backend, group, axis, int(n_hosts)
        self.transport = {"direct": collections.Counter(), "staged": collections.Counter()}

    def __repr__(self):
        return (f"Mesh(size={self.size}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend}, axis={self.axis!r})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device: DeviceLike = None, n_hosts: Optional[int] = None) -> Mesh:
    """The mesh of this process's group. ``n_devices`` (default: the
    group's size) must equal the group's size: a mesh never shrinks or
    grows silently, so any other count raises ``ValueError`` naming both.
    Outside a process group the mesh has this process alone (``n_devices``
    None or 1). ``device``: this rank's device (the CUDA card's current
    device unless ``device="cpu"``)."""
    from . import distributed
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh(n_devices={n_devices}): this process is in no process group, so "
                f"1 rank is available; start {n_devices} ranks (parallel.launch.spawn, or a "
                f"launcher and maybe_initialize_distributed)")
        return Mesh(1, 0, _rank_device(device), axis=axis)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_mesh(n_devices={n_devices}): the process group has {world} "
                         f"ranks; a mesh spans every rank of it")
    if n_hosts is None:
        n_hosts = world if distributed.joined_as_hosts() else 1
    return Mesh(world, dist.get_rank(), _rank_device(device), dist.get_backend(),
                axis=axis, n_hosts=n_hosts)


def _rank_device(device: DeviceLike) -> torch.device:
    if device is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return resolve_device(device)


def stack_batches(batches: List[GraphBatch]) -> GraphBatch:
    """Stack D same-shape batches along a new leading device axis (numpy
    arrays stay numpy, tensors stay tensors). Static fields must agree."""
    first = batches[0]
    for b in batches[1:]:
        if (b.n_graphs, b.max_nodes) != (first.n_graphs, first.max_nodes):
            raise ValueError("stacked batches must share static shape metadata")
    fields = {}
    for name in first.__dataclass_fields__:
        vals = [getattr(b, name) for b in batches]
        fields[name] = _stack(vals)
    return GraphBatch(**fields)


def _stack(vals):
    v0 = vals[0]
    if isinstance(v0, dict):
        return {k: _stack([v[k] for v in vals]) for k in v0}
    if isinstance(v0, np.ndarray):
        return np.stack(vals, axis=0)
    if isinstance(v0, torch.Tensor):
        return torch.stack(vals, dim=0)
    return v0


def shard_stacked_batch(stacked: GraphBatch, mesh: Mesh) -> GraphBatch:
    """This rank's slice of a stacked batch, as tensors on its device; a
    partitioned batch (``part_axis`` set) has the mesh as its ``part_axis``,
    so that its sender gathers exchange the halo over this group."""
    if stacked.senders.shape[0] != mesh.size:
        raise ValueError(f"a stacked batch of {stacked.senders.shape[0]} sub-batches "
                         f"on a mesh of {mesh.size} ranks")
    local = stacked._map(lambda a: a[mesh.rank]).to(mesh.device)
    if local.part_axis is not None:
        local = local.replace(part_axis=mesh)
    return local
