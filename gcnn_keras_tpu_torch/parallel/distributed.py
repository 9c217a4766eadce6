"""Joining a process group that a launcher set up, and sharding the data by
host; counterpart of ``gcnn_keras_tpu/parallel/distributed.py``.

The JAX package joins processes into one global device mesh with
``jax.distributed.initialize``. Here each process is one rank of a
``torch.distributed`` group: ``maybe_initialize_distributed`` joins it from
explicit arguments, else torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), else the JAX
names (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``); with none of them it does nothing and returns False,
as the JAX function does. A rank takes ``cuda:LOCAL_RANK`` over NCCL where
its host has a card for each of its ranks, and otherwise gloo: on the CPU,
or where ranks share a card (``LOCAL_WORLD_SIZE`` above the card count).
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# whether this process joined its group here, as one host of several
_joined = False


def joined_as_hosts() -> bool:
    """Whether ``maybe_initialize_distributed`` joined this process's
    group (each rank then stands for a JAX process of its own)."""
    return _joined


def _env_int(*names) -> Optional[int]:
    for n in names:
        if os.environ.get(n) is not None:
            return int(os.environ[n])
    return None


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device: Optional[str] = None,
                                 timeout_s: float = 60.0) -> bool:
    """Join the process group the arguments or the environment describe
    (module docstring); a no-op returning False when nothing describes one.
    ``coordinator_address`` is ``host:port`` (a TCP store) or a
    ``file://`` URL. ``device``: ``"cpu"`` for gloo ranks on the CPU; by
    default the card. Returns True once a group is active."""
    global _joined
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        else:
            coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs its address, its size and this process's "
                         f"rank: got {coordinator_address!r}, {num_processes}, {process_id}")
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    local_rank = _env_int("LOCAL_RANK") or 0
    local_size = _env_int("LOCAL_WORLD_SIZE") or 1
    cuda = device != "cpu"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        own_card = local_size <= torch.cuda.device_count()
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = "nccl" if cuda and own_card else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=int(num_processes),
                            rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))
    _joined = True
    logger.info("process group joined: rank %d of %d over %s", dist.get_rank(),
                dist.get_world_size(), backend)
    return True


def host_shard_indices(num_samples: int,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None,
                       seed: int = 0,
                       drop_remainder: bool = True) -> np.ndarray:
    """The (shuffled) sample indices this host loads: every host calls with
    the same ``num_samples`` and ``seed``, so the shards partition the data.
    With ``drop_remainder`` the shards are equal-sized (every host takes the
    same number of steps an epoch). Defaults: this rank and the group's
    size where this process joined as a host, else 0 of 1."""
    hosts = dist.is_initialized() and joined_as_hosts()
    pi = (dist.get_rank() if hosts else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if hosts else 1) if process_count is None else process_count
    order = np.random.RandomState(seed).permutation(num_samples)
    if drop_remainder:
        per_host = num_samples // pc
        return order[pi * per_host:(pi + 1) * per_host]
    return order[pi::pc]


def local_batch_iterator(graphs: Sequence, batch_size: int, mesh,
                         seed: int = 0, global_keys: Sequence[str] = (), **batch_kwargs):
    """The DP loader of one host: its shard of ``graphs``
    (``host_shard_indices``) in shuffled batches on this rank's device,
    grouped by ``dp_batch_iterator``."""
    from ..data.loader import GraphBatchLoader
    from .data_parallel import dp_batch_iterator

    idx = host_shard_indices(len(graphs), seed=seed)
    local = [graphs[i] for i in idx]
    loader = GraphBatchLoader(local, batch_size, shuffle=True, seed=seed,
                              global_keys=tuple(global_keys), device=mesh.device,
                              **batch_kwargs)
    return dp_batch_iterator(loader, mesh)
