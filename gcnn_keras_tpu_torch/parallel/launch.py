"""Starting D ranks for one run: the counterpart of a JAX process that owns
D devices.

``spawn(fn, n_ranks, *args, device=...)`` starts ``n_ranks`` processes (the
``spawn`` start method: each imports afresh, so ``fn`` and ``args`` must
pickle), joins them into a process group through a ``file://`` store in a
temporary directory of its own (no TCP port, so concurrent runs cannot
collide), calls ``fn(mesh, *args)`` on each rank and returns the ranks'
results in rank order. Every group has a timeout, and the ranks are joined
by one deadline: a rank that fails or outlives it fails the call, and the
other ranks are stopped.

Devices: ``device="cpu"`` gives gloo ranks on the CPU; ``"cuda"`` one rank
a card over NCCL, and ``ValueError`` naming both counts where the machine
has fewer cards than ranks, unless ``share_device`` puts every rank on
``cuda:0`` over gloo (NCCL refuses two ranks on one card).

``run_on_ranks`` is the entry points' switch: in this process, on ranks it
spawns (``n_devices``), or on this rank of a launcher's group
(``distributed``), rank 0 alone printing.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60.0


def rank_devices(n_ranks: int, device: str, share_device: bool = False) -> List[str]:
    """The device of each of ``n_ranks`` ranks."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * n_ranks
    if share_device:
        return ["cuda:0"] * n_ranks
    have = torch.cuda.device_count()
    if n_ranks > have:
        raise ValueError(f"{n_ranks} ranks need {n_ranks} CUDA devices, but this machine "
                         f"has {have}")
    return [f"cuda:{r}" for r in range(n_ranks)]


def init_group(rank: int, n_ranks: int, store: str, device: str, backend: str,
               timeout_s: float = GROUP_TIMEOUT_S):
    """Join this process to the group of ``store`` (a file path) as
    ``rank``; returns the rank's mesh."""
    from .mesh import make_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=n_ranks,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return make_mesh(n_ranks, device=dev, n_hosts=1)


def _rank_main(rank, n_ranks, workdir, device, backend, threads, fn, args):
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = init_group(rank, n_ranks, os.path.join(workdir, "store"), device, backend)
        out = fn(mesh, *args)
        tmp = os.path.join(workdir, f"result_{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(workdir, f"result_{rank}.pkl"))
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, *args, device: str = "cuda",
          share_device: bool = False, timeout_s: float = 600.0,
          threads: int = 0) -> list:
    """``[fn(mesh, *args) for each rank]``, each on a rank of its own (the
    module docstring). ``threads``: torch's CPU threads a rank (0: its
    default)."""
    devices = rank_devices(n_ranks, device, share_device)
    # gloo unless every rank has a card of its own
    backend = "gloo" if devices[0] == "cpu" or share_device else "nccl"
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gcnn_ranks_") as workdir:
        procs = [ctx.Process(target=_rank_main, args=(
            r, n_ranks, workdir, devices[r], backend, threads, fn, args))
            for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline or any(p.exitcode not in (None, 0)
                                                      for p in procs):
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10.0)
        errors = []
        results = []
        for r, p in enumerate(procs):
            err = os.path.join(workdir, f"error_{r}.txt")
            res = os.path.join(workdir, f"result_{r}.pkl")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif os.path.exists(res) and p.exitcode == 0:
                with open(res, "rb") as f:
                    results.append(pickle.load(f))
            else:
                errors.append(f"rank {r}: exit code {p.exitcode} "
                              f"({'stopped at the deadline' if p.exitcode is None or p.exitcode < 0 else 'no result'})")
        if errors:
            raise RuntimeError(f"{len(errors)} of {n_ranks} ranks failed:\n" + "\n".join(errors))
    return results


def run_on_ranks(fn: Callable, *args, n_devices: int = 0, distributed: bool = False,
                 device=None):
    """``fn(mesh, *args)`` as a data-parallel entry point's options ask:
    with ``distributed``, on this rank of the group a launcher set up
    (``maybe_initialize_distributed``; ``n_devices``, if given, must be the
    group's size); else with ``n_devices`` above 1 on that many ranks spawned
    here (one a card, or gloo ranks sharing the host's cores under
    ``device="cpu"``), returning rank 0's result; else ``fn(None, *args)``
    in this process. Only rank 0 prints."""
    if distributed:
        from .distributed import maybe_initialize_distributed
        from .mesh import make_mesh
        maybe_initialize_distributed(device=device)
        return _rank0_prints(make_mesh(n_devices or None, device=device), fn, *args)
    if n_devices and n_devices > 1:
        dev = device or "cuda"
        threads = max((os.cpu_count() or 1) // n_devices, 1) if dev == "cpu" else 0
        return spawn(_rank0_prints, n_devices, fn, *args, device=dev, threads=threads)[0]
    return fn(None, *args)


def _rank0_prints(mesh, fn: Callable, *args):
    with open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(sys.stdout if mesh.rank == 0 else null):
        return fn(mesh, *args)
