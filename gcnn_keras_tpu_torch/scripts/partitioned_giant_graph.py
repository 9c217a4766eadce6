"""SchNet on one edge-partitioned giant graph; counterpart of the root
``examples/partitioned_giant_graph.py``.

    python -m gcnn_keras_tpu_torch.scripts.partitioned_giant_graph
        [--nodes 20000] [--neighbors 6] [--devices D] [--depth 4]
        [--units 64] [--train-steps 0] [--check] [--device cpu]

The graph: ``--nodes`` random points in a long box (locality along x, 2000
nodes a unit of length) with their ``--neighbors`` nearest neighbours within
0.35 (the C++ neighbour list), elements H, C, O. ``prepare_partitioned``
cuts it into D blocks (the halo exchange where the partition allows it,
else the all-gather), and D ranks (``parallel.launch.spawn``: gloo ranks on
the CPU under ``--device cpu``, else one a card over NCCL, or every rank on
the one card over gloo where the machine has fewer cards than ranks) run
SchNet (``--depth``, ``--units``, 20 Gaussians to 1.0; weights from seed
0) on their shards: the energy and every node's forces, and with
``--train-steps N`` N Adam(1e-4) steps of ``E^2 + mean |F|^2`` (references
0). ``--check`` holds the energy and forces against the same model on the
whole graph on one device, to ``tests/test_partitioned_model.py``'s
tolerances of its 100 000-node case (energy rtol 1e-5, forces rtol 1e-3 /
atol 5e-5), and exits 1 outside them. ``--devices`` defaults to the
machine's cards (1 on the CPU).
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

# --check: tests/test_partitioned_model.py test_partitioned_schnet_100k_nodes
ENERGY_RTOL = 1e-5
FORCE_RTOL, FORCE_ATOL = 1e-3, 5e-5


def parser() -> argparse.ArgumentParser:
    """The JAX example's arguments, and ``--device`` (the CUDA card unless
    ``cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--neighbors", type=int, default=6)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--units", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=0,
                    help="also run N partitioned optimizer steps")
    ap.add_argument("--check", action="store_true",
                    help="compare against the single-device oracle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return ap


def giant_graph(n: int, neighbors: int, seed: int = 0):
    """``(z, pos, senders, receivers)`` of the JAX example's graph."""
    from gcnn_keras_tpu_torch import native
    rs = np.random.RandomState(seed)
    pos = rs.rand(n, 3).astype(np.float32)
    pos[:, 0] *= n / 2000.0
    res = native.neighbor_list(pos, cutoff=0.35, max_neighbors=neighbors)
    if res is None:
        raise SystemExit("native neighbor list unavailable")
    pairs, _ = res
    recv, send = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    z = rs.choice([1, 6, 8], size=n).astype(np.int32)
    return z, pos, send, recv


def make_model(args, device):
    from gcnn_keras_tpu_torch.models import schnet
    return schnet.make_model(device=device, generator=torch.Generator().manual_seed(0),
                             depth=args.depth, interaction_args={"units": args.units},
                             gauss_args={"bins": 20, "distance_max": 1.0, "sigma": 0.1})


def run_rank(mesh, args, pin):
    """One rank: the partitioned energy and forces (every rank gathers
    them) and the train steps; returns ``(energy, forces (N, 3) in the
    ORIGINAL order, losses)``. Rank 0 alone prints."""
    from gcnn_keras_tpu_torch.parallel.collectives import broadcast_tensors_
    from gcnn_keras_tpu_torch.parallel.partitioned import (
        make_partitioned_train_step, rank_shard, run_partitioned_energy_force,
        shard_node_array)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    model = make_model(args, mesh.device)
    broadcast_tensors_(list(model.parameters()), mesh)
    t0 = time.perf_counter()
    e, f = run_partitioned_energy_force(model, pin, mesh)
    say(f"energy={e:.4f}, |F|max={np.abs(f).max():.4f}  "
        f"(first call: {time.perf_counter() - t0:.2f}s)", flush=True)
    losses = []
    if args.train_steps:
        step = make_partitioned_train_step(model, mesh,
                                           functools.partial(torch.optim.Adam, lr=1e-4))
        state = step.init_state()
        shard = rank_shard(pin, mesh)
        f_ref = torch.as_tensor(shard_node_array(pin, np.zeros((len(pin.order), 3), np.float32))
                                [mesh.rank], device=mesh.device)
        for i in range(args.train_steps):
            t0 = time.perf_counter()
            state, metrics = step(state, shard, 0.0, f_ref)
            losses.append(float(metrics["loss"]))
            say(f"train step {i}: loss={losses[-1]:.4f} "
                f"({time.perf_counter() - t0:.2f}s)", flush=True)
    return e, f, losses


def check(args, z, pos, send, recv, e, f, device) -> dict:
    """The single-device oracle against the partitioned energy and forces."""
    from gcnn_keras_tpu_torch.parallel.partitioned import single_graph_batch
    model = make_model(args, device)
    ob = single_graph_batch(z, pos, send, recv, device=device)
    p = ob.nodes["node_coordinates"].detach().requires_grad_(True)
    e_ref = model(ob.replace_nodes(node_coordinates=p))["output"][0, 0]
    (g,) = torch.autograd.grad(e_ref, p)
    f_ref = -g.detach().cpu().numpy()[:len(z)]
    e_ref = float(e_ref.detach())
    ferr = np.abs(f - f_ref)
    ok = (abs(e - e_ref) <= ENERGY_RTOL * abs(e_ref)
          and bool(np.all(ferr <= FORCE_ATOL + FORCE_RTOL * np.abs(f_ref))))
    print(f"single-device oracle: energy diff {abs(e - e_ref):.2e}, force diff "
          f"{ferr.max():.2e} ({'within' if ok else 'OUTSIDE'} the tolerances)")
    return {"ok": ok, "energy_oracle": e_ref, "energy_diff": abs(e - e_ref),
            "force_diff": float(ferr.max())}


def main(argv: Optional[List[str]] = None) -> dict:
    """The example (module docstring); returns its numbers. With ``--check``
    a result outside the tolerances exits 1."""
    from gcnn_keras_tpu_torch.parallel import launch
    from gcnn_keras_tpu_torch.parallel.partitioned import prepare_partitioned
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    n_ranks = args.devices or cards
    z, pos, send, recv = giant_graph(args.nodes, args.neighbors)
    print(f"{args.nodes} nodes, {len(send)} edges")
    t0 = time.perf_counter()
    pin = prepare_partitioned(z, pos, send, recv, n_ranks)
    share = device.type == "cuda" and n_ranks > cards
    print(f"partitioned over {n_ranks} ranks in {time.perf_counter() - t0:.2f}s: "
          f"halo={pin.halo_size} rows, remote-sender fraction={pin.remote_fraction:.3%} "
          f"({'ring halo' if pin.halo_size else 'all-gather'} strategy"
          f"{', the ranks sharing one card over gloo' if share else ''})", flush=True)
    t0 = time.perf_counter()
    # CPU ranks share the host's cores
    threads = max((os.cpu_count() or 1) // n_ranks, 1) if device.type == "cpu" else 0
    e, f, losses = launch.spawn(run_rank, n_ranks, args, pin, device=device.type,
                                share_device=share, threads=threads)[0]
    out = {"nodes": args.nodes, "edges": int(len(send)), "ranks": n_ranks,
           "halo_size": pin.halo_size, "remote_fraction": pin.remote_fraction,
           "energy": e, "losses": losses, "seconds": time.perf_counter() - t0}
    if args.check:
        out.update(check(args, z, pos, send, recv, e, f, device))
        if not out["ok"]:
            raise SystemExit(1)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
