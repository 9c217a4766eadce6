"""Drive the PyTorch/CUDA port (``gcnn_keras_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card. Phases, in
order, each raising on a failed check:

1. device: card name and power limit, torch and CUDA versions; TF32 off.
2. build: every kernel in ``gcnn_keras_tpu_torch/csrc`` is compiled with
   nvcc (one process per source, all started together).
3. kernel: each kernel against its plain PyTorch version at the shapes of
   the serving path and at edge cases, with times and bounds.
4. serving: ``MolDynamicsModelPredictor(EnergyForceModel(make_model()))`` at
   full SchNet width answers 3 requests of QM9-like molecules; energies and
   forces are checked (finite, translation invariant, equal to the same
   predictor on the CPU), the kernel launch count per evaluation is held to
   its derived value, and the time per evaluation is measured.

Prints ``{"kernels": [...]}``, then the card's name and power limit as
``nvidia-smi`` gives them, and last the line
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 1 and prints
no result.
"""
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2, so each timed launch starts cold
# ~0.1 ms of device sleep before each timed launch: the host queues the
# launch meanwhile, so the timed interval holds no host-side gap
HEAD_START_CYCLES = 200_000
# kernel launches per energy+force evaluation at depth 4 (see PERF.md):
# energy pass 4 pool_edges_to_nodes + 1 pool_nodes_to_graph; force pass the
# transposes of pos_j and pos_i in edge_vectors and of gather_sender_nodes in
# interactions 1-3 (interaction 0's input does not depend on coordinates)
LAUNCHES_PER_EVAL = 10
KERNEL_TOL = 1e-5  # max|kernel - plain| <= KERNEL_TOL * (1 + max|plain|)
SERVE_TOL = 1e-4   # max|gpu - cpu| <= SERVE_TOL * max|cpu|, per output
FORCE_SUM_TOL = 1e-5  # |sum_i F_i| <= FORCE_SUM_TOL * n_atoms * max_i |F_i|


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def qm9_like_mols(seed, n_mols):
    """The JAX package's ``bench.py`` ``_mols`` draws, request fields only."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_range
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_mols):
        n = rs.randint(12, 21)
        g = {"node_number": rs.choice([1, 6, 7, 8, 9], size=n),
             "node_coordinates": (rs.randn(n, 3) * 2.0).astype(np.float32)}
        rs.randn()  # the energy label
        g = set_range(g, max_distance=4.0, max_neighbours=25)
        g["edge_indices"] = g.pop("range_indices")
        rs.randn(n, 3)  # the force label
        graphs.append(g)
    return graphs


def cuda_median_ms(fn, reps, flush=None, before=None):
    """Median device time of ``fn`` over ``reps`` launches, each timed with
    its own CUDA events; ``flush`` is overwritten before each one (L2 cold),
    ``before`` runs before each start event."""
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if before is not None:
            before()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def phase_device():
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from gcnn_keras_tpu_torch.ops.cuda import build
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # always a fresh build
    t0 = time.perf_counter()
    logs = build.build()
    log(f"build: {len(logs)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "ptxas info" in line:
                log(f"  {name}: {line.strip()}")


def check_segment_sum(values, ids, n, label, timed):
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    out = ss.segment_sum(values, ids, n)
    torch.cuda.synchronize()
    plain = ss.segment_sum_plain(values, ids, n)
    scale = 1.0 + (plain.abs().max().item() if plain.numel() else 0.0)
    err = (out - plain).abs().max().item() if out.numel() else 0.0
    if not err <= KERNEL_TOL * scale:
        raise AssertionError(f"segment_sum {label}: max|k-p|={err} > {KERNEL_TOL}*{scale}")
    rec = {"case": label, "E": values.shape[0], "F": values.shape[1], "N": n,
           "max_abs_err": err}
    if timed:
        e, f = values.shape
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=values.device)
        lib_out = torch.zeros(n, f, device=values.device)
        nbytes = 4 * (e * f + e + n * f)
        rec.update(
            ms=cuda_median_ms(lambda: ss.segment_sum(values, ids, n), 50, flush),
            ms_warm=cuda_median_ms(lambda: ss.segment_sum(values, ids, n), 50),
            plain_ms=cuda_median_ms(lambda: ss.segment_sum_plain(values, ids, n), 50, flush),
            library_ms=cuda_median_ms(lambda: lib_out.index_add_(0, ids, values), 50,
                                      flush, before=lib_out.zero_),
            bytes=nbytes,
            bound_ms=1e3 * max(nbytes / H100_BYTES_PER_S, e * f / H100_F32_OPS_PER_S),
            bound_by="bytes" if nbytes / H100_BYTES_PER_S >= e * f / H100_F32_OPS_PER_S
            else "operations")
    log(f"kernel segment_sum {label}: " + json.dumps(rec))
    return rec


def phase_kernel(batch):
    dev = batch.senders.device
    gen = torch.Generator(device=dev).manual_seed(0)
    e, n, g = batch.n_edge, batch.n_node, batch.n_graphs
    senders_sorted = batch.senders[batch.edges["sender_perm"].long()].contiguous()
    shapes = [
        ("messages by receivers", torch.randn(e, 128, generator=gen, device=dev),
         batch.receivers, n),
        ("positions by sorted senders", torch.randn(e, 3, generator=gen, device=dev),
         senders_sorted, n),
        ("readout by graph_id", torch.randn(n, 64, generator=gen, device=dev),
         batch.graph_id, g),
    ]
    recs = [check_segment_sum(v, i, m, label, timed=True) for label, v, i, m in shapes]
    # edge cases: empty segments (every third row), all edges in one
    # segment, F = 1 and F = 5, no edges at all
    few = torch.sort(torch.randint(0, 300, (4000,), generator=gen, device=dev))[0]
    few = (few - few % 3).to(torch.int32)
    edge_cases = [
        ("empty segments", torch.randn(4000, 16, generator=gen, device=dev), few, 301),
        ("one segment", torch.randn(4000, 7, generator=gen, device=dev),
         torch.zeros(4000, dtype=torch.int32, device=dev), 5),
        ("F=1", torch.randn(e, 1, generator=gen, device=dev), batch.receivers, n),
        ("F=5", torch.randn(e, 5, generator=gen, device=dev), batch.receivers, n),
        ("no edges", torch.zeros(0, 4, device=dev),
         torch.zeros(0, dtype=torch.int32, device=dev), 9),
    ]
    recs += [check_segment_sum(v, i, m, label, timed=False) for label, v, i, m in edge_cases]
    return recs


def max_force_sum_violation(results):
    worst = 0.0
    for r in results:
        f = r["force"]
        # float32 rounding of n force vectors, each a sum of larger terms
        tol = FORCE_SUM_TOL * len(f) * np.abs(f).max()
        worst = max(worst, np.abs(f.sum(axis=0)).max() / max(tol, 1e-30))
    return worst


def check_request(results, graphs, label):
    if len(results) != len(graphs):
        raise AssertionError(f"{label}: {len(results)} results for {len(graphs)} graphs")
    for r, g in zip(results, graphs):
        if r["force"].shape != (len(g["node_number"]), 3) or r["energy"].shape != (1,):
            raise AssertionError(f"{label}: shapes {r['force'].shape} {r['energy'].shape}")
        if not (np.isfinite(r["force"]).all() and np.isfinite(r["energy"]).all()):
            raise AssertionError(f"{label}: non-finite output")
    worst = max_force_sum_violation(results)
    if worst > 1.0:
        raise AssertionError(f"{label}: forces do not sum to 0 ({worst:.3g} x tol)")


def compare_gpu_cpu(gpu, cpu):
    errs = {}
    for key in ("energy", "force"):
        a = np.concatenate([r[key] for r in gpu])
        b = np.concatenate([r[key] for r in cpu])
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        if not err <= SERVE_TOL * scale:
            raise AssertionError(f"gpu vs cpu {key}: max|d|={err} > {SERVE_TOL}*{scale}")
        errs[key] = {"max_abs_err": err, "max_abs_cpu": scale}
    return errs


def make_predictor(device):
    """The serving stack at full SchNet width with weights from seed 0."""
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.schnet import make_model
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    model = make_model(device=device, generator=torch.Generator().manual_seed(0))
    return MolDynamicsModelPredictor(EnergyForceModel(model, device=device),
                                     device=device)


def phase_serving(gpu, requests, batch0, smi):
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss

    # the main path: every count set to 0 just before, read just after
    ss.launches = 0
    answers, per_request = [], []
    for label, graphs in requests:
        before = ss.launches
        answers.append(gpu(graphs))
        torch.cuda.synchronize()
        per_request.append(ss.launches - before)
    main_launches = ss.launches
    for (label, graphs), res, count in zip(requests, answers, per_request):
        check_request(res, graphs, label)
        if count != LAUNCHES_PER_EVAL:
            raise AssertionError(f"{label}: {count} segment_sum launches, "
                                 f"expected {LAUNCHES_PER_EVAL}")
        log(f"serving {label}: ok, {count} segment_sum launches")

    cpu = make_predictor("cpu")
    for (name, wg), (_, wc) in zip(gpu.model.energy_model.state_dict().items(),
                                   cpu.model.energy_model.state_dict().items()):
        if not torch.equal(wg.cpu(), wc):
            raise AssertionError(f"weights differ between devices: {name}")
    t0 = time.perf_counter()
    cpu_answer = cpu(requests[0][1])
    cpu_s = time.perf_counter() - t0
    check_request(cpu_answer, requests[0][1], "cpu " + requests[0][0])
    errs = compare_gpu_cpu(answers[0], cpu_answer)
    log(f"serving gpu vs cpu ({requests[0][0]}, cpu {cpu_s:.2f} s): " + json.dumps(errs))

    # time one energy+force evaluation on the prepared full-width batch
    model = gpu.model
    for _ in range(3):
        model(batch0)
    torch.cuda.synchronize()
    reps = 30
    ss.launches = 0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model(batch0)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    if ss.launches != reps * LAUNCHES_PER_EVAL:
        raise AssertionError(f"timed loop: {ss.launches} launches for {reps} evaluations")
    req_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        gpu(requests[0][1])
        req_times.append(1e3 * (time.perf_counter() - t0))
    real_edges = int(batch0.edge_mask.sum().item())
    ms = float(np.median(times))
    cfg = gpu.model.energy_model.config
    serving = {"n_mols": len(requests[0][1]), "units": cfg["interaction_args"]["units"],
               "depth": cfg["depth"], "N_pad": batch0.n_node,
               "E_pad": batch0.n_edge, "G": batch0.n_graphs, "real_edges": real_edges,
               "ms_per_eval": ms,
               "edges_per_s": real_edges / (ms * 1e-3),
               "ms_per_request": float(np.median(req_times)),
               "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
               "launches_per_eval": LAUNCHES_PER_EVAL, "card": smi}
    log("serving timing: " + json.dumps(serving))
    return main_launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing run", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    gpu = make_predictor("cuda")
    requests = [("seed 0, 512 mols", qm9_like_mols(0, 512)),
                ("seed 1, 512 mols", qm9_like_mols(1, 512)),
                ("seed 2, 64 mols", qm9_like_mols(2, 64))]
    _, batch0 = gpu.make_batch(requests[0][1])
    if (batch0.n_node, batch0.n_edge, batch0.n_graphs) != (8192, 54784, 513):
        raise AssertionError(f"unexpected full-width shapes {batch0.n_node} "
                             f"{batch0.n_edge} {batch0.n_graphs}")
    recs = phase_kernel(batch0)
    launches = phase_serving(gpu, requests, batch0, smi)
    main_rec = recs[0]
    kernels = {"kernels": [{
        "name": "sorted_segment_sum", "route": "cuda",
        "source": "gcnn_keras_tpu_torch/csrc/segment_sum.cu",
        "replaces": "gcnn_keras_tpu/ops/pallas/segment_sum.py:182",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "shapes": recs,
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
