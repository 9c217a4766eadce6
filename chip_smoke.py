"""Drive the PyTorch/CUDA port (``gcnn_keras_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card. Phases, in
order, each raising on a failed check:

1. device: card name and power limit, torch and CUDA versions; TF32 off.
2. build: every kernel in ``gcnn_keras_tpu_torch/csrc`` is compiled with
   nvcc (one process per source, all started together).
3. kernel: the sorted segment-sum against its plain PyTorch version at the
   shapes of the SchNet serving path and at edge cases, with times and
   bounds.
4. serving: ``MolDynamicsModelPredictor(EnergyForceModel(make_model()))`` at
   full SchNet width answers 3 requests of QM9-like molecules; energies and
   forces are checked (finite, translation invariant, equal to the same
   predictor on the CPU), the kernel launch count per evaluation is held to
   its derived value, and the time per evaluation is measured.
5. ACSF kernels: the four G2/G4 kernels (forward and force pass) against
   their plain versions at the HDNNP2nd serving shapes and at edge cases,
   with times and bounds.
6. HDNNP2nd serving: the Behler-mode HDNNP2nd of the JAX package's bench
   configuration, with ``set_angle`` as the graph preprocessor, answers the
   same 3 requests, checked as in phase 4, with every kernel's launch count
   per evaluation held to its derived value.
7. SPD solve kernel: the batched Gauss-Jordan solve against its plain
   version on the Qeq system that ``CENTCharge`` assembles from the first
   HDNNP4th request, with times and bounds, and at edge cases (G = 1,
   M = 1, M at the shared-memory gate, K = 1, the padding graph's identity
   system, an empty graph whose bordered corner is 1).
8. HDNNP4th serving: the flagship HDNNP4th of the JAX package's bench
   configuration with ESP coupling answers the same 3 requests, each
   molecule given an ESP, its gradient and a total charge of -1, 0 or +1;
   charges, energies and forces are checked (finite, charges summing to the
   total charge, forces summing to 0 where the ESP gradient is 0, equal to
   the same predictor on the CPU), with every kernel's launch count per
   evaluation held to its derived value.

Prints ``{"kernels": [...]}``, then the card's name and power limit as
``nvidia-smi`` gives them, and last the line
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 1 and prints
no result.
"""
import functools
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
# special-function results (exp2, log2, sin, cos, rsqrt, rcp): 16 per clock
# per SM (CUDA programming guide, compute capability 9.0) x 132 SMs x the
# 1.98 GHz boost clock of the H100 SXM
H100_SFU_PER_S = 16 * 132 * 1.98e9
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
# ACSF kernels: max|kernel - plain| <= tol * (1 + max|plain|), and in the
# forward pass also, for each set s, max|kernel - plain| over its columns
# <= tol * max|plain| over them. The forward sums each output in another
# order than index_add_ (shared-memory atomics); the force pass adds terms
# of both signs with float atomics, in an order that varies from run to run
ACSF_FWD_TOL = 1e-5
ACSF_VJP_TOL = 1e-4
# the JAX package's HDNNP2nd bench configuration (bench.py
# bench_hdnnp2nd_model), written out: G2 4 sets x 5 elements, G4 8 sets x 15
# element pairs, a [64, 64, 1] network per atomic number
HDNNP_ELEMENTS = [1, 6, 7, 8, 9]
HDNNP2ND_KW = dict(
    g2_kwargs={"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 4.0, "elements": HDNNP_ELEMENTS},
    g4_kwargs={"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "rc": 4.0,
               "zeta": [1.0, 8.0], "elements": HDNNP_ELEMENTS, "multiplicity": 2.0},
    mlp_kwargs={"units": [64, 64, 1], "num_relations": 10,
                "activation": ["swish", "swish", "linear"]})
HDNNP_SHAPES = (8192, 54784, 417024, 513)  # N, E, A, G of the seed-0 request
# kernel launches per HDNNP2nd energy+force evaluation: the energy pass runs
# the G2 and G4 forward kernels and pools atoms to molecules (one
# segment-sum); the force pass runs the G4 and G2 vjp kernels, and the
# backward of the pool is a gather, which launches nothing
HDNNP_LAUNCHES = {"g2_fwd": 1, "g4_fwd": 1, "g4_vjp": 1, "g2_vjp": 1,
                  "sorted_segment_sum": 1, "spd_solve": 0}
# the TPU kernel each ACSF kernel replaces (its pl.pallas_call line)
ACSF_REPLACES = {"g2_fwd": "gcnn_keras_tpu/ops/pallas/fused_g4.py:1088",
                 "g4_fwd": "gcnn_keras_tpu/ops/pallas/fused_g4.py:660",
                 "g4_vjp": "gcnn_keras_tpu/ops/pallas/fused_g4.py:729",
                 "g2_vjp": "gcnn_keras_tpu/ops/pallas/fused_g4.py:1147"}
FORCE_SUM_TOL = 1e-5  # |sum_i F_i| <= FORCE_SUM_TOL * n_atoms * max_i |F_i|
# the JAX package's flagship HDNNP4th bench configuration (bench.py
# bench_hdnnp4th_model), written out: the ACSF tables of HDNNP2ND_KW, a
# [64, 64, 1] network per atomic number for chi and for the local energies,
# fixed physical Qeq tables, the default dense Cholesky (Schur) Qeq solve
HDNNP4TH_KW = dict(
    g2_kwargs=HDNNP2ND_KW["g2_kwargs"], g4_kwargs=HDNNP2ND_KW["g4_kwargs"],
    mlp_charge_kwargs=HDNNP2ND_KW["mlp_kwargs"], mlp_local_kwargs=HDNNP2ND_KW["mlp_kwargs"],
    electrostatic_kwargs={"param_trainable": False})
# kernel launches per HDNNP4th energy+force evaluation (see PERF.md): the
# energy pass runs the G2 and G4 forward kernels, the Qeq solve (one
# spd_solve with K = 2) and three sorted sums over graph_id (the self
# energy, the QM/MM energy and the short-range pool; the pair energy is an
# unsorted sum over edge_graph_id); the force pass runs the G4 and G2 vjp
# kernels, the adjoint Qeq solve (one spd_solve) and the transposes of the
# receiver and sender gathers of the [pos|sigma|q] table (two sorted sums)
HDNNP4TH_LAUNCHES = {"g2_fwd": 1, "g4_fwd": 1, "g4_vjp": 1, "g2_vjp": 1,
                     "sorted_segment_sum": 5, "spd_solve": 2}
HDNNP4TH_M = 20  # max_nodes of the three requests: the Qeq systems are 20 x 20
# SPD solve: max|kernel - plain| <= SPD_TOL * (1 + max|plain|) and
# max|A x - b| <= SPD_RESIDUAL_TOL * (1 + max|b|)
SPD_TOL, SPD_RESIDUAL_TOL = 1e-5, 1e-4
# charges of a molecule sum to its total charge within CHARGE_TOL * (1 + sum|q|)
CHARGE_TOL = 1e-4


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


def compare_gpu_cpu(gpu, cpu, keys=("energy", "force")):
    errs = {}
    for key in keys:
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


def acsf_work(name, st, n_node, n_rows, n_real):
    """What the function of kernel ``name`` needs on these inputs: the bytes
    of each input read once and each output written once, and for each of
    the ``n_real`` unmasked rows its float32 adds and multiplies (an FMA is
    2) and its special-function results. Those are, per row, one rsqrt per
    distance (it gives r and 1/r); per unique eta one exp; per unique
    (zeta, lambda) one log2 and one exp2 for the power, and in the force
    pass one more exp2 for its derivative (the log2 is shared); per unique
    r_c and distance one cos, and in the force pass one sin. Returns
    ``(bytes, bound_ms, bound_by)``."""
    g4, fwd = name.startswith("g4"), name.endswith("fwd")
    m = len(st.eta_inv) if g4 else len(st.sets)
    width = st.num_rel * m
    nbytes = (n_node * (3 * 4 + 4)                    # positions, atomic numbers
              + n_rows * ((3 if g4 else 2) * 4 + 1)   # index rows, mask
              + n_node * width * 4                    # G written, or ct read
              + (0 if fwd else n_node * 3 * 4))       # dpos written
    if g4:
        # geometry: 3 difference vectors (9), 3 squared norms and a dot (20),
        # r = r^2 rsqrt (3), cos (2), s^2 (2)
        ne, nz, nr = len(st.uniq_eta), len(st.uniq_zl), len(st.uniq_rc)
        if fwd:
            sfu = 3 + ne + 2 * nz + 3 * nr
            ops = 36 + ne + 4 * nz + 11 * nr + 3 * m
        else:
            # 5 geometry cotangents accumulated per set, then 3 vector
            # cotangents and their 3 scatters (about 72)
            sfu = 3 + ne + 3 * nz + 6 * nr
            ops = 108 + 2 * ne + 6 * nz + 19 * nr + 13 * m
    else:
        nr = len({s[2] for s in st.sets})
        if fwd:
            sfu = 1 + m + nr
            ops = 9 + 5 * m + 3 * nr
        else:
            sfu = 1 + m + 2 * nr
            ops = 19 + 10 * m + 4 * nr
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(n_real * ops / H100_F32_OPS_PER_S, n_real * sfu / H100_SFU_PER_S)
    return nbytes, 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def acsf_args(name, batch):
    pos = batch.nodes["node_coordinates"]
    z = batch.nodes["node_number"].to(torch.int32)
    if name.startswith("g4"):
        return (pos, z, batch.angles, batch.angle_mask), batch.angle_mask
    return (pos, z, batch.senders, batch.receivers, batch.edge_mask), batch.edge_mask


def check_acsf(name, st, batch, label, timed):
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    kernel, plain = {"g2_fwd": (ka.g2_forward, ka.g2_forward_plain),
                     "g4_fwd": (ka.g4_forward, ka.g4_forward_plain),
                     "g4_vjp": (ka.g4_vjp, ka.g4_vjp_plain),
                     "g2_vjp": (ka.g2_vjp, ka.g2_vjp_plain)}[name]
    args, mask = acsf_args(name, batch)
    if name.endswith("vjp"):
        m = len(st.eta_inv) if name.startswith("g4") else len(st.sets)
        gen = torch.Generator(device=mask.device).manual_seed(1)
        args = args + (torch.randn(batch.n_node, st.num_rel * m, generator=gen,
                                   device=mask.device),)
    out = kernel(*args, st)
    torch.cuda.synchronize()
    ref = plain(*args, st)
    tol = ACSF_FWD_TOL if name.endswith("fwd") else ACSF_VJP_TOL
    scale = 1.0 + (ref.abs().max().item() if ref.numel() else 0.0)
    err = (out - ref).abs().max().item() if ref.numel() else 0.0
    if out.shape != ref.shape or not torch.isfinite(out).all() or not err <= tol * scale:
        raise AssertionError(f"{name} {label}: max|k-p|={err} > {tol}*{scale}")
    n_rows, n_real = mask.shape[0], int(mask.sum().item())
    rec = {"case": label, "N": batch.n_node, "rows": n_rows, "real_rows": n_real,
           "max_abs_err": err}
    if name.endswith("fwd") and ref.numel():
        # each set's columns against their own largest value, so that small
        # sets are held as tightly as the largest: every term of a forward
        # sum is >= 0, so an output's error is relative to its value
        m = len(st.eta_inv) if name.startswith("g4") else len(st.sets)
        err_s = (out - ref).abs().reshape(-1, m).amax(0)
        scale_s = ref.abs().reshape(-1, m).amax(0)
        rel = (err_s / scale_s.clamp_min(1e-30)).max().item()
        if not bool((err_s <= tol * scale_s).all()):
            raise AssertionError(f"{name} {label}: per-set max|k-p| {err_s.tolist()} "
                                 f"> {tol} x per-set max|p| {scale_s.tolist()}")
        rec["max_rel_err_per_set"] = rel
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=mask.device)
        nbytes, bound_ms, bound_by = acsf_work(name, st, batch.n_node, n_rows, n_real)
        rec.update(
            ms=cuda_median_ms(lambda: kernel(*args, st), 50, flush),
            ms_warm=cuda_median_ms(lambda: kernel(*args, st), 50),
            plain_ms=cuda_median_ms(lambda: plain(*args, st), 20, flush),
            library_ms=None, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel {name} {label}: " + json.dumps(rec))
    return rec


def acsf_edge_batch(dev):
    """A collinear triple (1 + cos = 0: the clamped cosine derivative), an
    atom with one neighbour and one with none (no angles), and atomic
    numbers outside the table (S, Cl), with padding rows."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    graphs = [
        {"node_number": np.array([6, 6, 6]),
         "node_coordinates": np.array([[0, 0, 0], [1.0, 0, 0], [-2.0, 0, 0]], np.float32),
         "edge_indices": np.array([[0, 1], [0, 2], [1, 0], [2, 0]])},
        {"node_number": np.array([1, 8, 16]),
         "node_coordinates": np.array([[0, 0, 0], [0.9, 0, 0], [9.0, 9, 9]], np.float32),
         "edge_indices": np.array([[0, 1], [1, 0]])},
        {"node_number": np.array([17, 6, 1, 16]),
         "node_coordinates": np.array([[0, 0, 0], [1.5, 0, 0], [0, 1.2, 0],
                                       [0, 0, 1.8]], np.float32),
         "edge_indices": np.array([[i, j] for i in range(4) for j in range(4) if i != j])},
    ]
    graphs = [set_angle(g, range_indices="edge_indices") for g in graphs]
    return batch_graphs(graphs, device=dev, n_angle_pad=64, n_edge_pad=64)


def phase_acsf_kernel(batch, model):
    """Each ACSF kernel against its plain version at the full-width shapes
    of ``batch`` (timed) and at edge cases."""
    dev = batch.senders.device
    statics = {"g2": model.acsf_g2._static, "g4": model.acsf_g4._static}
    edge = acsf_edge_batch(dev)
    masked = edge.replace(angle_mask=torch.zeros_like(edge.angle_mask),
                          edge_mask=torch.zeros_like(edge.edge_mask))
    none = edge.replace(angles=torch.zeros(0, 3, dtype=torch.int32, device=dev),
                        angle_mask=torch.zeros(0, dtype=torch.bool, device=dev),
                        senders=torch.zeros(0, dtype=torch.int32, device=dev),
                        receivers=torch.zeros(0, dtype=torch.int32, device=dev),
                        edge_mask=torch.zeros(0, dtype=torch.bool, device=dev))
    recs = {}
    for name in ("g2_fwd", "g4_fwd", "g4_vjp", "g2_vjp"):
        st = statics[name[:2]]
        recs[name] = [check_acsf(name, st, batch, "HDNNP2nd serving, 512 mols", True),
                      check_acsf(name, st, edge, "collinear, no angles, unknown element",
                                 False),
                      check_acsf(name, st, masked, "all rows masked", False),
                      check_acsf(name, st, none, "no rows", False)]
        if recs[name][2]["max_abs_err"] != 0.0 or recs[name][3]["max_abs_err"] != 0.0:
            raise AssertionError(f"{name}: masked or absent rows gave output")
    return recs


def make_hdnnp_predictor(device):
    """HDNNP2nd serving at the bench width with weights from seed 0;
    angles come from ``set_angle`` as a graph preprocessor."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.hdnnp2nd import make_model_behler
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    model = make_model_behler(device=device, generator=torch.Generator().manual_seed(0),
                              **HDNNP2ND_KW)
    return MolDynamicsModelPredictor(
        EnergyForceModel(model, device=device),
        graph_preprocessors=[functools.partial(set_angle, range_indices="edge_indices")],
        device=device)


def hdnnp_counts():
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    return dict(ka.launches, sorted_segment_sum=ss.launches, spd_solve=ks.launches)


def reset_counts():
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    ss.launches = 0
    ks.launches = 0
    for k in ka.launches:
        ka.launches[k] = 0


def phase_hdnnp_serving(gpu, requests, batch0, smi, name="hdnnp2nd",
                        make_cpu=make_hdnnp_predictor, expected=HDNNP_LAUNCHES,
                        check=check_request, keys=("energy", "force")):
    """Serving phase of an ACSF model (HDNNP2nd, or HDNNP4th with the
    arguments of phase 8)."""
    # the main path: every count set to 0 just before, read just after
    reset_counts()
    answers, per_request = [], []
    for label, graphs in requests:
        before = hdnnp_counts()
        answers.append(gpu(graphs))
        torch.cuda.synchronize()
        per_request.append({k: v - before[k] for k, v in hdnnp_counts().items()})
    main_launches = hdnnp_counts()
    for (label, graphs), res, counts in zip(requests, answers, per_request):
        check(res, graphs, f"{name} {label}")
        if counts != expected:
            raise AssertionError(f"{name} {label}: launches {counts}, "
                                 f"expected {expected}")
        log(f"{name} serving {label}: ok, launches {json.dumps(counts)}")

    cpu = make_cpu("cpu")
    for (wname, wg), (_, wc) in zip(gpu.model.energy_model.state_dict().items(),
                                    cpu.model.energy_model.state_dict().items()):
        if not torch.equal(wg.cpu(), wc):
            raise AssertionError(f"weights differ between devices: {wname}")
    t0 = time.perf_counter()
    cpu_answer = cpu(requests[0][1])
    cpu_s = time.perf_counter() - t0
    check(cpu_answer, requests[0][1], f"{name} cpu {requests[0][0]}")
    errs = compare_gpu_cpu(answers[0], cpu_answer, keys)
    log(f"{name} serving gpu vs cpu ({requests[0][0]}, cpu {cpu_s:.2f} s): "
        + json.dumps(errs))

    # time one energy+force evaluation on the prepared full-width batch
    model = gpu.model
    for _ in range(3):
        model(batch0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 30
    reset_counts()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model(batch0)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    if hdnnp_counts() != {k: reps * v for k, v in expected.items()}:
        raise AssertionError(f"{name} timed loop: launches {hdnnp_counts()} "
                             f"for {reps} evaluations")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    req_times, batch_times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        gpu(requests[0][1])
        req_times.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        gpu.make_batch(requests[0][1])  # set_angle and batching, on the host
        torch.cuda.synchronize()
        batch_times.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(times))
    real_angles = int(batch0.angle_mask.sum().item())
    serving = {"n_mols": len(requests[0][1]), "N_pad": batch0.n_node,
               "E_pad": batch0.n_edge, "A_pad": batch0.angles.shape[0],
               "G": batch0.n_graphs, "real_edges": int(batch0.edge_mask.sum().item()),
               "real_angles": real_angles, "ms_per_eval": ms,
               "ms_per_eval_min": float(np.min(times)),
               "angles_per_s": real_angles / (ms * 1e-3),
               "ms_per_request": float(np.median(req_times)),
               "ms_make_batch": float(np.median(batch_times)),
               "max_nodes": batch0.max_nodes, "peak_mem_mb": peak_mb,
               "launches_per_eval": expected, "card": smi}
    log(f"{name} serving timing: " + json.dumps(serving))
    return main_launches


def with_esp(graphs, seed, zero_esp_grad=False):
    """HDNNP4th request fields for the molecules of ``qm9_like_mols``: an
    ESP and its gradient drawn as ``bench.py`` ``_mols`` draws them, from
    their own ``RandomState(100 + seed)`` so that the geometry is the same,
    and total charges -1, 0, +1 in turn. ``zero_esp_grad``: no external
    field gradient, so that the forces of each molecule sum to 0."""
    rs = np.random.RandomState(100 + seed)
    out = []
    for i, g in enumerate(graphs):
        n = len(g["node_number"])
        esp = (rs.randn(n) * 0.02).astype(np.float32)
        esp_grad = (rs.randn(n, 3) * 0.02).astype(np.float32)
        out.append(dict(g, esp=esp,
                        esp_grad=np.zeros_like(esp_grad) if zero_esp_grad else esp_grad,
                        total_charge=np.array([float(i % 3 - 1)], np.float32)))
    return out


def make_hdnnp4th_predictor(device):
    """HDNNP4th serving at the bench width with ESP coupling and weights
    from seed 0; angles come from ``set_angle`` as a graph preprocessor."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.hdnnp4th import make_model_behler
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    model = make_model_behler(device=device, generator=torch.Generator().manual_seed(0),
                              **HDNNP4TH_KW)
    return MolDynamicsModelPredictor(
        EnergyForceModel(model, use_esp_coupling=True, device=device),
        graph_preprocessors=[functools.partial(set_angle, range_indices="edge_indices")],
        device=device)


def check_charged_request(results, graphs, label):
    """Shapes, finite values, the Qeq constraint on every molecule, and the
    force sum where no molecule has an ESP gradient (the ESP coupling force
    is external)."""
    if len(results) != len(graphs):
        raise AssertionError(f"{label}: {len(results)} results for {len(graphs)} graphs")
    worst_q = 0.0
    for r, g in zip(results, graphs):
        n = len(g["node_number"])
        if (r["force"].shape, r["energy"].shape, r["charge"].shape) != ((n, 3), (1,), (n,)):
            raise AssertionError(f"{label}: shapes {r['force'].shape} {r['energy'].shape} "
                                 f"{r['charge'].shape}")
        if not all(np.isfinite(r[k]).all() for k in ("force", "energy", "charge")):
            raise AssertionError(f"{label}: non-finite output")
        dq = abs(float(r["charge"].sum()) - float(g["total_charge"][0]))
        worst_q = max(worst_q, dq / (CHARGE_TOL * (1.0 + np.abs(r["charge"]).sum())))
    if worst_q > 1.0:
        raise AssertionError(f"{label}: charges miss the total charge ({worst_q:.3g} x tol)")
    if not any(np.asarray(g["esp_grad"]).any() for g in graphs):
        worst = max_force_sum_violation(results)
        if worst > 1.0:
            raise AssertionError(f"{label}: forces do not sum to 0 ({worst:.3g} x tol)")


def spd_work(g, m, k):
    """Bytes (a and b read once, x written once) and float32 operations of
    the elimination on the columns it updates; ``(bytes, bound_ms, bound_by)``."""
    nbytes = 4 * g * (m * m + 2 * m * k)
    ops = g * sum(1 + (2 * (m - 1) + 1) * (m + k - s - 1) for s in range(m))
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return nbytes, 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_spd(a, b, label, timed):
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    x = ks.spd_solve(a, b)
    torch.cuda.synchronize()
    plain = ks.spd_solve_plain(a, b)
    scale = 1.0 + plain.abs().max().item()
    err = (x - plain).abs().max().item()
    resid = (a @ x - b).abs().max().item()
    rscale = 1.0 + b.abs().max().item()
    if not (torch.isfinite(x).all() and err <= SPD_TOL * scale
            and resid <= SPD_RESIDUAL_TOL * rscale):
        raise AssertionError(f"spd_solve {label}: max|k-p|={err} (tol {SPD_TOL}*{scale}), "
                             f"max|Ax-b|={resid} (tol {SPD_RESIDUAL_TOL}*{rscale})")
    g, m, _ = a.shape
    k = b.shape[2]
    rec = {"case": label, "G": g, "M": m, "K": k, "max_abs_err": err, "residual": resid}
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=a.device)
        nbytes, bound_ms, bound_by = spd_work(g, m, k)
        rec.update(
            ms=cuda_median_ms(lambda: ks.spd_solve(a, b), 50, flush),
            ms_warm=cuda_median_ms(lambda: ks.spd_solve(a, b), 50),
            plain_ms=cuda_median_ms(lambda: ks.spd_solve_plain(a, b), 20, flush),
            library_ms=cuda_median_ms(lambda: torch.linalg.solve(a, b), 50, flush),
            cholesky_ms=cuda_median_ms(
                lambda: torch.cholesky_solve(b, torch.linalg.cholesky(a)), 50, flush),
            bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel spd_solve {label}: " + json.dumps(rec))
    return rec


def random_spd(g, m, k, seed, dev):
    """Well-conditioned SPD systems: B B^T + 2 I with B ~ N(0, 1/m)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    half = torch.randn(g, m, m, generator=gen, device=dev) / m ** 0.5
    a = half @ half.transpose(1, 2) + 2.0 * torch.eye(m, device=dev)
    return a.contiguous(), torch.randn(g, m, k, generator=gen, device=dev)


def phase_spd_kernel(model, batch):
    """The SPD kernel against its plain version on the Qeq system that
    ``CENTCharge`` assembles from ``batch`` (timed), and at edge cases."""
    from gcnn_keras_tpu_torch.layers.conv.qeq_solver import solve_qeq_dense_cholesky
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    dev = batch.senders.device
    with torch.no_grad():
        rep, esp, z = model.representation(batch)
        chi = model.mlp_charge(rep, z)[:, 0] + esp
        a, mask, b, qtot, corner = model.cent_electrostatic.cent_charge.assemble(batch, chi)
    rhs = torch.stack([b, mask], dim=-1).contiguous()
    if a.shape != (batch.n_graphs, HDNNP4TH_M, HDNNP4TH_M):
        raise AssertionError(f"unexpected Qeq shape {tuple(a.shape)}")
    eye = torch.eye(HDNNP4TH_M, device=dev)
    if not torch.equal(a[-1], eye):
        raise AssertionError("the padding graph's Qeq system is not the identity")
    m_gate = ks.max_kernel_m(2)
    recs = [check_spd(a, rhs, "Qeq of the HDNNP4th serving request, 512 mols", True),
            check_spd(a[:1].contiguous(), rhs[:1].contiguous(), "G=1", False),
            check_spd(*random_spd(7, 1, 2, 1, dev), "M=1", False),
            check_spd(*random_spd(4, m_gate, 2, 2, dev), f"M={m_gate} at the gate", False),
            check_spd(a, rhs[..., :1].contiguous(), "K=1", False)]
    ident = check_spd(a[-1:].contiguous(), torch.randn(1, HDNNP4TH_M, 2, device=dev),
                      "the padding graph's identity system", False)
    if ident["max_abs_err"] != 0.0:
        raise AssertionError("the identity system changed its right-hand side")
    recs.append(ident)
    # an empty graph beside a real one: identity rows, zero right-hand side,
    # bordered corner 1, so its charges are 0 and lambda stays finite
    a2 = torch.stack([a[0], eye])
    mask2 = torch.stack([mask[0], torch.zeros_like(mask[0])])
    b2 = torch.stack([b[0], torch.zeros_like(b[0])])
    before = ks.launches
    q2 = solve_qeq_dense_cholesky(a2, mask2, b2, qtot[:2], torch.tensor([0.0, 1.0], device=dev))
    torch.cuda.synchronize()
    if ks.launches != before + 1 or not torch.isfinite(q2).all() or q2[1].any():
        raise AssertionError(f"empty graph: charges {q2[1].tolist()}")
    dq = abs(q2[0].sum().item() - qtot[0].item())
    if dq > CHARGE_TOL * (1.0 + q2[0].abs().sum().item()):
        raise AssertionError(f"empty graph case: charges sum off by {dq}")
    recs.append(check_spd(a2.contiguous(), torch.stack([b2, mask2], -1).contiguous(),
                          "an empty graph, bordered corner 1", False))
    return recs


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

    hgpu = make_hdnnp_predictor("cuda")
    _, hbatch0 = hgpu.make_batch(requests[0][1])
    shapes = (hbatch0.n_node, hbatch0.n_edge, hbatch0.angles.shape[0], hbatch0.n_graphs)
    if shapes != HDNNP_SHAPES:
        raise AssertionError(f"unexpected HDNNP2nd full-width shapes {shapes}")
    acsf_recs = phase_acsf_kernel(hbatch0, hgpu.model.energy_model)
    hlaunches = phase_hdnnp_serving(hgpu, requests, hbatch0, smi)

    qgpu = make_hdnnp4th_predictor("cuda")
    qrequests = [("seed 0, 512 mols", with_esp(requests[0][1], 0)),
                 ("seed 1, 512 mols", with_esp(requests[1][1], 1)),
                 ("seed 2, 64 mols, no ESP gradient", with_esp(requests[2][1], 2, True))]
    _, qbatch0 = qgpu.make_batch(qrequests[0][1])
    shapes = (qbatch0.n_node, qbatch0.n_edge, qbatch0.angles.shape[0], qbatch0.n_graphs)
    if shapes != HDNNP_SHAPES or qbatch0.max_nodes != HDNNP4TH_M:
        raise AssertionError(f"unexpected HDNNP4th full-width shapes {shapes}, "
                             f"M={qbatch0.max_nodes}")
    spd_recs = phase_spd_kernel(qgpu.model.energy_model, qbatch0)
    qlaunches = phase_hdnnp_serving(
        qgpu, qrequests, qbatch0, smi, name="hdnnp4th", make_cpu=make_hdnnp4th_predictor,
        expected=HDNNP4TH_LAUNCHES, check=check_charged_request,
        keys=("energy", "force", "charge"))

    main_rec = recs[0]
    kernels = [{
        "name": "sorted_segment_sum", "route": "cuda",
        "source": "gcnn_keras_tpu_torch/csrc/segment_sum.cu",
        "replaces": "gcnn_keras_tpu/ops/pallas/segment_sum.py:182",
        "launches": launches + hlaunches["sorted_segment_sum"]
        + qlaunches["sorted_segment_sum"],
        "launches_by_path": {"schnet_serving": launches,
                             "hdnnp2nd_serving": hlaunches["sorted_segment_sum"],
                             "hdnnp4th_serving": qlaunches["sorted_segment_sum"]},
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "shapes": recs,
    }]
    for name, rs in acsf_recs.items():
        main_rec = rs[0]
        kernels.append({
            "name": f"acsf_{name}", "route": "cuda",
            "source": "gcnn_keras_tpu_torch/csrc/acsf.cu",
            "replaces": ACSF_REPLACES[name],
            "launches": hlaunches[name] + qlaunches[name],
            "launches_by_path": {"hdnnp2nd_serving": hlaunches[name],
                                 "hdnnp4th_serving": qlaunches[name]},
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": None, "shapes": rs})
    main_rec = spd_recs[0]
    kernels.append({
        "name": "spd_solve", "route": "cuda",
        "source": "gcnn_keras_tpu_torch/csrc/spd_solve.cu",
        "replaces": "gcnn_keras_tpu/ops/pallas/spd_solve.py:95",
        "launches": hlaunches["spd_solve"] + qlaunches["spd_solve"],
        "launches_by_path": {"hdnnp2nd_serving": hlaunches["spd_solve"],
                             "hdnnp4th_serving": qlaunches["spd_solve"]},
        "max_abs_err": max(r["max_abs_err"] for r in spd_recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"], "shapes": spd_recs})
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
