"""Where the time of one full-width energy+force evaluation, of one
training step or of one MD step goes on a CUDA card, for the PyTorch port.

    python3 profile_serving_torch.py [--model schnet|hdnnp2nd|hdnnp4th|painn|gcn]
                                     [--mode unfused|fused|accurate|chain]
                                     [--train | --md] [--evals 10]
                                     [--trace chiprun_out/serving_trace.json]
    python3 profile_serving_torch.py --model hdnnp4th --atoms N [--train]
                                     [--solver dense|iterative]
    python3 profile_serving_torch.py --script NAME
        (NAME: force_schnet, force_painn, force_hdnnp2nd, force_hdnnp4th,
         energy_hdnnp4th or charge_hdnnp4th)
    python3 profile_serving_torch.py --kernel KERNEL
        (KERNEL: sorted_segment_sum, gather_mul_segsum, fused_cfconv, cf_fwd,
         cf_vjp, cf_hesjvp, g4_fwd, g4_jvp, g4_vjp, g2_fwd, g2_jvp, g2_vjp
         or spd_solve)

Builds the serving batch of ``chip_smoke.py`` (512 QM9-like molecules,
weights from seed 0; SchNet defaults in ``--mode`` (``interaction_args``
``fused_aggregate``, ``accurate_cfconv`` or ``fused_chain``), or the HDNNP2nd or HDNNP4th
bench configuration with ``set_angle`` as the graph preprocessor, HDNNP4th
with the ESP, its gradient and total charges of ``chip_smoke.with_esp``, or
PAiNN's bench configuration, ``chip_smoke.PAINN_KW``);
with ``--train`` the model's training path of ``chip_smoke.TRAIN_PATHS``
(its labelled batch, loss and Adam; SchNet's ``schnet_chain_train`` with
``--mode chain``; GCN, which has only this mode, ``gcn_cora_train``: node
classification on the 2708-node citation graph); with ``--md`` velocity-Verlet steps
of ``bench.py``'s 21-atom molecule (SchNet in ``--mode``, masses 12, dt
5e-4, ``chip_smoke.md_batch``). Warms up, and runs ``--evals``
evaluations or steps under ``torch.profiler``. Prints the device time by kernel, the
device busy share of the wall time, and one JSON summary line with the time
and calls of each of the port's own kernels and the median wall time of
``--evals`` synced calls outside the profiler, before it and after it (what
the profiler's tracing leaves behind); writes a Chrome trace when
``--trace`` is given.

``--atoms N`` (HDNNP4th only) takes one molecule of N atoms instead
(``chip_smoke.large_mol_graph``, ``bench.py`` ``bench_large_mol_step``'s
molecule and model, ``chip_smoke.LARGE_MOL_KW``), with the Qeq
``--solver`` given (default: ``"auto"``, dense below 4096 atoms); with
``--train`` its training step (``TRAIN_PATHS["hdnnp4th_mol520_train"]``'s
loss and Adam on that molecule). The summary then also gives the device time
of the Qeq solve's Cholesky factorizations and solves (every operation
named for Cholesky, with the backward nodes of both) and of its CG solves,
each as a share of the device time.

``--script NAME`` profiles one training step of the training engine on
the script ``gcnn_keras_tpu_torch.scripts.NAME`` at its ``CONFIG`` widths
with ``chip_smoke.py`` phase 19's cuts: the engine's fold-0 model, loss,
Adam and schedule on the first batch of its loader (16 molecules of 9
atoms), held once the engine reaches its fit loop.

``--kernel`` is the kernel-only timing mode, seconds long where a whole
``chip_smoke.py`` takes minutes: it builds the kernel's source afresh
(printing ptxas's registers and spills), builds the main-path batch and runs
``chip_smoke.py``'s own checks of that kernel, each against its plain
version and each printed as a JSON record: ``sorted_segment_sum``, phase
3's three timed shapes of the SchNet serving batch and its edge cases;
``cf_fwd``, ``cf_vjp`` and ``cf_hesjvp``, phase 15's edge cases and the
timed checks at the ``schnet_train`` batch (with the plain version's and
the port's unfused chain's times; ``cf_hesjvp`` as a force loss calls it
and with every tangent); ``gather_mul_segsum`` and ``fused_cfconv``, phase
11's timed checks at the serving and MD shapes (with the unfused chains'
times) and their edge cases; the six ACSF kernels, phase 5's and 9's
timed check at the HDNNP2nd serving batch and the ACSF edge cases (the G2
kernels also the G2 layout cases), each also every call of one
``hdnnp2nd_train`` and one ``hdnnp4th_train`` step (phase 10, the first
call timed); ``spd_solve``, phase 7's checks (the
HDNNP4th serving request's Qeq solve and the block kernel at M = 100 and
239 timed, and the edge cases) and every
call of one ``hdnnp4th_train`` step. The last line is one JSON summary of
the timed records. Needs one CUDA card.
"""
import argparse
import contextlib
import functools
import importlib
import json
import os
import statistics
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke

# the port's hand-written kernels, by the names of their CUDA functions
PORT_KERNELS = ("sorted_segment_sum", "g2_fwd_kernel", "g4_fwd_kernel",
                "g4_vjp_kernel", "g2_vjp_kernel", "g4_jvp_kernel", "g2_jvp_kernel",
                "spd_solve_warp_kernel", "spd_solve_gj_kernel", "gms_cols_kernel",
                "fused_cfconv_kernel", "fused_cfconv_wide_kernel", "cf_fwd_kernel",
                "cf_fwd_wide_kernel", "cf_vjp_kernel",
                "cf_hesjvp_kernel", "cf_hesjvp_wide_kernel")


def timed_ms(run, evals):
    """The median wall ms of ``evals`` calls of ``run``, each followed by a
    sync, outside the profiler."""
    times = []
    for _ in range(evals):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def serving_run(name, mode):
    make = {"schnet": functools.partial(chip_smoke.make_predictor, mode=mode),
            "hdnnp2nd": chip_smoke.make_hdnnp_predictor,
            "hdnnp4th": chip_smoke.make_hdnnp4th_predictor,
            "painn": chip_smoke.make_painn_predictor}[name]
    gpu = make("cuda")
    mols = chip_smoke.qm9_like_mols(0, 512)
    if name == "hdnnp4th":
        mols = chip_smoke.with_esp(mols, 0)
    _, batch = gpu.make_batch(mols)
    return lambda: gpu.model(batch)


def molecule_run(atoms, train, solver):
    """An evaluation or a training step of one molecule of ``atoms`` atoms."""
    path = "hdnnp4th_mol520_train"
    batch = chip_smoke.train_batch(path, 3, atoms, "cuda")
    if not train:
        fm = chip_smoke.energy_force_model("hdnnp4th_mol", "cuda", solver=solver)
        return lambda: fm.apply(batch)
    _, trainer, state = chip_smoke.make_trainer(path, "cuda", solver)
    step = trainer.step_fn()
    holder = [state]

    def run():
        holder[0], _ = step(holder[0], batch)
    return run


def top_device_ms(events, match):
    """Device time (ms) of the CPU events whose name ``match`` accepts and
    that no accepted event encloses: the kernels launched inside them."""
    total = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or not match(e.name):
            continue
        parent = e.cpu_parent
        while parent is not None and not match(parent.name):
            parent = parent.cpu_parent
        if parent is None:
            total += e.device_time_total / 1e3
    return total


def md_run(name, mode):
    """One velocity-Verlet step of the 21-atom molecule per call, from rest."""
    from gcnn_keras_tpu_torch.moldyn.integrate import make_energy_force_fn, verlet_step
    if name != "schnet":
        raise SystemExit("profile_serving_torch: --md runs SchNet")
    batch = chip_smoke.md_batch("cuda")
    fn = make_energy_force_fn(chip_smoke.schnet_model(mode, "cuda"), batch)
    pos = batch.nodes["node_coordinates"]
    m = torch.full((batch.n_node, 1), 12.0, device=pos.device)
    mask = batch.node_mask[:, None].to(pos.dtype)
    state = [pos, torch.zeros_like(pos), fn(pos)[1] * mask]

    def run():
        state[:3] = verlet_step(fn, *state, m, mask, chip_smoke.MD_DT)[:3]
    return run


def training_run(name, mode):
    path = ("schnet_chain_train" if mode == "chain" else "gcn_cora_train" if name == "gcn"
            else f"{name}_train")
    _, trainer, state = chip_smoke.make_trainer(path, "cuda")
    batch = chip_smoke.full_batch(path, "cuda")
    step = trainer.step_fn()
    holder = [state]

    def run():
        holder[0], _ = step(holder[0], batch)
    return run


def script_run(name):
    """One engine step of script ``name`` (phase 19's configuration): the
    engine runs until its fit loop, which is held there with its trainer,
    state and first batch."""
    from gcnn_keras_tpu_torch.training import force_script
    mod = importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{name}")
    cfg = {**mod.CONFIG, **chip_smoke.SCRIPT_CUTS, "device": "cuda"}
    held = {}

    class Held(Exception):
        pass

    def hold(trainer, state, batches, *args, **kwargs):
        held.update(trainer=trainer, state=[state], batch=next(iter(batches)))
        raise Held

    fit, force_script.fit_model = force_script.fit_model, hold
    try:
        with tempfile.TemporaryDirectory(prefix="_profile_", dir=os.getcwd()) as workdir, \
                contextlib.chdir(workdir):
            if hasattr(mod, "train"):
                mod.train(cfg)
            else:
                force_script.run_force_training(mod.build_model, cfg)
    except Held:
        pass
    finally:
        force_script.fit_model = fit

    def run():
        held["state"][0], _ = held["trainer"].step(held["state"][0], held["batch"])
    return run


# the source of each kernel that --kernel takes
KERNEL_SOURCES = {"sorted_segment_sum": "segment_sum", "gather_mul_segsum": "fused_aggregate",
                  "fused_cfconv": "fused_cfconv", "cf_fwd": "fused_interaction",
                  "cf_vjp": "fused_interaction", "cf_hesjvp": "fused_interaction",
                  "g4_fwd": "acsf", "g4_jvp": "acsf", "g4_vjp": "acsf",
                  "g2_fwd": "acsf", "g2_jvp": "acsf", "g2_vjp": "acsf",
                  "spd_solve": "spd_solve"}


def training_kernel_records(name, paths):
    """``chip_smoke.py`` phase 10's checks of kernel ``name``'s calls in one
    step of each training path of ``paths`` (the first call timed)."""
    recs = []
    for path in paths:
        recs += chip_smoke.check_training_kernels(path, chip_smoke.full_batch(path, "cuda"))[name]
    return recs


def kernel_records(name):
    """``chip_smoke.py``'s checks of kernel ``name`` at its main-path shapes
    and edge cases, after a fresh build of its source."""
    chip_smoke.phase_build([KERNEL_SOURCES[name]])
    if KERNEL_SOURCES[name] == "acsf":
        pred = chip_smoke.make_hdnnp_predictor("cuda")
        _, batch = pred.make_batch(chip_smoke.qm9_like_mols(0, 512))
        recs = chip_smoke.phase_acsf_kernel(batch, pred.model.energy_model, (name,))[name]
        return recs + training_kernel_records(name, ("hdnnp2nd_train", "hdnnp4th_train"))
    if name == "spd_solve":
        pred = chip_smoke.make_hdnnp4th_predictor("cuda")
        _, batch = pred.make_batch(chip_smoke.with_esp(chip_smoke.qm9_like_mols(0, 512), 0))
        return (chip_smoke.phase_spd_kernel(pred.model.energy_model, batch)
                + training_kernel_records(name, ("hdnnp4th_train",)))
    if name in ("sorted_segment_sum", "gather_mul_segsum", "fused_cfconv"):
        _, batch = chip_smoke.make_predictor("cuda").make_batch(chip_smoke.qm9_like_mols(0, 512))
        if name == "sorted_segment_sum":
            return chip_smoke.phase_kernel(batch)
        return chip_smoke.phase_schnet_kernels(
            batch, chip_smoke.schnet_model("unfused", "cuda"), (name,))[name]
    batch = chip_smoke.full_batch("schnet_chain_train", "cuda")
    recs = chip_smoke.chain_edge_case_checks(batch.senders.device, (name,))[name]
    return chip_smoke.chain_timed_check(name, batch,
                                        chip_smoke.schnet_model("chain", "cuda")) + recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("schnet", "hdnnp2nd", "hdnnp4th", "painn", "gcn"),
                    default="schnet")
    ap.add_argument("--mode", choices=tuple(chip_smoke.MODE_ARGS), default="unfused",
                    help="SchNet's execution mode")
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--train", action="store_true",
                      help="profile training steps instead of serving evaluations")
    kind.add_argument("--md", action="store_true",
                      help="profile MD steps of a 21-atom molecule instead")
    kind.add_argument("--kernel", choices=tuple(KERNEL_SOURCES),
                      help="time one kernel at its main-path shapes instead")
    kind.add_argument("--script", choices=tuple(chip_smoke.SCRIPT_PATHS),
                      help="profile one step of the training engine on this script")
    ap.add_argument("--atoms", type=int, default=None,
                    help="HDNNP4th on one molecule of this many atoms")
    ap.add_argument("--solver", choices=("dense", "iterative"), default=None,
                    help="the Qeq solver with --atoms (default: auto)")
    ap.add_argument("--evals", type=int, default=10)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving_torch: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    if args.kernel:
        timed = [r for r in kernel_records(args.kernel) if "ms" in r]
        print(json.dumps({"card": smi, "kernel": args.kernel, "timed": timed}))
        return
    if args.mode != "unfused" and args.model != "schnet":
        raise SystemExit("profile_serving_torch: --mode is SchNet's")
    if args.train and args.mode not in ("unfused", "chain"):
        raise SystemExit("profile_serving_torch: --train runs SchNet unfused or chain")
    if args.model == "gcn" and not args.train:
        raise SystemExit("profile_serving_torch: GCN runs --train only")
    if (args.atoms is not None or args.solver) and (args.model != "hdnnp4th" or args.md
                                                     or args.atoms is None):
        raise SystemExit("profile_serving_torch: --atoms [--solver] is HDNNP4th's, "
                         "serving or --train")
    if args.script:
        run = script_run(args.script)
    elif args.atoms is not None:
        from gcnn_keras_tpu_torch.layers.conv import qeq_solver
        run = molecule_run(args.atoms, args.train, args.solver)
        pcg = qeq_solver._pcg

        def annotated_pcg(*a):
            with record_function("qeq_cg_solve"):
                return pcg(*a)
        qeq_solver._pcg = annotated_pcg
    else:
        run = (training_run if args.train else md_run if args.md else serving_run)(
            args.model, args.mode)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    before_ms = timed_ms(run, args.evals)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.evals):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.evals
    if args.trace:
        prof.export_chrome_trace(args.trace)
    after_ms = timed_ms(run, args.evals)

    # device rows, less the optimizer's annotation range, whose device time
    # is that of the kernels it encloses, which are rows of their own
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.evals
    n_kernels = sum(e.count for e in kernels) / args.evals
    unit = "step" if args.train or args.md or args.script else "eval"
    print(f"card: {smi}")
    print(f"{'device ms/' + unit:>14} {'calls/' + unit:>10}  kernel")
    for e in kernels[:25]:
        print(f"{e.self_device_time_total / 1e3 / args.evals:14.4f} "
              f"{e.count / args.evals:10.1f}  {e.key[:100]}")
    summary = {
        "card": smi, "model": args.script or args.model, "mode": args.mode,
        "train": args.train or bool(args.script),
        "md": args.md, "evals": args.evals,
        f"wall_ms_per_{unit}_profiled": wall_ms,
        f"wall_ms_per_{unit}_before_profiler": before_ms,
        f"wall_ms_per_{unit}_after_profiler": after_ms,
        f"device_ms_per_{unit}": dev_ms,
        "device_busy_share": dev_ms / wall_ms,
        f"kernels_per_{unit}": n_kernels,
    }
    if args.atoms is not None:
        events = prof.events()
        cholesky_ms = top_device_ms(events, lambda n: "cholesky" in n.lower()) / args.evals
        cg_ms = top_device_ms(events, lambda n: n == "qeq_cg_solve") / args.evals
        summary.update(atoms=args.atoms, solver=args.solver or "auto",
                       **{f"cholesky_ms_per_{unit}": cholesky_ms,
                          "cholesky_share": cholesky_ms / dev_ms,
                          f"cg_ms_per_{unit}": cg_ms, "cg_share": cg_ms / dev_ms})
    for name in PORT_KERNELS:
        mine = [e for e in kernels if name in e.key]
        if mine:
            summary[f"{name}_ms_per_{unit}"] = sum(
                e.self_device_time_total for e in mine) / 1e3 / args.evals
            summary[f"{name}_calls_per_{unit}"] = sum(e.count for e in mine) / args.evals
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
