"""Where the time of one full-width energy+force evaluation, of one
training step or of one MD step goes on a CUDA card, for the PyTorch port.

    python3 profile_serving_torch.py [--model schnet|hdnnp2nd|hdnnp4th]
                                     [--mode unfused|fused|accurate|chain]
                                     [--train | --md] [--evals 10]
                                     [--trace chiprun_out/serving_trace.json]
    python3 profile_serving_torch.py --kernel KERNEL
        (KERNEL: sorted_segment_sum, gather_mul_segsum, fused_cfconv, cf_fwd,
         cf_vjp, cf_hesjvp, g4_fwd, g4_jvp, g4_vjp, g2_fwd, g2_jvp, g2_vjp
         or spd_solve)

Builds the serving batch of ``chip_smoke.py`` (512 QM9-like molecules,
weights from seed 0; SchNet defaults in ``--mode`` (``interaction_args``
``fused_aggregate``, ``accurate_cfconv`` or ``fused_chain``), or the HDNNP2nd or HDNNP4th
bench configuration with ``set_angle`` as the graph preprocessor, HDNNP4th
with the ESP, its gradient and total charges of ``chip_smoke.with_esp``);
with ``--train`` the model's training path of ``chip_smoke.TRAIN_PATHS``
(its labelled batch, loss and Adam; SchNet's ``schnet_chain_train`` with
``--mode chain``); with ``--md`` velocity-Verlet steps
of ``bench.py``'s 21-atom molecule (SchNet in ``--mode``, masses 12, dt
5e-4, ``chip_smoke.md_batch``). Warms up, and runs ``--evals``
evaluations or steps under ``torch.profiler``. Prints the device time by kernel, the
device busy share of the wall time, and one JSON summary line with the time
and calls of each of the port's own kernels; writes a Chrome trace when
``--trace`` is given.

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
import functools
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke

# the port's hand-written kernels, by the names of their CUDA functions
PORT_KERNELS = ("sorted_segment_sum", "g2_fwd_kernel", "g4_fwd_kernel",
                "g4_vjp_kernel", "g2_vjp_kernel", "g4_jvp_kernel", "g2_jvp_kernel",
                "spd_solve_warp_kernel", "spd_solve_gj_kernel", "gms_cols_kernel",
                "fused_cfconv_kernel", "fused_cfconv_wide_kernel", "cf_fwd_kernel",
                "cf_fwd_wide_kernel", "cf_vjp_kernel",
                "cf_hesjvp_kernel", "cf_hesjvp_wide_kernel")


def serving_run(name, mode):
    make = {"schnet": functools.partial(chip_smoke.make_predictor, mode=mode),
            "hdnnp2nd": chip_smoke.make_hdnnp_predictor,
            "hdnnp4th": chip_smoke.make_hdnnp4th_predictor}[name]
    gpu = make("cuda")
    mols = chip_smoke.qm9_like_mols(0, 512)
    if name == "hdnnp4th":
        mols = chip_smoke.with_esp(mols, 0)
    _, batch = gpu.make_batch(mols)
    return lambda: gpu.model(batch)


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
    path = "schnet_chain_train" if mode == "chain" else f"{name}_train"
    cfg = chip_smoke.TRAIN_PATHS[path]
    _, trainer, state = chip_smoke.make_trainer(path, "cuda")
    batch = chip_smoke.train_batch(path, cfg["seed"], cfg["n_mols"], "cuda")
    step = trainer.step_fn()
    holder = [state]

    def run():
        holder[0], _ = step(holder[0], batch)
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
        cfg = chip_smoke.TRAIN_PATHS[path]
        batch = chip_smoke.train_batch(path, cfg["seed"], cfg["n_mols"], "cuda")
        recs += chip_smoke.check_training_kernels(path, batch)[name]
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
    batch = chip_smoke.train_batch("schnet_chain_train", 0, 512, "cuda")
    recs = chip_smoke.chain_edge_case_checks(batch.senders.device, (name,))[name]
    return chip_smoke.chain_timed_check(name, batch,
                                        chip_smoke.schnet_model("chain", "cuda")) + recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("schnet", "hdnnp2nd", "hdnnp4th"),
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
    run = (training_run if args.train else md_run if args.md else serving_run)(
        args.model, args.mode)
    for _ in range(3):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.evals):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.evals
    if args.trace:
        prof.export_chrome_trace(args.trace)

    # device rows, less the optimizer's annotation range, whose device time
    # is that of the kernels it encloses, which are rows of their own
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.evals
    n_kernels = sum(e.count for e in kernels) / args.evals
    unit = "step" if args.train or args.md else "eval"
    print(f"card: {smi}")
    print(f"{'device ms/' + unit:>14} {'calls/' + unit:>10}  kernel")
    for e in kernels[:25]:
        print(f"{e.self_device_time_total / 1e3 / args.evals:14.4f} "
              f"{e.count / args.evals:10.1f}  {e.key[:100]}")
    summary = {
        "card": smi, "model": args.model, "mode": args.mode, "train": args.train,
        "md": args.md, "evals": args.evals,
        f"wall_ms_per_{unit}_profiled": wall_ms,
        f"device_ms_per_{unit}": dev_ms,
        "device_busy_share": dev_ms / wall_ms,
        f"kernels_per_{unit}": n_kernels,
    }
    for name in PORT_KERNELS:
        mine = [e for e in kernels if name in e.key]
        if mine:
            summary[f"{name}_ms_per_{unit}"] = sum(
                e.self_device_time_total for e in mine) / 1e3 / args.evals
            summary[f"{name}_calls_per_{unit}"] = sum(e.count for e in mine) / args.evals
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
