"""Where the time of one full-width energy+force evaluation goes on a CUDA
card, for the PyTorch port.

    python3 profile_serving_torch.py [--model schnet|hdnnp2nd] [--evals 10]
                                     [--trace chiprun_out/serving_trace.json]

Builds the serving batch of ``chip_smoke.py`` (512 QM9-like molecules,
weights from seed 0; SchNet defaults, or the HDNNP2nd bench configuration
with ``set_angle`` as the graph preprocessor), warms up, and runs
``--evals`` evaluations under ``torch.profiler``. Prints the device time by
kernel, the device busy share of the wall time, and one JSON summary line
with the time and calls of each of the port's own kernels; writes a Chrome
trace when ``--trace`` is given. Needs one CUDA card.
"""
import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke

# the port's hand-written kernels, by the names of their CUDA functions
PORT_KERNELS = ("sorted_segment_sum", "g2_fwd_kernel", "g4_fwd_kernel",
                "g4_vjp_kernel", "g2_vjp_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("schnet", "hdnnp2nd"), default="schnet")
    ap.add_argument("--evals", type=int, default=10)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving_torch: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    make = {"schnet": chip_smoke.make_predictor,
            "hdnnp2nd": chip_smoke.make_hdnnp_predictor}[args.model]
    gpu = make("cuda")
    _, batch = gpu.make_batch(chip_smoke.qm9_like_mols(0, 512))
    model = gpu.model
    for _ in range(3):
        model(batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.evals):
            model(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.evals
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.evals
    n_kernels = sum(e.count for e in kernels) / args.evals
    print(f"card: {smi}")
    print(f"{'device ms/eval':>14} {'calls/eval':>10}  kernel")
    for e in kernels[:25]:
        print(f"{e.self_device_time_total / 1e3 / args.evals:14.4f} "
              f"{e.count / args.evals:10.1f}  {e.key[:100]}")
    summary = {
        "card": smi, "model": args.model, "evals": args.evals,
        "wall_ms_per_eval_profiled": wall_ms,
        "device_ms_per_eval": dev_ms,
        "device_busy_share": dev_ms / wall_ms,
        "kernels_per_eval": n_kernels,
    }
    for name in PORT_KERNELS:
        mine = [e for e in kernels if name in e.key]
        if mine:
            summary[f"{name}_ms_per_eval"] = sum(
                e.self_device_time_total for e in mine) / 1e3 / args.evals
            summary[f"{name}_calls_per_eval"] = sum(e.count for e in mine) / args.evals
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
