"""Readings for a cell's correctness limits, on the card at the cell's own
sizes, in one process:

- ``sound``: the program as the configuration states, one short window a
  seed (the lower readings: the largest over a dozen seeds or more);
- ``control``: the plain reference computed in TF32 in the program's place,
  against the reference (an upper reading where it is 3x the lower);
- ``fault:<name>``: the program with a fault planted underneath the timed
  path (``core/faults.py``).

    python3 benchmark/calibrate.py --workload <cell> --sound 12 --control 3 --faults 3

prints one JSON line a reading. The benchmark's runs never run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, default=12, help="seeds of sound runs")
    ap.add_argument("--control", type=int, default=3, help="seeds of the control")
    ap.add_argument("--faults", type=int, default=3, help="seeds of each fault")
    ap.add_argument("--seconds", type=float, default=1.0, help="each run's window")
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark.core import faults
    from benchmark.core.cell import run_cell
    from benchmark.core.spec import Spec

    spec = Spec(ROOT)
    device = torch.device("cuda")
    mode = spec.traffic(spec.workload(args.workload)["traffic"])
    names = [f for f in faults.FAULTS[mode["mode"]]
             if not (f == "half_batch" and int(mode["frames_per_batch"]) < 2)]
    seed = args.first_seed

    def emit(kind, s, numbers, **kw):
        print(json.dumps({"kind": kind, "seed": s, "numbers": numbers, **kw}), flush=True)

    def clean():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for _ in range(args.sound):
        seed += 1
        res = run_cell(spec, args.workload, seed, args.seconds, False, device, time.perf_counter())
        emit("sound", seed, res["numbers"],
             correct=res["correct"], attempted=res["attempted"])
        del res
        clean()
    for _ in range(args.control):
        seed += 1
        emit("control", seed, faults.control_numbers(spec, args.workload, seed, device))
        clean()
    for name in names:
        for _ in range(args.faults):
            seed += 1
            with faults.planted(name):
                res = run_cell(spec, args.workload, seed, args.seconds, False, device,
                               time.perf_counter())
            emit(f"fault:{name}", seed, res["numbers"],
                 correct=res["correct"])
            del res
            clean()
    return 0


if __name__ == "__main__":
    sys.exit(main())
