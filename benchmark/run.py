"""Run one cell of ``BENCHMARK.json`` once on the CUDA card and print one
JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` its per-layer metrics over the traffic mix's
``trace_batches`` calls under ``torch.profiler``, with ``busy_s``,
``window_s`` and a ``breakdown``. Both check what the window produced
against the plain reference and print each compared number beside its
limit, last on standard error and last in the JSON line (``checks``).

Without a CUDA card, or with fewer cards than the cell asks for, it
prints no result and exits 2. ``--dry-run`` runs the cell on the CPU with
the port's plain kernel versions, for tests: it prints ``{"dry_run": ...}``
and never a result. Caches stay inside the checkout: the port builds its
kernels into ``gcnn_keras_tpu_torch/_build/``; Triton's cache, should
anything use it, goes to ``benchmark/_cache/triton``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one process with few threads: the host's own thread pools stay small, so
# that other work on a shared host moves the timings less
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "2"
FORBIDDEN = {"jax", "jaxlib", "flax", "gcnn_keras_tpu"}


def loaded_forbidden():
    """Modules whose top-level name (before the first dot, compared whole)
    is JAX's, flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry-run", action="store_true",
                    help="run on the CPU for tests; prints no result")
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / "_cache" / "triton")
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(2)
    from benchmark.core.cell import run_cell
    from benchmark.core.spec import Spec

    spec = Spec(ROOT)
    cell = spec.workload(args.workload)
    if args.dry_run:
        device = torch.device("cpu")
    else:
        chips = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"no result: the cell needs {chips} CUDA card(s), "
                  f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)

    res = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device, T0)
    obs = res["obs"]
    bad = loaded_forbidden()
    if bad:
        print("no result: loaded in this process: " + ", ".join(bad), file=sys.stderr)
        return 3

    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(args.workload, section):
        value = spec.module("metrics", m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    print("setup phases (s): " + json.dumps(obs.extra.get("setup_phases")), file=sys.stderr)
    for w in obs.extra.get("warnings", []):
        print("warning: " + w, file=sys.stderr)

    if args.dry_run:
        print(json.dumps({"dry_run": {"correct": res["correct"], "attempted": res["attempted"],
                                      "failed": res["failed"], "metrics": metrics,
                                      "checks": res["checks"]}}))
        return 0

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": int(cell["chips"]), "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device_info}
    if args.trace:
        tr = obs.trace
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(10), "idle_gaps": tr.idle_gaps(10)}
        print("unnamed device events by launch (count, ns): " + json.dumps(tr.unnamed),
              file=sys.stderr)
    out["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
