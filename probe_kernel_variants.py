"""Time variants of one hand-written kernel against each other on a CUDA card.

    python3 probe_kernel_variants.py sorted_segment_sum 'NAME=PATTERN=>REPLACEMENT' ...
    python3 probe_kernel_variants.py cf_vjp 'nt512=kThreadsVjp = 256=>kThreadsVjp = 512'
    python3 probe_kernel_variants.py sorted_segment_sum 'old=@path/to/segment_sum.cu'

Each variant is the kernel's source (``gcnn_keras_tpu_torch/csrc``) with
regular-expression substitutions (several joined by ``;;``; ``\\n`` in a
replacement is a newline), or another source file (``@path``); ``cur`` is
the source as it stands. Every variant is built by nvcc (ptxas's registers
and spills printed), then each is timed in turns (cur and the variants, then
the same in reverse) by ``chip_smoke.py``'s own checks, with the result
held against the plain version:

- ``sorted_segment_sum``: phase 3's three timed shapes of the SchNet serving
  batch and a launch with no edges (the floor), each beside ``index_add_``;
- ``cf_fwd``, ``cf_vjp``, ``cf_hesjvp``: phase 15's timed checks at the
  ``schnet_train`` batch (``cf_hesjvp`` as a force loss calls it and with
  every tangent);
- ``gather_mul_segsum``, ``fused_cfconv``: phase 11's timed checks at the
  serving and MD shapes (their edge cases checked too).

Prints one JSON line per timing. Needs one CUDA card.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from gcnn_keras_tpu_torch.ops.cuda import build
from profile_serving_torch import KERNEL_SOURCES as SOURCES

OUT_DIR = build.BUILD_DIR / "variants"


def variant_sources(kernel, specs):
    src = (build.CSRC_DIR / f"{SOURCES[kernel]}.cu").read_text()
    out = {"cur": src}
    for spec in specs:
        name, rest = spec.split("=", 1)
        if rest.startswith("@"):
            out[name] = Path(rest[1:]).read_text()
            continue
        text = src
        for sub in rest.split(";;"):
            pattern, repl = sub.split("=>")
            text, count = re.subn(pattern, repl.replace("\\n", "\n"), text)
            if not count:
                raise SystemExit(f"variant {name}: {pattern!r} matches nothing")
        out[name] = text
    return out


def build_variants(sources):
    """One nvcc per variant, all started together; returns the loaded libraries."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT_DIR / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(OUT_DIR / f"{name}.so"),
             str(OUT_DIR / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif ("registers" in line or "spill" in line) and entry:
                print(json.dumps({"variant": name, "entry": entry,
                                  "ptxas": line.split("ptxas info")[-1].strip(" :")}))
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    return libs


def segment_sum_timings(libs, order):
    """phase 3's timed check at its three shapes and with no edges, each
    variant loaded in its turn."""
    _, batch = chip_smoke.make_predictor("cuda").make_batch(chip_smoke.qm9_like_mols(0, 512))
    dev = batch.senders.device
    gen = torch.Generator(device=dev).manual_seed(0)
    e, n, g = batch.n_edge, batch.n_node, batch.n_graphs
    by_senders = batch.senders[batch.edges["sender_perm"].long()].contiguous()
    shapes = [("messages by receivers", torch.randn(e, 128, generator=gen, device=dev),
               batch.receivers, n),
              ("positions by sorted senders", torch.randn(e, 3, generator=gen, device=dev),
               by_senders, n),
              ("readout by graph_id", torch.randn(n, 64, generator=gen, device=dev),
               batch.graph_id, g),
              ("no edges", torch.zeros(0, 1, device=dev),
               torch.zeros(0, dtype=torch.int32, device=dev), 1)]
    for label, v, i, m in shapes:
        for name in order:
            build._loaded["segment_sum"] = libs[name]
            rec = chip_smoke.check_segment_sum(v, i, m, label, timed=True)
            print(json.dumps({"variant": name, **{k: rec[k] for k in (
                "case", "ms", "ms_warm", "library_ms", "bound_ms")}}))


def chain_timings(kernel, libs, order):
    """phase 15's timed checks of cf_fwd, cf_vjp or cf_hesjvp, each variant
    loaded in its turn."""
    batch = chip_smoke.train_batch("schnet_chain_train", 0, 512, "cuda")
    model = chip_smoke.schnet_model("chain", "cuda")
    for name in order:
        build._loaded["fused_interaction"] = libs[name]
        for rec in chip_smoke.chain_timed_check(kernel, batch, model):
            print(json.dumps({"variant": name, **{k: rec[k] for k in (
                "case", "ms", "ms_warm", "bound_ms", "max_err_over_tol_scale")}}))


def schnet_kernel_timings(kernel, libs, order):
    """phase 11's timed checks of the gms kernel or the fused cfconv
    (serving and MD shapes), each variant loaded in its turn."""
    _, batch = chip_smoke.make_predictor("cuda").make_batch(chip_smoke.qm9_like_mols(0, 512))
    model = chip_smoke.schnet_model("unfused", "cuda")
    for name in order:
        build._loaded[SOURCES[kernel]] = libs[name]
        recs = chip_smoke.phase_schnet_kernels(batch, model, (kernel,))[kernel]
        for rec in recs:
            if "ms" in rec:
                print(json.dumps({"variant": name, **{k: rec[k] for k in (
                    "case", "ms", "ms_warm", "plain_ms", "unfused_chain_ms", "bound_ms",
                    "max_abs_err")}}))


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in SOURCES:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernel_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = sys.argv[1]
    print(json.dumps({"card": chip_smoke.nvidia_smi(), "kernel": kernel}))
    libs = build_variants(variant_sources(kernel, sys.argv[2:]))
    order = list(libs) + list(libs)[::-1]
    if kernel == "sorted_segment_sum":
        segment_sum_timings(libs, order)
    elif kernel in ("gather_mul_segsum", "fused_cfconv"):
        schnet_kernel_timings(kernel, libs, order)
    else:
        chain_timings(kernel, libs, order)


if __name__ == "__main__":
    main()
