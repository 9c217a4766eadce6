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
  serving and MD shapes (their edge cases checked too);
- ``g2_fwd``, ``g2_jvp``, ``g2_vjp``, ``g4_fwd``, ``g4_jvp``, ``g4_vjp``
  (``csrc/acsf.cu``, whose six ACSF kernels a variant changes together):
  each of the six at phase 5's and 9's serving batch and at the first step
  of ``hdnnp2nd_train`` and ``hdnnp4th_train`` (their captured calls), and
  at the ACSF edge cases (the G2 kernels also at the G2 layout cases);
- ``spd_solve`` (both SPD kernels): phase 7's Qeq solve of the HDNNP4th
  serving request with K = 2 and K = 1, every call of one
  ``hdnnp4th_train`` step (captured), random systems of M = 8, 12 and 32
  (the warp kernel) and 64, 100, 160 and 239 (the block kernel) at the same
  G, and one system of M = 1 (the launch floor), each beside
  ``torch.linalg.solve`` and Cholesky + ``cholesky_solve``, with phase 7's
  edge cases checked.

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
    batch = chip_smoke.full_batch("schnet_chain_train", "cuda")
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


def acsf_calls():
    """``(name, label, args)`` of each ACSF kernel at its main-path shapes:
    the serving batch of phases 5 and 9 (timed), the captured calls of one
    step of ``hdnnp2nd_train`` and ``hdnnp4th_train`` (timed), the edge
    batch and, for the G2 kernels, the G2 layout batch."""
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    pred = chip_smoke.make_hdnnp_predictor("cuda")
    _, serving = pred.make_batch(chip_smoke.qm9_like_mols(0, 512))
    model = pred.model.energy_model
    statics = {"g2": model.acsf_g2._static, "g4": model.acsf_g4._static}
    edge = chip_smoke.acsf_edge_batch(serving.senders.device)
    out = []
    for batch, label, timed in ((serving, "HDNNP2nd serving, 512 mols", True),
                                (edge, "edge batch", False)):
        out += [(name, label, timed, chip_smoke.acsf_call_args(name, statics[name[:2]], batch))
                for name in ka.KERNELS]
    g2_edge = chip_smoke.acsf_g2_edge_batch(serving.senders.device)
    out += [(name, "G2 layout batch", False,
             chip_smoke.acsf_call_args(name, statics["g2"], g2_edge))
            for name in ka.KERNELS if name.startswith("g2")]
    for path in ("hdnnp2nd_train", "hdnnp4th_train"):
        batch = chip_smoke.full_batch(path, "cuda")
        _, trainer, state = chip_smoke.make_trainer(path, "cuda")
        with chip_smoke.captured_calls() as calls:
            trainer.step_fn()(state, batch)
        out += [(name, path, True, calls[name][0]) for name in ka.KERNELS]
    return out


def acsf_timings(libs, order):
    """The six ACSF kernels' checks of ``acsf_calls``, each variant loaded in
    its turn."""
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    build._loaded["acsf"] = libs[order[0]]
    calls = acsf_calls()
    for name in order:
        build._loaded["acsf"] = libs[name]
        ka._entry.cache_clear()
        for kernel, label, timed, args in calls:
            rec = chip_smoke.check_kernel_call(kernel, args, label, timed)
            if timed:
                print(json.dumps({"variant": name, "kernel": kernel, **{k: rec[k] for k in (
                    "case", "ms", "ms_warm", "bound_ms", "max_abs_err")}}))


def spd_calls():
    """``(label, timed, (a, b))`` of the SPD kernels' checks: phase 7's Qeq
    systems (K = 2 and K = 1), the captured calls of one ``hdnnp4th_train``
    step, random systems of M = 8, 12 and 32 (the warp kernel) and 64, 100,
    160 and 239 (the block kernel) at the serving G, and one of M = 1."""
    pred = chip_smoke.make_hdnnp4th_predictor("cuda")
    _, batch = pred.make_batch(chip_smoke.with_esp(chip_smoke.qm9_like_mols(0, 512), 0))
    a, rhs, *_ = chip_smoke.qeq_system(pred.model.energy_model, batch)
    g = a.shape[0]
    out = [("Qeq of the HDNNP4th serving request, K=2", True, (a, rhs)),
           ("Qeq of the HDNNP4th serving request, K=1", True,
            (a, rhs[..., :1].contiguous()))]
    path = "hdnnp4th_train"
    tbatch = chip_smoke.full_batch(path, "cuda")
    _, trainer, state = chip_smoke.make_trainer(path, "cuda")
    with chip_smoke.captured_calls() as calls:
        trainer.step_fn()(state, tbatch)
    out += [(f"{path}, call {i + 1}", True, args) for i, args in enumerate(calls["spd_solve"])]
    out += [(f"random, M={m}", True, chip_smoke.random_spd(g, m, 2, m, a.device))
            for m in (8, 12, 32, 64, 100, 160, 239)]
    out.append(("G=1, M=1, K=1: the launch floor", True, chip_smoke.random_spd(1, 1, 1, 0, a.device)))
    return out, (pred.model.energy_model, batch)


def spd_timings(libs, order):
    """The SPD kernels' checks of ``spd_calls`` and phase 7's edge cases,
    each variant loaded in its turn."""
    build._loaded["spd_solve"] = libs[order[0]]
    calls, phase7 = spd_calls()
    for name in order:
        build._loaded["spd_solve"] = libs[name]
        chip_smoke.phase_spd_kernel(*phase7)
        for label, timed, args in calls:
            rec = chip_smoke.check_spd(*args, label, timed)
            print(json.dumps({"variant": name, **{k: rec[k] for k in (
                "case", "G", "M", "K", "ms", "ms_warm", "bound_ms", "library_ms",
                "cholesky_ms", "max_abs_err")}}))


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
    elif SOURCES[kernel] == "acsf":
        acsf_timings(libs, order)
    elif kernel == "spd_solve":
        spd_timings(libs, order)
    else:
        chain_timings(kernel, libs, order)


if __name__ == "__main__":
    main()
