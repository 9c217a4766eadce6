"""What the per-layer metric readers share: the record of every kernel
launch's shapes that the traced run takes, and the arithmetic from a run's
observation to a metric. A reader that finds nothing to read returns
None, and the harness leaves that metric out."""
from __future__ import annotations

import contextlib
import importlib
import pkgutil
from typing import Optional

from benchmark.counts import peaks

PORT_KERNELS = "gcnn_keras_tpu_torch.ops.cuda"


def _mode(obs, mode: str) -> bool:
    return obs.mode == mode and obs.trace is not None


def device_idle(obs, mode: str) -> Optional[float]:
    if not _mode(obs, mode) or obs.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)


def mfu(obs, mode: str) -> Optional[float]:
    if not _mode(obs, mode) or obs.window_s <= 0 or not obs.done:
        return None
    return 100.0 * obs.flops_done() / (obs.window_s * peaks.F32_OPS_PER_S)


def port_launches() -> int:
    """Every kernel launch the port has counted so far: the sum of the
    ``launches*`` counters (a number, or a number a kernel) of its kernel
    modules."""
    pkg = importlib.import_module(PORT_KERNELS)
    total = 0
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{PORT_KERNELS}.{info.name}")
        for attr in dir(mod):
            if attr.startswith("launches"):
                val = getattr(mod, attr)
                if isinstance(val, dict):
                    total += sum(v for v in val.values() if isinstance(v, int))
                elif isinstance(val, int):
                    total += val
    return total


@contextlib.contextmanager
def record_kernel_launches(obs):
    """Inside the block, each call of a wrapper of the configuration's
    kernel files (``"kernels"``: ``kernels/<name>.py``) made in the window
    is recorded as ``(kernel file, shapes)`` in
    ``obs.extra["kernel_launches"]``. The port's autograd Functions look
    the wrappers up by name at each call, so they call the recording ones.
    ``obs.extra["uncovered_launches"]`` counts the port's launches in the
    block that no kernel file covers."""
    if "kernel_launches" in obs.extra:
        yield
        return
    calls = obs.extra["kernel_launches"] = []
    covered = [0]
    patched = []
    for kname in obs.cfg.get("kernels", []):
        kfile = obs.spec.module("kernels", kname)
        mod = importlib.import_module(kfile.MODULE)
        orig = getattr(mod, kfile.WRAPPER)

        def wrapper(*args, _orig=orig, _kname=kname, _kfile=kfile):
            covered[0] += 1
            if obs.in_window:
                calls.append((_kname, _kfile.shapes(*args)))
            return _orig(*args)
        setattr(mod, kfile.WRAPPER, wrapper)
        patched.append((mod, kfile.WRAPPER, orig))
    before = port_launches()
    try:
        yield
    finally:
        for mod, name, orig in patched:
            setattr(mod, name, orig)
        obs.extra["uncovered_launches"] = max(0, port_launches() - before - covered[0])


def kernel_roofline(obs, mode: str) -> Optional[float]:
    """The port's kernels' least time over their device time, in per cent;
    None where none ran, or where the port launched a kernel that no kernel
    file of the configuration covers (the share would then leave it out)."""
    calls = obs.extra.get("kernel_launches")
    if not _mode(obs, mode) or not calls:
        return None
    uncovered = obs.extra.get("uncovered_launches", 0)
    if uncovered:
        obs.extra.setdefault("warnings", []).append(
            f"kernel_roofline: {uncovered} launches of the port's kernels that no file under "
            f"benchmark/kernels/ listed in the configuration covers; not reported")
        return None
    kfiles = {k: obs.spec.module("kernels", k) for k in {name for name, _ in calls}}
    least = sum(kfiles[name].least_seconds(shapes, obs.cfg) for name, shapes in calls)
    markers = sorted({k.KERNEL for k in kfiles.values()})
    spent = obs.trace.kernel_ns(markers) * 1e-9
    launched = obs.trace.kernel_count(markers)
    if spent > 0 and launched != len(calls):
        obs.extra.setdefault("warnings", []).append(
            f"kernel_roofline: {len(calls)} wrapper calls but {launched} kernels in the trace")
    if spent <= 0:
        return None
    return 100.0 * least / spent
