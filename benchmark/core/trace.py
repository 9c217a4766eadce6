"""Reading the profiler's trace of the traced window.

``Trace`` takes ``torch.profiler``'s own events (its Kineto results): host
ops with their thread, times and autograd sequence numbers, the CUDA
runtime calls that launched work, and the device's kernels, copies and
sets, tied to their launches by correlation id. Host and device times are
on one clock. Everything is cut to the window that the harness marks with
the range ``bench::window``. The host ops keep their autograd sequence
numbers (``seq``, and ``fwd``, the forward op's thread of a backward
node), for a reader that attributes device time to a layer.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "bench::window"


class _Op:
    __slots__ = ("name", "tid", "start", "end", "seq", "fwd")

    def __init__(self, name, tid, start, end, seq, fwd):
        self.name, self.tid, self.start, self.end = name, tid, start, end
        self.seq, self.fwd = seq, fwd


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for i, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:160]


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType
        self.ops: List[_Op] = []
        launches: Dict[int, Tuple[int, int]] = {}
        device = []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CPU:
                op = _Op(e.name(), e.start_thread_id(), start, end, e.sequence_nr(),
                         e.fwd_thread_id())
                self.ops.append(op)
                if e.name().startswith(("cuda", "cu")) and e.correlation_id():
                    launches[e.correlation_id()] = (op.tid, start, e.name())
            elif not e.is_user_annotation():
                # (a record_function range shows on the device too, as an
                # annotation over its work: not work)
                device.append((e.name(), start, end, e.correlation_id(),
                               e.linked_correlation_id()))
        win = [o for o in self.ops if o.name == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no bench::window range")
        self.w0, self.w1 = win[-1].start, win[-1].end
        self.window_s = (self.w1 - self.w0) * 1e-9
        # device work that ran in the window, cut to it, with its launch
        self.device = []
        self.unnamed: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
        for name, s, e, corr, linked in device:
            s, e = max(s, self.w0), min(e, self.w1)
            launch = launches.get(corr) or launches.get(linked)
            if e <= s:
                continue
            if not name:
                u = self.unnamed[launch[2] if launch else "(no launch)"]
                u[0] += 1
                u[1] += e - s
            self.device.append((name, s, e, launch))
        self.busy = _merge([(s, e) for _, s, e, _ in self.device])
        self.by_tid: Dict[int, List[_Op]] = defaultdict(list)
        for o in self.ops:
            self.by_tid[o.tid].append(o)
        for ops in self.by_tid.values():
            ops.sort(key=lambda o: o.start)
        self.starts = {tid: [o.start for o in ops] for tid, ops in self.by_tid.items()}
        self.main_tid = win[-1].tid

    # ------------------------------------------------------------ totals
    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def device_ns(self) -> int:
        return sum(e - s for _, s, e, _ in self.device)

    def kernels(self) -> List[tuple]:
        """The kernels of the window (no copies or sets)."""
        return [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]

    def kernel_ns(self, markers) -> int:
        """Device time of the kernels whose name holds one of ``markers``."""
        return sum(e - s for n, s, e, _ in self.kernels() if any(m in n for m in markers))

    def kernel_count(self, markers) -> int:
        return sum(1 for n, *_ in self.kernels() if any(m in n for m in markers))

    # -------------------------------------------------------- breakdown
    def top_device_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for n, s, e, _ in self.device:
            by[short_name(n)] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The window's idle device time, summed by the innermost host op
        that the main thread was in at each gap's middle."""
        gaps, t = [], self.w0
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            gaps.append((t, self.w1))
        ops = self.by_tid.get(self.main_tid, [])
        starts = self.starts.get(self.main_tid, [])
        by: Dict[str, int] = defaultdict(int)
        for s, e in gaps:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "(no host op)"
            for j in range(i, max(i - 5000, -1), -1):
                if ops[j].end >= mid and ops[j].name != WINDOW:
                    name = ops[j].name
                    break
            by[name[:160]] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
