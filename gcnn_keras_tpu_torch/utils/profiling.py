"""Throughput counters and a profiler trace; counterpart of
``gcnn_keras_tpu/utils/profiling.py``.

- ``ThroughputMeter``: real edges, nodes and graphs a second over steps.
- ``trace``: a ``torch.profiler`` trace (the CPU, and the card where there
  is one), written as a Chrome trace into a directory.
- ``device_memory_stats``: ``torch.cuda.memory_stats`` of a card; ``{}``
  on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from .devices import DeviceLike, resolve_device

TRACE_FILE = "trace.json"


class ThroughputMeter:
    """Counts the real (unpadded) edges, nodes and graphs of each batch.

    The counts stay on the batch's device until ``report``, so a step adds
    no host sync."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self._steps = 0
        self._edges = 0
        self._nodes = 0
        self._graphs = 0

    def start(self):
        self._t0 = time.perf_counter()

    def step(self, batch) -> None:
        """Count one processed ``GraphBatch`` by its masks."""
        if self._t0 is None:
            self.start()
        self._steps += 1
        self._edges = self._edges + batch.edge_mask.sum()
        self._nodes = self._nodes + batch.node_mask.sum()
        self._graphs = self._graphs + batch.globals["graph_mask"].sum()

    def counts(self) -> Dict[str, int]:
        """The steps and the real edges, nodes and graphs counted so far."""
        return {"steps": self._steps, "edges": int(self._edges), "nodes": int(self._nodes),
                "graphs": int(self._graphs)}

    def report(self) -> Dict[str, float]:
        c = self.counts()  # waits for the counts before the clock is read
        dt = max(time.perf_counter() - (self._t0 or time.perf_counter()), 1e-9)
        return {
            "steps_per_s": c["steps"] / dt,
            "edges_per_s": c["edges"] / dt,
            "nodes_per_s": c["nodes"] / dt,
            "graphs_per_s": c["graphs"] / dt,
            "elapsed_s": dt,
        }


@contextlib.contextmanager
def trace(logdir: str = "torch_trace"):
    """Profile the block: CPU activity, and the card's kernels where CUDA is
    available; on exit the trace is written to ``<logdir>/trace.json``
    (Chrome trace format, which Perfetto reads). Yields ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def device_memory_stats(device: DeviceLike = None) -> Dict[str, int]:
    """``torch.cuda.memory_stats`` of ``device`` (the card by default), or
    ``{}`` for a device without them (the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(dev))
