"""Kernel #1, the sorted segment-sum (``csrc/segment_sum.cu``): the port's
wrapper that launches it, the kernel's name in the trace, and the least
time the H100 could take at a launch's shapes (``counts/work.py``).

A kernel file names ``MODULE`` and ``WRAPPER`` (the port's Python function
that launches the kernel, looked up by name at each call), ``KERNEL`` (a
part of the kernel's name in the profiler's trace), ``shapes(*args)`` (what
one launch's work depends on, from the wrapper's arguments) and
``least_seconds(shapes, cfg)``. A configuration lists the kernel files of
the kernels its model launches under ``"kernels"``."""
from benchmark.counts import work

MODULE = "gcnn_keras_tpu_torch.ops.cuda.segment_sum"
WRAPPER = "segment_sum"
KERNEL = "sorted_segment_sum"


def shapes(values, ids, num_segments):
    return (values.shape[0], values.shape[1], num_segments, values.element_size())


def least_seconds(shapes, cfg):
    return work.segment_sum_seconds(*shapes)
