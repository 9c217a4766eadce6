"""The harness: the one general traffic generator, the timed windows, the
profiler reading, the correctness comparison. Nothing here names a cell,
a configuration or a metric."""
