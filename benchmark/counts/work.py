"""What a kernel of the port needs at a launch's shapes, and the least time
the H100 could take for it: the larger of its bytes over the memory's peak
and its float32 operations (an FMA is 2) over theirs. Bytes count each
input read once and each output written once. A frozen copy of
``chip_smoke.py``'s ``check_segment_sum`` bound."""
from __future__ import annotations

from benchmark.counts import peaks


def _least(nbytes: float, ops: float) -> float:
    return max(nbytes / peaks.BYTES_PER_S, ops / peaks.F32_OPS_PER_S)


def segment_sum_seconds(e: int, f: int, n: int, itemsize: int) -> float:
    """The sorted segment-sum (#1) of ``(e, f)`` values into ``n`` rows:
    values and int32 ids read, the sums written; an add per value."""
    return _least(itemsize * (e * f + n * f) + 4 * e, e * f)
