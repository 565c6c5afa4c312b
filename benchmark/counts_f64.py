"""The float64 yardstick of the readers of double-precision cells: the
operations that the filters' outputs need (``counts.py``'s counts, which
hold for either precision), every word 8 bytes, and the card's float64
peak outside the tensor cores.

Counts depend on the shapes only (lanes, steps), as in ``counts.py``.
"""

from __future__ import annotations

import statistics

from . import counts
from .trace import kernel_seconds

# NVIDIA H100 SXM (700 W): float64 outside the tensor cores
PEAK_F64_PER_S = 34e12


def work(kernel: str, steps: int, lanes: int) -> tuple:
    """(float64 operations, bytes) that one call of ``kernel`` over
    ``lanes`` filters of ``steps`` steps needs."""
    ops = counts.OPS_PER_LANE_STEP[kernel] * steps * lanes
    nbytes = 8 * (counts.WORDS_PER_LANE_STEP[kernel] * steps * lanes
                  + counts.WORDS_PER_LANE[kernel] * lanes)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the operations over the float64
    peak or the bytes over the memory rate, whichever is longer."""
    return max(ops / PEAK_F64_PER_S, nbytes / counts.PEAK_BYTES_PER_S)


def request_work(ctx, kernel=None) -> tuple:
    """(operations, bytes) the filter calls of one request need, of one
    kernel or of all."""
    ops = nbytes = 0.0
    for k, steps, lanes in ctx.calls:
        if kernel is None or k == kernel:
            o, b = work(k, steps, lanes)
            ops, nbytes = ops + o, nbytes + b
    return ops, nbytes


def roofline(ctx, kernel: str, names):
    """Percent: the least time of the traced requests' ``kernel`` work in
    float64 over the device time of the events named ``names`` (None where
    the trace holds none of them)."""
    if ctx.trace is None or ctx.trace.requests == 0:
        return None
    spent = kernel_seconds(ctx.trace, names)
    ops, nbytes = request_work(ctx, kernel)
    if spent <= 0 or ops <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes) * ctx.trace.requests / spent


def mfu(ctx):
    """Percent of the float64 peak: the operations the request's filters
    need over the mean wall of the requests the profiler did not trace."""
    walls = ctx.walls[:len(ctx.walls) - ctx.traced]
    ops, _ = request_work(ctx)
    if not walls or ops <= 0:
        return None
    return 100.0 * ops / (statistics.fmean(walls) * PEAK_F64_PER_S)
