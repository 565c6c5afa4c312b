"""Shared arithmetic of the per-layer readers (benchmark/metrics/<name>.py).

A reader's ``read(ctx)`` returns the metric's value, or None when its run
holds nothing to read (no trace, no such kernel, no stage walls): the
harness then leaves the metric out of the result line. ``ctx`` is
benchmark.run.Context.
"""

from __future__ import annotations

import statistics

from .. import counts
from ..trace import kernel_seconds


def steady_walls(ctx) -> list:
    """The walls of the requests the profiler did not trace (the traced
    ones come last)."""
    return ctx.walls[:len(ctx.walls) - ctx.traced]


def stage_mean(ctx, stage: str):
    """Mean seconds a request spent in ``stage`` (the program's
    stage_seconds), over the requests the profiler did not trace."""
    rows = ctx.stage_seconds[:len(ctx.stage_seconds) - ctx.traced]
    vals = [r[stage] for r in rows if r and stage in r]
    return statistics.fmean(vals) if vals else None


def traced_nothing(ctx) -> bool:
    """No trace, or one in which nothing ran on the device."""
    return (ctx.trace is None or ctx.trace.requests == 0
            or ctx.trace.device_events == 0)


def launches_per_request(ctx):
    if traced_nothing(ctx):
        return None
    return ctx.trace.device_events / ctx.trace.requests


def idle_share(ctx):
    """Percent of a request's wall in which no device event runs: the
    device time a traced request keeps busy (the union of its events)
    over the mean wall of the requests the profiler did not trace, whose
    host side it does not slow."""
    walls = steady_walls(ctx)
    if traced_nothing(ctx) or not walls:
        return None
    busy = ctx.trace.busy_s / ctx.trace.requests
    return 100.0 * (1.0 - busy / statistics.fmean(walls))


def work(ctx, kernel=None) -> tuple:
    """(operations, bytes) the filter calls of one request need, of one
    kernel or of all."""
    ops = nbytes = 0.0
    for k, steps, lanes in ctx.calls:
        if kernel is None or k == kernel:
            o, b = counts.work(k, steps, lanes)
            ops, nbytes = ops + o, nbytes + b
    return ops, nbytes


def roofline(ctx, kernel: str, names) -> float | None:
    """Percent: the least time of the traced requests' ``kernel`` work over
    the device time of the events named ``names``."""
    if traced_nothing(ctx):
        return None
    spent = kernel_seconds(ctx.trace, names)
    ops, nbytes = work(ctx, kernel)
    if spent <= 0 or ops <= 0:
        return None
    return 100.0 * counts.least_seconds(ops, nbytes) * ctx.trace.requests \
        / spent


def mfu(ctx):
    """Percent of the float32 peak: the operations the request's filters
    need over the mean wall of a request."""
    walls = steady_walls(ctx)
    ops, _ = work(ctx)
    if not walls or ops <= 0:
        return None
    return 100.0 * ops / (statistics.fmean(walls) * counts.PEAK_F32_PER_S)
