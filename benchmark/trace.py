"""Reduction of a torch.profiler trace of the traced requests.

Reads the profiler's raw events (kernels, copies and sets on the device;
operators and runtime calls on the host) once, and keeps what the
per-layer readers and the result line's ``breakdown`` need: the device's
busy time (the union of its events), the device time and count by event
name, and the idle gaps between device events, each attributed to the
innermost host event running when the gap began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

NO_HOST_OP = "host: no profiled op (Python between ops)"


class Summary(NamedTuple):
    busy_s: float             # union of device events
    window_s: float           # host clock over the traced requests
    requests: int             # traced requests
    device_events: int        # kernels, copies and sets
    by_name: dict             # name -> [count, seconds]
    gaps_by_host: dict        # host op name -> idle seconds


def _events(prof):
    """(device, host) lists of (start_ns, end_ns, name)."""
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    dev, host = [], []
    if raw is not None:
        for e in raw.events():
            start = e.start_ns()
            end = (e.end_ns() if hasattr(e, "end_ns")
                   else start + e.duration_ns())
            (host if e.device_type() == DeviceType.CPU else dev).append(
                (start, end, e.name()))
    else:
        for e in prof.events():
            span = (int(e.time_range.start * 1e3), int(e.time_range.end * 1e3),
                    e.name)
            (host if e.device_type == DeviceType.CPU else dev).append(span)
    dev.sort()
    host.sort()
    return dev, host


def summarize(prof, window_s: float, requests: int) -> Summary:
    dev, host = _events(prof)
    by_name = defaultdict(lambda: [0, 0.0])
    for s, e, n in dev:
        by_name[n][0] += 1
        by_name[n][1] += (e - s) * 1e-9
    busy = 0
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, gap_start), (gap_end, _) in zip(merged, merged[1:]):
        gaps[_host_at(host, starts, gap_start)] += (gap_end - gap_start) * 1e-9
    return Summary(busy * 1e-9, window_s, requests, len(dev), dict(by_name),
                   dict(gaps))


def _host_at(host, starts, t, lookback=64):
    """The innermost (latest-starting) host event running at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - lookback), -1):
        if host[j][1] >= t:
            return host[j][2]
    return NO_HOST_OP


def kernel_seconds(summary: Summary, names) -> float:
    """Device seconds of the events whose name holds one of ``names``
    (a demangled kernel name carries its namespace and arguments)."""
    return sum(sec for name, (_, sec) in summary.by_name.items()
               if any(n in name for n in names))


def breakdown(summary: Summary, top: int = 10) -> dict:
    ops = sorted(([n, s] for n, (_, s) in summary.by_name.items()),
                 key=lambda x: -x[1])[:top]
    gaps = sorted(([n, s] for n, s in summary.gaps_by_host.items()),
                  key=lambda x: -x[1])[:top]
    return {"device_ops": ops, "idle_gaps": gaps}
