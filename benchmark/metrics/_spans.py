"""The program's own spans and counters (epidemicmodeling_torch.utils.
profiling) for the readers that read them: host_syncs_per_request,
regress_share and regress_launches_per_request.

A stop-gap until the harness gives the readers the program's records
itself (a ``Context`` field filled by ``benchmark/run.py`` from requests
timed right after the window): ``view(ctx)`` makes them, once a run, after
the harness has finished its requests, its profile and its check. It
builds the cell's entry again from the run's own ``--workload`` and
``--seed`` (the same input sets), serves each input set once (warm), then
runs the traffic's ``trace_requests`` requests under the program's
recording and no profiler (the span-timed requests: the spans and the
counters), and as many under the recording and torch.profiler (the
profiled requests: each device event is put down to the innermost program
span around the runtime call that launched it, found by the profiler's
correlation id). It logs the span-timed requests' mean wall beside the
window's and the launches by span, and writes the span-timed requests'
spans to ``build/benchmark/<cell>/spans.jsonl``, their times on the
profiler's clock. The harness's window, walls, profile and metrics are
done before and untouched.

Requests that follow the harness's profile and check run slower than the
window's, so the readers report what that slowdown does not move: counts,
and the share of a request's span that a layer's spans take.

``view`` gives None where there is nothing to read: a program without the
recording, or a run without a card. It raises where a run with both cannot
find its own arguments on the command line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

NO_SPAN = "none"


class View(NamedTuple):
    records: list           # one Recording a span-timed request
    launches_by_span: dict  # innermost span (NO_SPAN: none) -> device events
    profiled: int           # requests the launches are counted over


_MADE = {}


def view(ctx):
    try:
        from epidemicmodeling_torch.utils.profiling import recording  # noqa
    except ImportError:             # a program without the recording
        return None
    import torch
    if not torch.cuda.is_available():
        return None
    args = _run_args()
    if args not in _MADE:
        _MADE[args] = _make(ctx, *args)
    return _MADE[args]


def per_request(v, fn):
    """The mean of ``fn(record)`` over the span-timed requests, or None
    where ``fn`` finds nothing (returns None) in any of them."""
    if v is None or not v.records:
        return None
    vals = [fn(r) for r in v.records]
    if any(x is None for x in vals):
        return None
    return statistics.fmean(vals)


def span_share(record, name: str, whole: str):
    """Percent of the spans named ``whole`` of one record that the spans
    named ``name`` take (None if either is missing)."""
    def ns(n):
        return sum(s["end_ns"] - s["start_ns"] for s in record.spans
                   if s["name"] == n)
    part, total = ns(name), ns(whole)
    return 100.0 * part / total if part and total else None


def _run_args():
    """(workload, seed) of the harness's command line."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    args, _ = p.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None:
        raise RuntimeError(
            "the program's spans are read from requests run again from the "
            "harness's --workload and --seed, and the command line has "
            f"none: {sys.argv!r}")
    return args.workload, args.seed


def _make(ctx, workload: str, seed: int):
    import torch

    from ..run import cell_files
    root = Path.cwd()
    return measure(ctx, cell_files(root, workload), seed,
                   torch.device("cuda", 0),
                   root / "build" / "benchmark" / workload)


def measure(ctx, files: dict, seed: int, device, workdir: Path) -> View:
    """The span-timed and the profiled requests of a cell's ``files`` (as
    benchmark.run.cell_files gives them) on ``device``; see the module
    docstring."""
    from torch.profiler import ProfilerActivity, profile

    from epidemicmodeling_torch.utils.profiling import recording

    from .. import entries
    from ..run import log, seeds
    from ._lib import steady_walls

    traffic = files["traffic"]
    n, n_sets = traffic["trace_requests"], traffic["input_sets"]
    workdir.mkdir(parents=True, exist_ok=True)
    entry = entries.load(traffic["entry"])(
        files["config"], traffic.get("request", {}), device, str(workdir))
    set_rngs, _ = seeds(seed, n_sets)
    for k in range(n_sets):
        entry.add_set(entry.make_set(set_rngs[k]))
    for k in range(n_sets):
        entry.request(k)
    records, walls = [], []
    for k in range(n):
        with recording() as rec:
            t0 = time.perf_counter()
            entry.request(k % n_sets)
            walls.append(time.perf_counter() - t0)
        records.append(rec)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for k in range(n):
            with recording():
                entry.request(k % n_sets)
    entry.release()
    names = {s["name"] for r in records for s in r.spans}
    dev, runtime, spans = events(prof, names)
    del prof
    launches = launches_by_span(dev, runtime, spans)
    window = steady_walls(ctx)
    if window:
        w, s = statistics.fmean(walls), statistics.fmean(window)
        log(f"span-timed requests: mean wall {w:.6f} s over {n} ("
            + ", ".join(f"{x:.6f}" for x in walls) + f"), the window's "
            f"{s:.6f} s over {len(window)} ({100 * (w / s - 1):+.2f}%: the "
            "recording on, after the harness's profile and check)")
    log(f"device events by the innermost program span around their launch "
        f"(over {n} profiled requests, {len(dev)} events; "
        f"{sum(1 for e in dev if e[2] not in runtime)} without a runtime "
        "call of their correlation id): " + ", ".join(
            f"{k} {v}" for k, v in sorted(launches.items(),
                                           key=lambda kv: -kv[1])))
    write_spans(workdir / "spans.jsonl", records)
    return View(records, launches, n)


def events(prof, span_names):
    """The profiler's raw events: (device events (start_ns, end_ns,
    correlation id), sorted; correlation id -> start_ns of the runtime call
    (a host event named cu*) that made it; the program's spans as host
    events (start_ns, end_ns, name), sorted by start, the longer first on a
    tie). The spans' mirror on the device timeline (user annotations) is no
    device event."""
    from torch.autograd import DeviceType
    dev, runtime, spans = [], {}, []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = (e.end_ns() if hasattr(e, "end_ns")
               else start + e.duration_ns())
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name in span_names:
                spans.append((start, end, name))
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = start
        elif name not in span_names and not (
                hasattr(e, "is_user_annotation") and e.is_user_annotation()):
            dev.append((start, end, e.correlation_id()))
    dev.sort()
    spans.sort(key=lambda h: (h[0], -h[1]))
    return dev, runtime, spans


def launches_by_span(dev, runtime, spans) -> dict:
    """Device events by the innermost of ``spans`` (start, end, name;
    sorted as ``events`` gives them) open at the runtime call that launched
    each, however long ago it began; NO_SPAN for an event outside every
    span or without its runtime call."""
    at = [None] * len(dev)
    times = [runtime.get(c) for _, _, c in dev]
    stack, i = [], 0
    for q in sorted((q for q, t in enumerate(times) if t is not None),
                    key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            at[q] = stack[-1][2]
    return dict(Counter(name or NO_SPAN for name in at))


def write_spans(path: Path, records) -> None:
    """One JSON line a span: the request (its place among ``records``), its
    index and its parent's in the request, its name, and its start and end
    in ns on the profiler's clock."""
    with open(path, "w") as f:
        for k, rec in enumerate(records):
            for i, s in enumerate(rec.spans):
                f.write(json.dumps(dict(
                    request=k, index=i, parent=s["parent"], name=s["name"],
                    start_ns=s["start_ns"] + rec.offset_ns,
                    end_ns=s["end_ns"] + rec.offset_ns)) + "\n")
