"""The port's one tracing module: spans and counters, stage timing and
profiler traces.

Counterpart of epidemicmodeling_tpu/utils/profiling.py (SURVEY.md §5: the
reference has none; its progress is bare disp() statements), extended with
the recording that the program's own spans and counters write to.

- ``span(name)`` (a context manager) and ``count(name, n)`` mark the
  program's stages and count its events; ``host_sync(fn, x)`` is every call
  on a request's path in which the host waits for a device value, counted
  as ``host_sync``. Off, which is the default, each site tests one
  module-global flag and does nothing else: no clock read, no allocation
  (beyond a span site's ``with`` statement's own), no call into the
  profiler.
- ``recording()`` turns them on for its block and yields the
  ``Recording``: the spans (name, start and end on
  ``time.perf_counter_ns``, the span open when it began, a request id: each
  outermost span starts a new request) and the counters. Under a running
  ``torch.profiler`` each span is also a ``record_function`` range, so it
  lands in the trace as a host event on the profiler's clock;
  ``Recording.offset_ns`` maps a span's times onto that clock.
- ``StageTimer`` times named stages on the host's clock (each a span) and,
  before a stage ends, waits for the devices its results lie on;
  ``torch_trace`` captures a torch.profiler trace (CPU and, where a card is
  present, CUDA activity, with the spans) into a log directory, in place of
  the JAX package's jax_trace.

- ``count_on_close(names, counts)`` adds the column sums of a count
  tensor a kernel wrote (on the card) to the counters when the recording
  closes: reading it waits for the device, so it is read there and not on
  the request's path. ``count(name, 0)`` leaves the counter at 0, so that a
  route that makes no host sync reads 0 and not an absent counter.

The backtest's spans (``backtest`` > ``backtest.train`` > ``train.init``,
``train.ekf3``, ``train.regress``; ``backtest.lanes``, ``backtest.ekf3``,
``backtest.errors``) and counters are read by the benchmark's per-layer
metrics (benchmark/metrics/_spans.py and the readers that use it), and so
are run_pipeline's: ``pipeline`` > ``pipeline.train`` (the ``train.*``
spans inside), ``pipeline.forecast``, ``pareto`` > ``pareto.chunk`` (one
an epsilon chunk) > ``pareto.ekf6``, ``pareto.rollout``, ``pareto.score``;
``pipeline`` > ``mc``, ``front``. The counters: ``host_sync``; the NNLS's
(regression/nnls.py), on the CPU the plain version's batched loop trips
``nnls.outer``, ``nnls.inner`` and ``nnls.intercept``, on the card the
kernel's ``nnls.launches`` and its per-problem iterations summed over the
problems, ``nnls.lane_outer``, ``nnls.lane_inner`` and
``nnls.lane_intercept``; ``lasso.sweeps``; the EKS kernels' launches on the
card, ``ekf3.launches``, ``ekf6.launches`` and ``ekf6.lanes``; the
rollout kernel's, ``rollout.launches`` (ops/cuda/rollout_kernel.py); and the
sweep's ``ekf6.costate_nonfinite`` (pipelines/core.py), the smoothed
costates that are not finite, summed at the recording's close.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

# the recording in force, or None: the one flag every span and count site
# tests
_REC = None


class _Off:
    """span() with the recording off: enters and leaves without work (no
    argument tuple to allocate, as contextlib.nullcontext's has)."""

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class Recording:
    """What ``recording()`` yields. ``spans``: one dict a span, in the order
    they began: ``name``, ``start_ns`` and ``end_ns`` (time.perf_counter_ns),
    ``parent`` (the index in ``spans`` of the span open when it began, or
    None) and ``request`` (numbered from 0 in the recording: a span without
    a parent starts a new one). ``counters``: name -> total. ``offset_ns``:
    time.time_ns() - time.perf_counter_ns() when the recording began; a
    span's times plus it are on the profiler's clock. The counts of
    ``count_on_close`` are in ``counters`` once the recording has
    closed."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.requests = 0
        self._open = []
        self._on_close = []

    def _close(self):
        for names, counts in self._on_close:
            sums = counts.cpu().reshape(-1, len(names)).sum(0).tolist()
            for name, n in zip(names, sums):
                self.counters[name] = self.counters.get(name, 0) + n
        self._on_close = []


class _Span:
    """One span of a recording (span() with the recording on)."""

    __slots__ = ("rec", "name", "row", "range")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if rec._open:
            parent = rec._open[-1]
            request = rec.spans[parent]["request"]
        else:
            parent, request = None, rec.requests
            rec.requests += 1
        rec._open.append(len(rec.spans))
        self.row = dict(name=self.name, start_ns=0, end_ns=0, parent=parent,
                        request=request)
        rec.spans.append(self.row)
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.row["start_ns"] = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.row["end_ns"] = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec._open.pop()
        return False


def span(name: str):
    """A context manager: the block is a span of ``name`` in the recording
    in force (see the module docstring), or nothing."""
    rec = _REC
    if rec is None:
        return _OFF
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the recording in force."""
    rec = _REC
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def count_on_close(names, counts) -> None:
    """Add the column sums of ``counts`` (an integer tensor (..., len(names))
    on any device) to the counters ``names`` of the recording in force when
    it closes; the tensor is read then, not now. ``counts`` may be a
    function that makes the tensor: it is called now, and only when a
    recording is in force (a count that costs device work to form costs
    nothing with the recording off)."""
    rec = _REC
    if rec is not None:
        rec._on_close.append((tuple(names),
                              counts() if callable(counts) else counts))


def host_sync(fn, x):
    """``fn(x)``, a call in which the host waits for a device value
    (``bool`` of a tensor, ``torch.nonzero``), counted once as
    ``host_sync``."""
    rec = _REC
    if rec is not None:
        rec.counters["host_sync"] = rec.counters.get("host_sync", 0) + 1
    return fn(x)


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the block; yields the Recording.
    A recording inside another takes the block's records from it."""
    global _REC
    prev, rec = _REC, Recording()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = prev
        rec._close()


def _devices(tree) -> set:
    """The CUDA devices of the tensors in a nest of tuples, lists, dicts and
    NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_devices(v) for v in tree))
    return set()


class StageTimer:
    """Collects the wall-clock seconds of named stages, each a span of its
    name; a stage given ``block_on`` (tensors, or a nest of them) ends only
    when the CUDA devices they lie on have finished (nothing to wait for on
    the CPU)."""

    def __init__(self, log_fn=None):
        self.times = {}
        self._log = log_fn

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                for device in _devices(block_on):
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                self.times[name] = self.times.get(name, 0.0) + dt
                if self._log:
                    self._log(f"[{name}] {dt:.2f}s")

    def summary(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v:.2f}s ({100*v/total:.0f}%)"
                 for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])]
        return f"total {total:.2f}s | " + ", ".join(lines)


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace of the block (CPU activity, and CUDA
    activity when a card is present) and write it into ``log_dir`` as a
    Chrome trace (``<worker>.<time>.pt.trace.json``, for Perfetto or
    TensorBoard), with the program's spans as host ranges (the recording is
    on for the block, unless one already is); yields the profiler, whose
    key_averages() sum the time by operation. A no-op, yielding None, when
    log_dir is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    write = tensorboard_trace_handler(str(log_dir))
    with profile(activities=activities, on_trace_ready=write) as prof, \
            (_OFF if _REC is not None else recording()):
        yield prof
