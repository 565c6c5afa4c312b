"""Stage timing and profiler traces.

Counterpart of epidemicmodeling_tpu/utils/profiling.py (SURVEY.md §5: the
reference has none; its progress is bare disp() statements). StageTimer
times named stages on the host's clock and, before a stage ends, waits for
the devices its results lie on; torch_trace captures a torch.profiler trace
(CPU and, where a card is present, CUDA activity) into a log directory, in
place of the JAX package's jax_trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


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
    """Collects the wall-clock seconds of named stages; a stage given
    ``block_on`` (tensors, or a nest of them) ends only when the CUDA
    devices they lie on have finished (nothing to wait for on the CPU)."""

    def __init__(self, log_fn=None):
        self.times = {}
        self._log = log_fn

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
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
    TensorBoard); yields the profiler, whose key_averages() sum the time by
    operation. A no-op, yielding None, when log_dir is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    write = tensorboard_trace_handler(str(log_dir))
    with profile(activities=activities, on_trace_ready=write) as prof:
        yield prof
