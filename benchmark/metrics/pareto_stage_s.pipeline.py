"""Seconds a run_pipeline request spends in its Pareto sweep (the program's
stage_seconds[pareto]: pipelines/core.pareto_prescribe), mean per request."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.stage_mean(ctx, "pareto")
