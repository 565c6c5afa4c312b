"""Seconds a run_pipeline request spends in its train stage (the program's
stage_seconds[train]: pipelines/core.train_regions), mean per request."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.stage_mean(ctx, "train")
