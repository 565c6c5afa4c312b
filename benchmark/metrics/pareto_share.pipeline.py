"""Percent of a run_pipeline request that its Pareto sweep takes: the
program's ``pareto`` span over its ``pipeline`` span (both end after the
stage's wait for the card), mean over the span-timed requests. None on a
program without these spans."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_request(
        _spans.view(ctx),
        lambda r: _spans.span_share(r, "pareto", "pipeline"))
