"""Device kernels, copies and sets a backtest launches inside its
training's regressions: the profiler's device events whose runtime call
lies inside a ``train.regress`` span (the innermost program span), per
profiled request."""

from benchmark.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    if v is None or not v.profiled or "train.regress" not in \
            v.launches_by_span:
        return None
    return v.launches_by_span["train.regress"] / v.profiled
