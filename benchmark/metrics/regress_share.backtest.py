"""Percent of a backtest's wall that its training's two regressions take:
the program's ``train.regress`` spans over its ``backtest`` span
(regression/nnls.py at the configuration's defaults), mean over the
span-timed requests."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_request(
        _spans.view(ctx),
        lambda r: _spans.span_share(r, "train.regress", "backtest"))
