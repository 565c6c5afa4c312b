"""Host waits on a device value a backtest makes (the program's counter
``host_sync``: every NNLS and LASSO loop test and the NNLS's
``torch.nonzero``), mean over the span-timed requests."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_request(_spans.view(ctx),
                              lambda r: r.counters.get("host_sync"))
