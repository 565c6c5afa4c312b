"""Percent of a request's wall in which no kernel, copy or set runs on the
card: a traced request's device time over an untraced request's wall."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.idle_share(ctx)
