"""Percent of the card's float32 peak (67 TFLOP/s) that a request reaches with
the operations its EKS filters need (benchmark/counts.py), over its mean
wall."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.mfu(ctx)
