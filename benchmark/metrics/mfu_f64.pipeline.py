"""Percent of the card's float64 peak (34 TFLOP/s) that a request reaches
with the operations its EKS filters need (benchmark/counts.py), over its
mean wall."""

from benchmark import counts_f64


def read(ctx):
    return counts_f64.mfu(ctx)
