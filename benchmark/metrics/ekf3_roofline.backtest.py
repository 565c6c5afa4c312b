"""Percent of its roofline that the ekf3 kernel reaches (csrc/ekf3.cu) in a
backtest: the least time of the request's ekf3 work (two training rounds and
every (region, start) filter, benchmark/counts.py) over the device time of
the kernel named below."""

from benchmark.metrics import _lib

NAMES = ("ekf3_kernel",)


def read(ctx):
    return _lib.roofline(ctx, "ekf3", NAMES)
