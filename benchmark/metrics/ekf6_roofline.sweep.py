"""Percent of its roofline that the ekf6 kernel pair reaches (csrc/ekf6.cu):
the least time of the request's whole ekf6 work (every epsilon and region
lane over T steps, benchmark/counts.py) over the device time of the kernels
named below."""

from benchmark.metrics import _lib

NAMES = ("ekf6_fwd_kernel", "ekf6_bwd_kernel")


def read(ctx):
    return _lib.roofline(ctx, "ekf6", NAMES)
