"""Percent of its float64 roofline that the ekf6 kernel pair's double
instance reaches (csrc/ekf6.cu): the least time of the request's whole ekf6
work (every epsilon and region lane over T steps, benchmark/counts.py's
operations, 8-byte words, 34 TFLOP/s: benchmark/counts_f64.py) over the
device time of the kernels named below. None on a program without the
double instance."""

from benchmark import counts_f64

NAMES = ("ekf6_fwd_kernel<double", "ekf6_bwd_kernel<double")


def read(ctx):
    return counts_f64.roofline(ctx, "ekf6", NAMES)
