"""Percent of its float64 roofline that the ekf3 kernel's double instance
reaches (csrc/ekf3.cu): the least time of the request's ekf3 work (two
training rounds and two scenario filters, benchmark/counts.py's operations,
8-byte words, 34 TFLOP/s: benchmark/counts_f64.py) over the device time of
the kernel named below. None on a program without the double instance."""

from benchmark import counts_f64

NAMES = ("ekf3_kernel<double",)


def read(ctx):
    return counts_f64.roofline(ctx, "ekf3", NAMES)
