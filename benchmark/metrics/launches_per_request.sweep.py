"""Device kernels, copies and sets a request launches (the profiler's count
over the traced requests), mean per request: the host glue's work."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.launches_per_request(ctx)
