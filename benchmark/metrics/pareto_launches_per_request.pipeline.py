"""Device kernels, copies and sets a run_pipeline request launches inside
its Pareto sweep: the profiler's device events whose runtime call lies
inside the program's ``pareto`` span or a span within it (``pareto.*``,
the innermost program span), per profiled request. None on a program
without these spans."""

from benchmark.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    if v is None or not v.profiled:
        return None
    n = sum(c for name, c in v.launches_by_span.items()
            if name == "pareto" or name.startswith("pareto."))
    return n / v.profiled if n else None
