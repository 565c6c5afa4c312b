"""The readers of the xprize-pipeline-f64 cell (ekf6_f64_roofline.pipeline,
ekf3_f64_roofline.pipeline, mfu_f64.pipeline, pareto_share.pipeline,
pareto_launches_per_request.pipeline) and benchmark/counts_f64.py's work, on
the records they are given and on a run with nothing to read (the parent
program's, or no card)."""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import pytest

from benchmark import counts, counts_f64, run
from benchmark.metrics import _spans
from benchmark.trace import Summary


def _ctx(walls=(1.0,) * 6, traced=2, calls=None, trace=None):
    calls = calls if calls is not None else (
        [("ekf3", 440, 235)] * 2 + [("ekf3", 532, 235)] * 2
        + [("ekf6", 532, 58750)])
    return run.Context(walls=list(walls), stage_seconds=[None] * len(walls),
                       calls=calls, traced=traced, trace=trace)


def _summary(by_name, requests=2):
    return Summary(0.5, 1.0, requests, 100, by_name, {})


def test_f64_work_is_counts_at_eight_bytes():
    for kernel, steps, lanes in (("ekf6", 532, 58750), ("ekf3", 440, 235)):
        ops, nbytes = counts_f64.work(kernel, steps, lanes)
        ops32, nbytes32 = counts.work(kernel, steps, lanes)
        assert ops == ops32 and nbytes == 2 * nbytes32
    # the sweep's ekf6 in float64: 2.86 ms of bytes at 3.35 TB/s over 2.10
    # ms of operations at 34 TFLOP/s
    ops, nbytes = counts_f64.work("ekf6", 532, 58750)
    assert counts_f64.least_seconds(ops, nbytes) == nbytes / 3.35e12
    assert ops / 34e12 == pytest.approx(2.097e-3, rel=1e-3)
    assert nbytes / 3.35e12 == pytest.approx(2.857e-3, rel=1e-3)


def test_f64_rooflines_read_only_the_double_instances():
    fwd64 = ("void (anonymous namespace)::ekf6_fwd_kernel<double, false>"
             "(double const*)")
    bwd64 = "void (anonymous namespace)::ekf6_bwd_kernel<double>(double*)"
    fwd32 = ("void (anonymous namespace)::ekf6_fwd_kernel<float, false>"
             "(float const*)")
    k3 = ("void (anonymous namespace)::ekf3_kernel<double, false, true>"
          "(double const*)")
    c = _ctx(trace=_summary({fwd64: [20, 0.2], bwd64: [20, 0.1],
                             fwd32: [5, 9.0], k3: [8, 0.01]}))
    ops, nbytes = counts_f64.work("ekf6", 532, 58750)
    want = 100 * counts_f64.least_seconds(ops, nbytes) * 2 / 0.3
    assert run.reader("ekf6_f64_roofline.pipeline")(c) == pytest.approx(want)
    ops = nbytes = 0.0
    for steps in (440, 440, 532, 532):
        o, b = counts_f64.work("ekf3", steps, 235)
        ops, nbytes = ops + o, nbytes + b
    want = 100 * counts_f64.least_seconds(ops, nbytes) * 2 / 0.01
    assert run.reader("ekf3_f64_roofline.pipeline")(c) == pytest.approx(want)
    # the parent's program: float instances only, nothing to read
    old = _ctx(trace=_summary({"ekf6_fwd_kernel<false>": [20, 0.2],
                               "ekf3_kernel<false, true>": [8, 0.01]}))
    for name in ("ekf6_f64_roofline.pipeline", "ekf3_f64_roofline.pipeline"):
        assert run.reader(name)(old) is None
        assert run.reader(name)(_ctx()) is None


def test_mfu_f64_is_the_filters_over_the_window_walls():
    c = _ctx(walls=(0.8, 1.0, 1.2, 1.0, 5.0, 5.0))
    ops = sum(counts_f64.work(*call)[0] for call in c.calls)
    want = 100 * ops / (statistics.fmean([0.8, 1.0, 1.2, 1.0]) * 34e12)
    assert run.reader("mfu_f64.pipeline")(c) == pytest.approx(want)


def _record(pareto_ns):
    spans = [dict(name="pipeline", start_ns=0, end_ns=10_000, parent=None,
                  request=0),
             dict(name="pipeline.train", start_ns=10, end_ns=1_000,
                  parent=0, request=0),
             dict(name="pareto", start_ns=2_000, end_ns=2_000 + pareto_ns,
                  parent=0, request=0)]
    return SimpleNamespace(spans=spans, offset_ns=0, counters={})


def test_pareto_readers_read_the_records(monkeypatch):
    v = _spans.View([_record(6_000), _record(7_000)],
                    {"pareto.ekf6": 40, "pareto.rollout": 300,
                     "pareto.score": 20, "pareto.chunk": 10, "pareto": 2,
                     "train.ekf3": 9, "pipeline.train": 50,
                     _spans.NO_SPAN: 4}, 2)
    monkeypatch.setattr(_spans, "view", lambda c: v)
    assert run.reader("pareto_share.pipeline")(_ctx()) == pytest.approx(65)
    assert run.reader("pareto_launches_per_request.pipeline")(_ctx()) == 186


def test_pareto_readers_read_nothing_without_the_spans(monkeypatch):
    # the parent's program: no pipeline or pareto span in its records
    bare = SimpleNamespace(spans=[dict(name="train.ekf3", start_ns=0,
                                       end_ns=5, parent=None, request=0)],
                           offset_ns=0, counters={})
    v = _spans.View([bare, bare], {"train.ekf3": 8, _spans.NO_SPAN: 7}, 2)
    monkeypatch.setattr(_spans, "view", lambda c: v)
    for name in ("pareto_share.pipeline",
                 "pareto_launches_per_request.pipeline"):
        assert run.reader(name)(_ctx()) is None
    # and a run without a card
    monkeypatch.setattr(_spans, "view", lambda c: None)
    for name in ("pareto_share.pipeline",
                 "pareto_launches_per_request.pipeline"):
        assert run.reader(name)(_ctx()) is None
