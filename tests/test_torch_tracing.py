"""The port's recording of spans and counters (epidemicmodeling_torch/utils/
profiling.py) on the CPU: off, a span or count site does nothing but test
one flag; on, a small backtest gives the same outputs bit for bit, the span
tree of its stages, and host syncs that cover the NNLS's iterations; under
torch.profiler the spans are host ranges around the operators they hold.
CPU tensors take the NNLS's plain version (its counters exactly as before);
other devices take the kernel's route, which refuses what it cannot take;
counts deferred to the recording's close are summed there; every kernel's
launches count in the recording in force (ops/cuda/build.launch, on a
stand-in library). The benchmark's readers of them are tested in
benchmark/tests/."""

import contextlib
import ctypes
import json
import tracemalloc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from epidemicmodeling_torch.data import (NPI_MAXES_DEFAULT,
                                         build_region_batch,
                                         preprocess_region,
                                         synthetic_oxford_frame)
from epidemicmodeling_torch.pipelines import (PipelineConfig,
                                              forecast_quality_assessment)
from epidemicmodeling_torch.ops.cuda import build, nnls_kernel
from epidemicmodeling_torch.regression.nnls import nnls, nnls_with_intercept
from epidemicmodeling_torch.utils import profiling
from epidemicmodeling_torch.utils.profiling import (StageTimer, count,
                                                    count_on_close,
                                                    host_sync, recording,
                                                    span, torch_trace)

FIELDS = ("est_error_plus", "est_error_smooth", "mean_error_smooth",
          "median_error_smooth")
TREE = [("backtest", None), ("backtest.train", "backtest"),
        ("train.init", "backtest.train"), ("train.ekf3", "backtest.train"),
        ("train.regress", "backtest.train"),
        ("train.ekf3", "backtest.train"),
        ("train.regress", "backtest.train"), ("backtest.lanes", "backtest"),
        ("backtest.ekf3", "backtest"), ("backtest.errors", "backtest")]


@pytest.fixture(scope="module")
def batch():
    _, _, truth = synthetic_oxford_frame(n_regions=3, n_days=100, seed=3)
    sers = [preprocess_region(np.cumsum(tr["s"] * tr["i"] * tr["alpha"]
                                        * tr["pop"]), None, tr["u"],
                              tr["pop"]) for tr in truth.values()]
    return build_region_batch(sers, list(truth))


def backtest(batch):
    return forecast_quality_assessment(
        batch, np.zeros(12), NPI_MAXES_DEFAULT, 60, 10, 8,
        PipelineConfig(backend="pallas"), dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def runs(batch):
    """A backtest with the recording off, and two in one recording."""
    off = backtest(batch)
    with recording() as rec:
        on = [backtest(batch) for _ in range(2)]
    return off, on, rec


def sites(t):
    with span("site.outer"):
        with span("site.inner"):
            count("site.count")
            count("site.count", 3)
            host_sync(bool, t)


def test_off_records_nothing_and_opens_no_range():
    t = torch.ones(2).any()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sites(t)
        torch.ones(3).sum()
    assert profiling._REC is None
    names = {e.name for e in prof.events()}
    assert "aten::sum" in names
    assert not names & {"site.outer", "site.inner"}


def peak_bytes(fn, n=200) -> int:
    """The most memory that n calls of fn held at once beyond what was held
    before them (tracemalloc: transient allocations count too), in the
    second of two traced runs (the first warms the interpreter's and the
    tracer's own caches); compare it with the same reading of another
    function (the reading holds the tracer's own results too)."""
    for _ in range(2):
        it = iter([None] * n)
        tracemalloc.start()
        try:
            base, _ = tracemalloc.get_traced_memory()
            for _ in it:
                fn()
            _, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
    return peak - base


def test_off_reads_no_clock_allocates_nothing_calls_no_profiler(
        monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a site with the recording off did work")

    class NoClock:
        perf_counter_ns = time_ns = perf_counter = refuse

    monkeypatch.setattr(profiling, "time", NoClock)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "Recording", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    t = torch.ones(2).any()

    def counters():
        count("site.count")
        count("site.count", 3)
        host_sync(bool, t)

    def bare():                 # two with statements on an object made once
        with profiling._OFF:
            with profiling._OFF:
                pass

    assert peak_bytes(counters) == peak_bytes(lambda: None)
    # a span site holds no more than the with statement's own bound __exit__
    assert peak_bytes(lambda: sites(t)) <= peak_bytes(bare)


def test_recording_gives_the_same_backtest_bit_for_bit(runs):
    off, on, _ = runs
    for res in on:
        for f in FIELDS:
            a, b = getattr(off, f), getattr(res, f)
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), f
        for n in ("a1", "b1", "a2", "b2"):
            assert torch.equal(getattr(off.trained, n),
                               getattr(res.trained, n)), n


def test_backtest_span_tree(runs):
    _, _, rec = runs
    spans = rec.spans
    assert len(spans) == 2 * len(TREE) and rec.requests == 2
    for k in range(2):
        mine = spans[k * len(TREE):(k + 1) * len(TREE)]
        assert [(s["name"], None if s["parent"] is None
                 else spans[s["parent"]]["name"]) for s in mine] == TREE
        assert {s["request"] for s in mine} == {k}
        for s in mine:
            assert s["start_ns"] <= s["end_ns"]
            if s["parent"] is not None:
                p = spans[s["parent"]]
                assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                    <= p["end_ns"]


def test_host_syncs_cover_the_nnls_iterations(runs):
    _, _, rec = runs
    c = rec.counters
    iterations = sum(c.get(k, 0) for k in ("nnls.outer", "nnls.inner",
                                           "nnls.intercept"))
    assert c["nnls.outer"] > 0 and c["nnls.intercept"] > 0
    assert c["host_sync"] >= iterations


def test_host_syncs_equal_a_hand_count():
    # X = I, y = (1, 2): the outer loop adds column 2, then column 1 (each
    # a loop test and an inner test that fails), and its third test stops
    # it: 5 syncs, 2 outer iterations, no inner one. With the intercept:
    # that NNLS, a nonzero (every lane active), one intercept step (an NNLS
    # of the same 5 syncs, whose zero residual does not improve on the
    # best), a nonzero that finds no lane: 12.
    X = torch.eye(2, dtype=torch.float64)
    y = torch.tensor([1.0, 2.0], dtype=torch.float64)
    with recording() as rec:
        x = nnls(X, y)
    assert x.tolist() == [1.0, 2.0]
    assert rec.counters == {"host_sync": 5, "nnls.outer": 2}
    with recording() as rec:
        nnls_with_intercept(X, y)
    assert rec.counters == {"host_sync": 12, "nnls.outer": 4,
                            "nnls.intercept": 1}


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("CPU tensors took the kernel's route")

    monkeypatch.setattr(nnls_kernel, "nnls_intercept", refuse)
    X = torch.eye(2, dtype=torch.float64)
    y = torch.tensor([1.0, 2.0], dtype=torch.float64)
    with recording() as rec:
        assert nnls(X, y).tolist() == [1.0, 2.0]
        nnls_with_intercept(X, y)
    assert rec.counters == {"host_sync": 17, "nnls.outer": 6,
                            "nnls.intercept": 1}


@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 5, 12), torch.float32, "must be a CUDA tensor"),
    ((2, 5, 33), torch.float64, "1 to 32 columns"),
    ((2, 5, 12), torch.float16, "float32 or float64")])
def test_other_devices_take_the_kernel_or_raise(shape, dtype, match):
    """A tensor off the CPU goes to the kernel's route, which raises on
    what the kernel cannot take: there is no fallback to the plain
    version."""
    X = torch.empty(shape, dtype=dtype, device="meta")
    y = torch.empty(shape[:2], dtype=dtype, device="meta")
    for fn in (nnls, nnls_with_intercept):
        with pytest.raises(ValueError, match=match):
            fn(X, y)


def test_count_on_close_sums_when_the_recording_closes():
    counts = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    with recording() as rec:
        count_on_close(("a", "b"), counts)
        count("host_sync", 0)
        assert rec.counters == {"host_sync": 0}
        counts[0, 0] = 10           # read at the close, not when counted
    assert rec.counters == {"host_sync": 0, "a": 13, "b": 6}
    count_on_close(("a", "b"), counts)      # off: nothing is held
    with recording() as rec:
        pass
    assert rec.counters == {}


def test_spans_enclose_the_nnls_operators_under_the_profiler(batch):
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            recording() as rec:
        backtest(batch)
    events = prof.profiler.kineto_results.events()
    ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.name() == "train.regress")
    ops = [(e.start_ns(), e.end_ns()) for e in events
           if e.name() == "aten::linalg_cholesky_ex"]
    assert len(ranges) == 2 and ops
    for s, e in ops:
        assert any(a <= s and e <= b for a, b in ranges)
    # the recording's own times, on the profiler's clock, lie inside them
    mine = [s for s in rec.spans if s["name"] == "train.regress"]
    for (a, b), s in zip(ranges, mine):
        start, end = (s["start_ns"] + rec.offset_ns,
                      s["end_ns"] + rec.offset_ns)
        assert a - 1_000_000 <= start <= end <= b + 1_000_000


def test_stage_timer_stages_are_spans():
    timer = StageTimer()
    with recording() as rec:
        with timer.stage("fit"):
            with span("fit.inner"):
                pass
    assert [(s["name"], s["parent"]) for s in rec.spans] == [
        ("fit", None), ("fit.inner", 0)]
    assert "fit" in timer.times


def test_torch_trace_shows_the_spans(tmp_path):
    with torch_trace(str(tmp_path)):
        with span("stage.one"):
            torch.randn(16, 16).sum()
    assert profiling._REC is None
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "stage.one" in names


def test_a_recording_inside_another_takes_the_blocks_records():
    with recording() as outer:
        with span("before"):
            count("n")
        with recording() as inner:
            with span("inside"):
                count("n", 2)
        assert profiling._REC is outer
        with span("after"):
            count("n")
    assert profiling._REC is None
    assert [s["name"] for s in outer.spans] == ["before", "after"]
    assert [s["request"] for s in outer.spans] == [0, 1]
    assert outer.counters == {"n": 2}
    assert [s["name"] for s in inner.spans] == ["inside"]
    assert inner.counters == {"n": 2} and inner.requests == 1


class StandInLibrary:
    """A kernel library's stand-in: each entry records its arguments and
    returns ``code`` (0, or the CUDA error it reports)."""

    def __init__(self):
        self.code, self.calls = 0, []

    def __getattr__(self, entry):
        if entry.endswith("_error_string"):
            return lambda code: b"stand-in error"
        return lambda *args: self.calls.append((entry, args)) or self.code


@pytest.mark.parametrize("kernel", list(build.SOURCES))
def test_launches_count_in_the_recording_in_force(kernel, monkeypatch):
    """build.launch calls the entry with the device's current stream last
    and counts the launch as <kernel>.launches in the recording in force:
    nothing with none in force, n launches when told (a ctypes int the
    entry wrote included), none when the entry returns a CUDA error, which
    raises."""
    lib = StandInLibrary()
    monkeypatch.setitem(build._loaded, kernel, lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    build.launch(kernel, {}, "entry", "cuda:0", 1, 2)
    assert profiling._REC is None and lib.calls == [("entry", (1, 2, 7))]
    with recording() as rec:
        build.launch(kernel, {}, "entry", "cuda:0", 3)
        build.launch(kernel, {}, "entry", "cuda:0", n=0)
        build.launch(kernel, {}, "entry", "cuda:0", n=ctypes.c_int(4))
        lib.code = 700
        with pytest.raises(RuntimeError, match="entry failed: CUDA error "
                                               "700"):
            build.launch(kernel, {}, "entry", "cuda:0")
    assert rec.counters == {f"{kernel}.launches": 5}
    assert build.launches(rec, kernel) == 5 and len(lib.calls) == 5
