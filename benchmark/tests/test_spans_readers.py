"""The readers of the program's spans and counters
(host_syncs_per_request.backtest, regress_share.backtest,
regress_launches_per_request.backtest) on the records they are given, on
a run with nothing to read (no card, or the parent program's) and on one
that cannot find its own arguments; the attribution of device events to
the innermost span; the spans file; the readers' own requests at a CPU
size, and on the card."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.metrics import _spans

NAMES = ("host_syncs_per_request.backtest", "regress_share.backtest",
         "regress_launches_per_request.backtest")


def record(regress_ns, syncs):
    spans = [dict(name="backtest", start_ns=0, end_ns=10_000, parent=None,
                  request=0)]
    t = 100
    for ns in regress_ns:
        spans.append(dict(name="train.regress", start_ns=t, end_ns=t + ns,
                          parent=0, request=0))
        t += ns + 100
    return SimpleNamespace(spans=spans, offset_ns=5,
                           counters={"host_sync": syncs, "nnls.outer": 9})


def ctx():
    return run.Context(walls=[0.1] * 6, stage_seconds=[None] * 6, calls=[],
                       traced=2, trace=SimpleNamespace(
                           requests=2, device_events=300))


def read(name, c):
    return run.reader(name)(c)


def test_readers_read_the_records(monkeypatch):
    v = _spans.View([record([1000, 3000], 300), record([2000, 2000], 500)],
                    {"train.regress": 250, "backtest.ekf3": 40,
                     _spans.NO_SPAN: 10}, 2)
    monkeypatch.setattr(_spans, "view", lambda c: v)
    assert read("host_syncs_per_request.backtest", ctx()) == 400
    assert read("regress_share.backtest", ctx()) == pytest.approx(40.0)
    assert read("regress_launches_per_request.backtest", ctx()) == 125


@pytest.mark.parametrize("name", NAMES)
def test_no_card_reads_nothing(name, monkeypatch):
    # a run without a card: nothing to read, and no exception
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read(name, ctx()) is None


@pytest.mark.parametrize("name", NAMES)
def test_records_without_the_spans_read_nothing(name, monkeypatch):
    bare = SimpleNamespace(spans=[], offset_ns=0, counters={})
    v = _spans.View([bare, bare], {_spans.NO_SPAN: 7}, 2)
    monkeypatch.setattr(_spans, "view", lambda c: v)
    assert read(name, ctx()) is None


def test_a_run_without_its_arguments_fails_loudly(monkeypatch):
    # the harness driven from code (run.main(argv)): sys.argv does not hold
    # --workload and --seed, and the readers must not read None for it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr("sys.argv", ["benchmark"])
    with pytest.raises(RuntimeError, match="--workload and --seed"):
        _spans.view(ctx())


def test_launches_are_put_down_to_a_span_open_long_before():
    # "train.regress" opened 300 operators (beyond benchmark/trace.py's
    # lookback of 64) before its launches; an event inside no span (4) and
    # one without its runtime call (5) find none
    spans = [(0, 100_000, "train.regress"),
             (200_000, 300_000, "backtest.errors")]
    dev = [(3000, 5000, 1), (50_000, 99_500, 2), (250_000, 251_000, 3),
           (320_000, 330_000, 4), (400_000, 401_000, 5)]
    runtime = {1: 2990, 2: 49_990, 3: 249_990, 4: 319_990}
    got = _spans.launches_by_span(dev, runtime, spans)
    assert got == {"train.regress": 2, "backtest.errors": 1,
                   _spans.NO_SPAN: 2}


def test_spans_file_is_on_the_profilers_clock(tmp_path):
    path = tmp_path / "spans.jsonl"
    _spans.write_spans(path, [record([1000], 1), record([2000], 2)])
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [(r["request"], r["index"], r["parent"], r["name"])
            for r in rows] == [(0, 0, None, "backtest"),
                               (0, 1, 0, "train.regress"),
                               (1, 0, None, "backtest"),
                               (1, 1, 0, "train.regress")]
    assert (rows[1]["start_ns"], rows[1]["end_ns"]) == (105, 1105)


def test_measure_runs_the_cells_requests_under_the_recording(workdir,
                                                            monkeypatch):
    # the readers' own requests at a CPU test's size: the spans and
    # counters of every span-timed request, the spans file; no device
    # events on the CPU
    from benchmark.tests.conftest import small_files
    files = small_files("xprize-backtest", regions=4, t_hist=80)
    files["traffic"]["trace_requests"] = 2
    v = _spans.measure(ctx(), files, 7, torch.device("cpu"), workdir)
    assert v.profiled == len(v.records) == 2 and v.launches_by_span == {}
    for r in v.records:
        assert r.spans[0]["name"] == "backtest" and r.requests == 1
        assert r.counters["host_sync"] >= r.counters["nnls.outer"] > 0
    monkeypatch.setattr(_spans, "view", lambda c: v)
    assert read("host_syncs_per_request.backtest", ctx()) > 0
    assert 0 < read("regress_share.backtest", ctx()) < 100
    rows = (workdir / "spans.jsonl").read_text().splitlines()
    assert len(rows) == sum(len(r.spans) for r in v.records)


@pytest.mark.cuda
def test_backtest_device_events_are_put_down_to_program_spans():
    """A small backtest on the card under torch.profiler and the program's
    recording: each device event is put down to the innermost program span
    around the runtime call that launched it (the profiler's correlation
    id). The regressions launch some, every event is counted once, and
    under 1% find no span (all lie inside ``backtest``, so those are
    events without their runtime call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from epidemicmodeling_torch.data import (NPI_MAXES_DEFAULT,
                                             build_region_batch,
                                             preprocess_region,
                                             synthetic_oxford_frame)
    from epidemicmodeling_torch.pipelines import (
        PipelineConfig, forecast_quality_assessment)
    from epidemicmodeling_torch.utils.profiling import recording
    cuda = torch.device("cuda", 0)
    _, _, truth = synthetic_oxford_frame(n_regions=8, n_days=150, seed=3)
    batch = build_region_batch(
        [preprocess_region(np.cumsum(tr["s"] * tr["i"] * tr["alpha"]
                                     * tr["pop"]), None, tr["u"], tr["pop"])
         for tr in truth.values()], list(truth))
    run_once = lambda: forecast_quality_assessment(
        batch, np.zeros(12), NPI_MAXES_DEFAULT, 100, 20, 20,
        PipelineConfig(backend="pallas"), dtype=torch.float32, device=cuda)
    run_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with recording() as rec:
            run_once()
        torch.cuda.synchronize()
    names = {s["name"] for s in rec.spans}
    dev, runtime, spans = _spans.events(prof, names)
    got = _spans.launches_by_span(dev, runtime, spans)
    assert got.get("train.regress", 0) > 0 and got.get("backtest.ekf3", 0)
    assert sum(got.values()) == len(dev) > 0
    assert got.get(_spans.NO_SPAN, 0) < 0.01 * len(dev), got
