"""The port's stage timer and profiler trace (epidemicmodeling_torch/utils/
profiling.py) against the JAX package's (epidemicmodeling_tpu/utils/
profiling.py), on the CPU: the same summary text for the same stage times,
stages that accumulate and log, no wait for results on the CPU, and a
trace file written by torch_trace. Waiting for the card's results is
checked on the card (tests/test_torch_cuda.py)."""

import json

import pytest
import torch

from epidemicmodeling_tpu.utils.profiling import StageTimer as JaxStageTimer
from epidemicmodeling_torch.utils.profiling import StageTimer, torch_trace


@pytest.mark.parametrize("times", [
    {"train": 1.234, "predict": 0.5, "prescribe": 3.0},
    {"only": 0.004},
    {"a": 2.0, "b": 2.0, "c": 1e-3, "d": 123.456},
])
def test_summary_text_matches_jax(times):
    mine, theirs = StageTimer(), JaxStageTimer()
    mine.times, theirs.times = dict(times), dict(times)
    assert mine.summary() == theirs.summary()


def test_stages_accumulate_and_log():
    lines = []
    timer = StageTimer(log_fn=lines.append)
    for _ in range(2):
        with timer.stage("fit"):
            pass
    with timer.stage("score"):
        pass
    assert set(timer.times) == {"fit", "score"}
    assert all(v >= 0 for v in timer.times.values())
    assert [line.split("]")[0] for line in lines] == ["[fit", "[fit",
                                                      "[score"]
    assert timer.summary().startswith("total ")


def test_stage_on_cpu_results_waits_for_no_card(monkeypatch):
    def no_card(*_):
        raise AssertionError("synchronized a card for CPU results")
    monkeypatch.setattr(torch.cuda, "synchronize", no_card)
    timer = StageTimer()
    x = torch.ones(3)
    with timer.stage("cpu", block_on={"a": [x, (x * 2,)], "b": 1.0}):
        x = x + 1
    assert "cpu" in timer.times


def test_stage_times_a_raising_block():
    timer = StageTimer()
    with pytest.raises(ValueError):
        with timer.stage("fails"):
            raise ValueError("inside")
    assert "fails" in timer.times


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with torch_trace(str(tmp_path)) as prof:
        y = torch.randn(64, 64) @ torch.randn(64, 64)
        y.sum().item()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert any("aten::mm" in str(e.get("name")) for e in trace["traceEvents"])
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_torch_trace_without_a_directory_is_a_no_op(tmp_path):
    with torch_trace(None) as prof:
        torch.ones(2).sum()
    assert prof is None
