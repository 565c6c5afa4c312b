"""The metric arithmetic: walls, percentiles, operation and byte counts,
rooflines, idle shares."""

import math

import numpy as np
import pytest

from benchmark import counts, run
from benchmark.metrics import _lib
from benchmark.trace import Summary, breakdown, kernel_seconds


def test_ekf6_count_is_chip_smokes():
    assert counts.OPS_PER_LANE_STEP["ekf6"] == 2281


def test_ekf3_count_from_its_outputs():
    # itemized in counts.EKF3_OPS: forward 288, backward (no smoothed
    # covariance: no output reads it) 143
    assert counts.A3_PRODUCT_OPS == 33
    assert counts.OPS_PER_LANE_STEP["ekf3"] == 431


@pytest.mark.parametrize("kernel,steps,lanes", [
    ("ekf6", 532, 58750), ("ekf3", 440, 14100), ("ekf3", 380, 235)])
def test_work_and_least_time(kernel, steps, lanes):
    ops, nbytes = counts.work(kernel, steps, lanes)
    assert ops == counts.OPS_PER_LANE_STEP[kernel] * steps * lanes
    words = (counts.WORDS_PER_LANE_STEP[kernel] * steps
             + counts.WORDS_PER_LANE[kernel]) * lanes
    assert nbytes == 4 * words
    t = counts.least_seconds(ops, nbytes)
    assert t == max(ops / 67e12, nbytes / 3.35e12)


def test_backtest_ekf3_is_bytes_bound():
    ops, nbytes = counts.work("ekf3", 440, 14100)
    assert nbytes / counts.PEAK_BYTES_PER_S > ops / counts.PEAK_F32_PER_S
    # chip_smoke's bound of this launch: 0.1714 ms
    assert counts.least_seconds(ops, nbytes) == pytest.approx(1.714e-4,
                                                              rel=2e-3)


def test_rate_is_window_over_requests_and_tail_over_all():
    walls = [0.5, 0.6, 0.55, 1.2, 0.52, 0.58, 0.61, 0.5, 0.49, 0.7, 0.66]
    window = math.fsum(walls) + 0.01
    assert run.reduce_walls(walls, window, "mean") == pytest.approx(
        window / len(walls))
    assert run.reduce_walls(walls, window, "p90") == pytest.approx(
        float(np.percentile(walls, 90)))
    # the tail reads every request: the slowest one moves it
    rest = walls[:3] + walls[4:]
    assert run.reduce_walls(walls, window, "p90") > run.reduce_walls(
        rest, window, "p90")


def summary(busy=0.2, window=1.0, requests=2):
    return Summary(busy, window, requests, 100,
                   {"void (anonymous namespace)::ekf6_fwd_kernel(float)":
                    [20, 0.004],
                    "void (anonymous namespace)::ekf6_bwd_kernel(float)":
                    [20, 0.002],
                    "Memcpy HtoD (Pageable -> Device)": [60, 0.001]},
                   {"cudaLaunchKernel": 0.3, "aten::mul": 0.5})


def ctx(calls, trace=None, walls=(0.5, 0.5, 0.6, 0.4), traced=0):
    return run.Context(list(walls), [{"train": 0.1, "pareto": 0.3}] *
                       len(walls), calls, traced=traced, trace=trace)


def test_roofline_counts_shapes_not_launches():
    calls = [("ekf6", 532, 250 * 235)]
    c = ctx(calls, summary(requests=2))
    ops, nbytes = counts.work("ekf6", 532, 250 * 235)
    want = 100 * counts.least_seconds(ops, nbytes) * 2 / 0.006
    assert _lib.roofline(c, "ekf6", ("ekf6_fwd_kernel",
                                     "ekf6_bwd_kernel")) == pytest.approx(want)
    assert kernel_seconds(c.trace, ("ekf6_fwd_kernel",)) == pytest.approx(
        0.004)


def test_readers_find_nothing_without_a_trace():
    c = ctx([("ekf6", 532, 100)])
    assert _lib.roofline(c, "ekf6", ("ekf6_fwd_kernel",)) is None
    assert _lib.idle_share(c) is None
    assert _lib.launches_per_request(c) is None
    assert _lib.roofline(ctx([("ekf6", 532, 100)], summary()), "ekf3",
                         ("ekf3_kernel",)) is None


def test_idle_launches_mfu_and_stages():
    c = ctx([("ekf3", 440, 235)], summary(busy=0.25, window=1.0),
            walls=(0.5, 0.5, 0.9), traced=1)
    # two traced requests kept the device busy 0.125 s each; an untraced
    # request takes 0.5 s
    assert _lib.idle_share(c) == pytest.approx(75.0)
    assert _lib.launches_per_request(c) == pytest.approx(50.0)
    ops, _ = counts.work("ekf3", 440, 235)
    assert _lib.mfu(c) == pytest.approx(100 * ops / (0.5 * 67e12))
    assert _lib.stage_mean(c, "pareto") == pytest.approx(0.3)
    assert _lib.stage_mean(c, "scenarios") is None


def test_breakdown_keeps_ten_largest():
    s = summary()
    b = breakdown(s)
    assert b["device_ops"][0][1] == pytest.approx(0.004)
    assert b["idle_gaps"][0] == ["aten::mul", 0.5]
