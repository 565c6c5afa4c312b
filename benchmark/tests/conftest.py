"""Small copies of the benchmark's cells for the CPU tests."""

import copy
import json
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the cells of BENCHMARK.json, and every traffic kind of benchmark/traffic/
# on a configuration it runs on (those without a cell have no limits yet)
CELLS = tuple(w["name"] for w in BENCH["workloads"])
KINDS = {"xprize-phase2": ("pipeline", "backtest"),
         "paper-sweep-2000": ("checkpoint_sweep",)}
PAIRS = tuple((c, t) for c, ts in KINDS.items() for t in ts)


def files_of(config: str, traffic: str) -> dict:
    """A cell's files by its configuration and traffic names, limits and
    all, whether or not BENCHMARK.json lists it."""
    cell = next((w["name"] for w in BENCH["workloads"]
                 if (w["config"], w["traffic"]) == (config, traffic)), None)
    if cell is not None:
        return run.cell_files(ROOT, cell)
    load = lambda *p: json.loads(ROOT.joinpath("benchmark", *p).read_text())
    return dict(config=load("configs", f"{config}.json"),
                traffic=load("traffic", f"{traffic}.json"), limits=None,
                end_to_end=[], per_layer=[])


def cut(files: dict, regions: int = 8, t_hist: int = 120,
        horizon: int = 20) -> dict:
    """The files with the scale cut to a CPU test's: fewer regions and
    days, 16 epsilons in chunks of 4, 16 Monte-Carlo schedules, 6 sampled
    epsilons, backtest starts and look-ahead days a quarter of the
    training window (at most the cell's 60). Widths (12 NPIs, the model)
    and the limits are the cell's."""
    files = copy.deepcopy(files)
    cfg = files["config"]
    cfg["data"].update(regions=regions, t_hist=t_hist, horizon=horizon)
    cfg["epsilon_points"] = 16
    cfg["pipeline"].update(pareto_chunk=4, num_monte_carlo=16)
    req = files["traffic"].setdefault("request", {})
    if "starts" in req:
        n = min(60, t_hist // 4)
        req.update(starts=n, look_ahead=n)
    else:
        req["sampled_epsilons"] = 6
    return files


def small_files(workload: str, **kw) -> dict:
    """A cell of BENCHMARK.json, cut to a CPU test's size."""
    return cut(run.cell_files(ROOT, workload), **kw)


@pytest.fixture
def workdir(tmp_path):
    return tmp_path
