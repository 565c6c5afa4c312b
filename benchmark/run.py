"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(benchmark/configs/<config>.json: the data recipe, PipelineConfig's fields,
the sizes) and a traffic mix (benchmark/traffic/<traffic>.json: which
entry point one request calls, how many input sets it rotates through, how
the end-to-end metrics reduce the request walls); its limits are in
benchmark/limits/<workload>.json and each per-layer metric's reader in
benchmark/metrics/<metric>.py. See benchmark/README.md.

A run: set-up (input sets made from the seed, the program imported, one
warm request an input set, which builds every kernel the cell uses), then a
closed loop of requests by one caller for ``--seconds`` (the request in
flight at the end finishes and counts), then the check of one finished
request, drawn from the seed, against the plain reference. With --trace 1
the profiler records ``trace_requests`` more requests after the window and
the per-layer metrics are printed instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with one host thread for the libraries' own thread pools:
# the requests are launch-bound on the host, and idle pool threads that
# wake on every small host op only add to the spread between runs
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "epidemicmodeling_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: Path, workload: str) -> dict:
    """The cell's entries and files, found by name."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    applies = lambda m: workload in m.get("workloads", [workload])
    return dict(
        bench=bench, cell=cell,
        config=load_json(root / config["file"]),
        traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        limits=(load_json(limits) if (limits := HERE / "limits"
                / f"{workload}.json").exists() else None),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def reader(name: str):
    """The ``read`` function of benchmark/metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "__"),
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seeds(seed: int, n_sets: int):
    """Independent generators from the run's seed (any integer): one an
    input set, and one for the choice of the request checked."""
    ss = np.random.SeedSequence(seed % 2 ** 64)
    gen = [np.random.default_rng(k) for k in ss.spawn(n_sets + 1)]
    return gen[:n_sets], gen[-1]


def reduce_walls(walls: list, window_s: float, how: str) -> float:
    """"mean": the window's seconds per request; "pNN": the NNth
    percentile of every request's wall."""
    if how == "mean":
        return window_s / len(walls)
    q = int(how[1:])
    return float(np.percentile(np.asarray(walls), q))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Context:
    """What the per-layer readers read."""
    walls: list
    stage_seconds: list
    calls: list
    traced: int = 0
    trace: object = None


def run_window(entry, n_sets, seconds, trace_requests, pick_rng,
               check_set):
    """The closed loop, until ``seconds`` have passed and every input set
    has been served; then, with ``trace_requests``, that many more under
    the profiler (after the others: the profiler slows the host side of
    the requests that follow it too). Returns (walls, stage rows, the kept
    output of the checked set, the profiler or None, the traced host
    seconds, the untraced window's seconds)."""
    walls, stages = [], []
    kept, seen = None, 0

    def one(k):
        nonlocal kept, seen
        t0 = time.perf_counter()
        out = entry.request(k % n_sets)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        stages.append(entry.stage_seconds(out))
        if k % n_sets == check_set:
            seen += 1
            if pick_rng.random() * seen < 1.0:      # reservoir of one
                kept = out
        return t1

    start = time.perf_counter()
    k = 0
    while True:
        t1 = one(k)
        k += 1
        if t1 - start >= seconds and k >= n_sets:
            break
    window_s = t1 - start
    prof, traced_s = None, 0.0
    if trace_requests:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        t0 = time.perf_counter()
        for _ in range(trace_requests):
            t1 = one(k)
            k += 1
        traced_s = t1 - t0
        prof.stop()
    return walls, stages, kept, prof, traced_s, window_s


def run(args, root: Path) -> int:
    import torch
    torch.set_num_threads(1)
    files = cell_files(root, args.workload)
    cell, traffic = files["cell"], files["traffic"]
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s): torch.cuda.is_available()="
            f"{torch.cuda.is_available()}, device_count="
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if files["limits"] is None:
        log(f"no limits for {args.workload!r}: benchmark/limits/"
            f"{args.workload}.json (readings.py gives the readings)")
        return 5
    workdir = root / "build" / "benchmark" / args.workload
    workdir.mkdir(parents=True, exist_ok=True)
    result = run_cell(files, args.seed, args.seconds, args.trace, device,
                      workdir)
    del result["numbers"]
    found = forbidden_modules()
    if found:
        log(f"modules that the run may not load were loaded: {found}")
        return 4
    result["device"].update(
        platform="gpu", kind=torch.cuda.get_device_name(device), count=chips)
    log(f"card: {card_line()}")
    checks = result["checks"]
    for name, (value, limit) in checks.items():
        log(f"check {name}: {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


def run_cell(files: dict, seed: int, seconds: float, trace: int, device,
             workdir: Path) -> dict:
    """One run of a cell on ``device``; returns the result line's object."""
    import torch

    from . import entries

    cfg_file, traffic = files["config"], files["traffic"]
    n_sets = traffic["input_sets"]
    set_rngs, pick_rng = seeds(seed, n_sets)
    entry = entries.load(traffic["entry"])(
        cfg_file, traffic.get("request", {}), device, str(workdir))
    for k in range(n_sets):
        entry.add_set(entry.make_set(set_rngs[k]))
    for k in range(n_sets):                      # warm: builds and loads
        entry.request(k)
    check_set = int(pick_rng.integers(n_sets))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    trace_requests = traffic["trace_requests"] if trace else 0
    walls, stages, kept, prof, traced_s, window_s = run_window(
        entry, n_sets, seconds, trace_requests, pick_rng, check_set)
    n_steady = len(walls) - trace_requests
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    ctx = Context(walls, stages, entry.filter_calls(), traced=trace_requests)
    device_info = {"memory_peak_bytes": int(peak)}
    breakdown = None
    if prof is not None:
        from .trace import breakdown as make_breakdown, summarize
        ctx.trace = summarize(prof, traced_s, trace_requests)
        device_info.update(busy_s=ctx.trace.busy_s, window_s=traced_s)
        breakdown = make_breakdown(ctx.trace)
        del prof

    # the check: the kept request against the reference, after the
    # program's state is freed
    ans = entry.answers(kept, check_set)
    del kept
    entry.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = entry.check(ans, check_set, log=log)
    limits = files["limits"] or {}
    checks = {n: (numbers[n], limits[n]) for n in limits}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())

    if trace:
        metrics = {}
        for m in files["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        how = traffic["end_to_end"]
        for m in files["end_to_end"]:
            if m["name"] in how:
                metrics[m["name"]] = {
                    "value": reduce_walls(walls[:n_steady], window_s,
                                          how[m["name"]]),
                    "unit": m["unit"]}
    log(f"window: {n_steady} requests in {window_s:.4f} s"
        f"{f' and {trace_requests} traced' if trace else ''}; "
        f"setup {setup_s:.4f} s; peak device memory {peak} B; the check "
        f"{time.perf_counter() - t_check:.1f} s")
    out = {"correct": bool(correct), "attempted": n_steady + trace_requests,
           "failed": 0,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    out["numbers"] = numbers
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    return run(args, root)


if __name__ == "__main__":
    sys.exit(main())
