#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (nvcc). In order, it:

1. finds the card (and fails without one);
2. builds the hand-written CUDA kernels from epidemicmodeling_torch/csrc/;
3. holds each kernel against its plain PyTorch version on the card, float32,
   at the shapes the main path gives it, and times both with CUDA events.
   ekf3 runs on the pipeline's own inputs. ekf6 runs on three inputs of the
   sweep's shape (T = 532, B = 5,875): the pipeline's own sweep chunk, whose
   float32 costates overflow on this data (a check that the kernel runs,
   with its errors printed), and two per-capita inputs whose states and
   costates stay finite, one without and one with active control, both
   held at the bounds;
4. checks run_pipeline on a small input against the same call with the
   kernels swapped for their plain versions (same trained parameters, same
   Monte-Carlo schedules);
5. drives run_pipeline at the XPRIZE size (235 regions, 440 training days
   plus a 92-day horizon, 250 epsilons in chunks of 25, 500 Monte-Carlo
   schedules) cold then warm, counts the kernel launches of the warm run and
   checks its outputs.

Every failed check raises, so the exit code is non-zero. Only when all
phases pass does it print the kernel JSON line, the card's name and power
limit, and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time

import numpy as np
import torch

from epidemicmodeling_torch.control import epsilon_grid, random_npi_schedules
from epidemicmodeling_torch.data import (NPI_MAXES_DEFAULT,
                                         build_region_batch,
                                         preprocess_region, synthetic_regions)
from epidemicmodeling_torch.ops.cuda import build, ekf3_kernel, ekf6_kernel
from epidemicmodeling_torch.pipelines import (PipelineConfig, run_pipeline,
                                              trained_params_from_numpy)
from epidemicmodeling_torch.pipelines.core import (
    device_batch, ekf3_lane_inputs, pareto_prep, region_init, stage_params,
    sweep_lane_inputs, to_tensor, train_regions)
from epidemicmodeling_torch.regression import nnls_with_intercept
from tests._torch_helpers import (make_inputs, masked_err, packed_args,
                                  scaled_err)

R_REGIONS, T_HIST, HORIZON = 235, 440, 92
N_EPS, CHUNK, N_MC = 250, 25, 500
MINS = np.zeros(12)
WEIGHTS = np.ones(12)
F32 = torch.float32
# Kernel-vs-plain bounds: the CPU tests' (tests/test_ekf6_kernel.py:83-86,
# 188-190), on the scaled error |a - b| / (|b| + 1) over every component,
# and the share of prescribed cells (rows T_hist .. T-2) that differ. A
# bound on a "_nonfinite" share of 0 requires both sides finite there.
EKF3_BOUNDS = {"s_plus": 1e-4, "s_smooth": 1e-3}
EKF6_FINITE = {"s_plus": 1e-3, "s_smooth": 1e-2, "u_diff": 5e-3,
               "s_plus_nonfinite": 0.0, "s_plus_nonfinite_mismatch": 0.0,
               "s_smooth_nonfinite": 0.0,
               "s_smooth_nonfinite_mismatch": 0.0}
# the same bounds; the active case must also prescribe u_max on at least
# MIN_U_MAX_SHARE of its cells
EKF6_ACTIVE = dict(EKF6_FINITE)
MIN_U_MAX_SHARE = 0.1
KERNELS = {
    "ekf3": dict(run=ekf3_kernel.ekf3, plain=ekf3_kernel.ekf3_plain,
                 source="epidemicmodeling_torch/csrc/ekf3.cu",
                 replaces="epidemicmodeling_tpu/ops/pallas/ekf3_kernel.py:306"),
    "ekf6": dict(run=ekf6_kernel.ekf6, plain=ekf6_kernel.ekf6_plain,
                 source="epidemicmodeling_torch/csrc/ekf6.cu",
                 replaces="epidemicmodeling_tpu/ops/pallas/ekf6_kernel.py:446"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def xprize_inputs(n_regions, t_hist, horizon, seed):
    """Synthetic regions -> (batch_train, batch_full, actual NPIs, the
    generating coefficients as trained parameters)."""
    truth = synthetic_regions(n_regions, t_hist + horizon, seed=seed)
    sers = []
    for tr in truth.values():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc)[:t_hist], None,
                                      tr["u"][:t_hist], tr["pop"]))
    names = list(truth)
    bt = build_region_batch(sers, names)
    bf = build_region_batch(sers, names, horizon=horizon)
    actual = np.stack([tr["u"] for tr in truth.values()])
    a = np.stack([tr["a"] for tr in truth.values()])
    b = np.array([tr["b"] for tr in truth.values()])
    coefs = dict(names=names, population=bt.population, a1=a, b1=b, a2=a,
                 b2=b)
    return bt, bf, actual, coefs


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` warm runs, CUDA events around each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_err(a, b) -> float:
    return float((torch.abs(a.double() - b.double())
                  / torch.abs(b.double())).max())


def per_capita_case(active: bool):
    """ekf6 arguments at the sweep's shape from the per-capita recipe of the
    kernel tests, with slow dynamics (dt = 0.25, rates x 0.2) so that the
    float32 costates stay finite over T = 532 (their growth per step is
    about 1 + dt * rate).

    Without active control: epsilon in [1e-4, 1] and the main path's band
    slope sigma = 1e6, so every phi lies outside the band and every
    prescribed cell is u_min. With it: epsilon in [1e-8, 1e-2], so about a
    third of the cells switch to u_max, and sigma = 10, so the band term
    of the Jacobian enters every optimized step. At sigma = 1e6 each band
    hit adds gamma * dt * sigma / 2 * a * (u_max - u_min), tens here, to
    A[2][5], and with control active the float32 smoother then goes
    non-finite on some lanes in either operation order (PERF.md)."""
    B, T = CHUNK * R_REGIONS, T_HIST + HORIZON
    d = make_inputs(6, B=B, T=T, T_hist=T_HIST, seed=4, dtype=np.float32)
    p = d["params"]
    p["dt"] = np.full(B, 0.25, np.float32)
    p["beta"] = p["beta"] * np.float32(0.2)
    p["gamma"] = p["gamma"] * np.float32(0.2)
    lo, hi = (-8, -2) if active else (-4, 0)
    p["epsilon"] = (10 ** np.random.default_rng(9).uniform(lo, hi, B)
                    ).astype(np.float32)
    if active:
        p["sigma"] = np.full(B, 10.0, np.float32)
    return d


def kernel_cases(bt, bf, actual, cfg, device):
    """(kernel, tag, arguments, bounds, timed) at the main path's shapes.
    The pipeline's own inputs come from its input code: the first training
    round, then (from the coefficients a kernel-path training returns) the
    actual-NPI scenario and one Pareto chunk whose 25 epsilons span the
    whole grid. bounds None: a check that the kernel runs, errors printed."""
    bt_d, _, _ = device_batch(bt, F32, device)
    bf_d, _, _ = device_batch(bf, F32, device)
    init = region_init(bt_d, cfg, F32, device)
    p_r1 = stage_params(cfg, bt_d, None, MINS, NPI_MAXES_DEFAULT, F32,
                        device)
    yield "ekf3", "train round 1", ekf3_kernel.pack_ekf3_args(
        *ekf3_lane_inputs(torch.zeros_like(bt_d.npis), bt_d.observations,
                          p_r1, bt_d.obs_noise_var, init)), EKF3_BOUNDS, True
    trained = train_regions(bt, MINS, NPI_MAXES_DEFAULT, T_HIST, cfg,
                            dtype=F32, device=device).trained
    p_full = stage_params(cfg, bf_d, trained, MINS, NPI_MAXES_DEFAULT, F32,
                          device)
    yield "ekf3", "actual scenario", ekf3_kernel.pack_ekf3_args(
        *ekf3_lane_inputs(to_tensor(actual, F32, device), bf_d.observations,
                          p_full, bf_d.obs_noise_var, init)), EKF3_BOUNDS, True
    prep = pareto_prep(cfg, bf_d, trained, init, WEIGHTS, MINS,
                       NPI_MAXES_DEFAULT, T_HIST, F32, device)
    eps = epsilon_grid(N_EPS, F32, device)[::N_EPS // CHUNK]
    yield "ekf6", "sweep chunk", ekf6_kernel.pack_ekf6_args(
        sweep_lane_inputs(prep, eps)), None, True
    yield "ekf6", "per-capita", packed_args(
        6, per_capita_case(False), device), EKF6_FINITE, False
    yield "ekf6", "per-capita, control active", packed_args(
        6, per_capita_case(True), device), EKF6_ACTIVE, False


def compare_kernel(name, tag, args, device, bounds, timed):
    k = KERNELS[name]
    kw = dict(gamma_discount=0.995)
    got = k["run"](*args, **kw)
    ref = k["plain"](*args, **kw)
    torch.cuda.synchronize()
    T, _, B = args[0].shape
    check(all(o.device == device for o in got),
          f"{name} {tag}: kernel output not on {device}")
    if name == "ekf3":
        pairs = {"s_plus": (got[1], ref[1]), "s_smooth": (got[0], ref[0])}
        check(all(bool(torch.isfinite(o).all()) for o in got),
              f"{name} {tag}: non-finite output")
        errs = {n: scaled_err(a, b) for n, (a, b) in pairs.items()}
    else:
        pairs = {"s_plus": (got[2], ref[2]), "s_smooth": (got[0], ref[0])}
        errs = {}
        for n, (a, b) in pairs.items():
            errs[n], errs[n + "_nonfinite_mismatch"] = masked_err(a, b)
            errs[n + "_nonfinite"] = float((~torch.isfinite(b)).double()
                                           .mean())
            check(bool(torch.isfinite(a[:, :3]).all()),
                  f"{name} {tag}: non-finite epidemic state in {n}")
        u, r_u = got[1][T_HIST:-1], ref[1][T_HIST:-1]
        lo, hi = args[4][1], args[4][2]
        check(bool(((u == lo) | (u == hi)).all()),
              f"{name} {tag}: a prescribed cell is neither u_min nor u_max")
        check(bool((got[1][-1] == 0).all()), f"{name} {tag}: last U_SM row "
                                             "not 0")
        errs["u_diff"] = float((u != r_u).double().mean())
        errs["u_max_share"] = float((u == hi).double().mean())
        if bounds is EKF6_ACTIVE:
            check(errs["u_max_share"] >= MIN_U_MAX_SHARE,
                  f"{name} {tag}: control not active")
    # the largest absolute difference over the bounded comparisons
    abs_err = max((float(torch.abs(pairs[n][0] - pairs[n][1]).max())
                   for n in (bounds or {}) if n in pairs), default=0.0)
    line = (f"kernel {name} [{tag}] T={T} B={B}: "
            + " ".join(f"{n}={v:.3e}" for n, v in errs.items()))
    ms = plain_ms = None
    if timed:
        ms = cuda_ms(lambda: k["run"](*args, **kw))
        plain_ms = cuda_ms(lambda: k["plain"](*args, **kw))
        line += f" kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}"
    log(line + ("" if bounds else " (runs; not bounded)"))
    for n, bound in (bounds or {}).items():
        check(errs[n] <= bound, f"{name} {tag}: {n} {errs[n]:.3e} > {bound}")
    return dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, T=T, B=B)


@contextlib.contextmanager
def plain_versions():
    """Route the pipeline's kernel calls to the kernels' plain versions."""
    saved = ekf3_kernel.ekf3, ekf6_kernel.ekf6
    ekf3_kernel.ekf3 = ekf3_kernel.ekf3_plain
    ekf6_kernel.ekf6 = ekf6_kernel.ekf6_plain
    try:
        yield
    finally:
        ekf3_kernel.ekf3, ekf6_kernel.ekf6 = saved


def small_reference_check(device):
    """run_pipeline with the kernels against the same call with their plain
    versions, on the same card, float32, from the same trained parameters
    and Monte-Carlo schedules."""
    T_h, H = 100, 20
    bt, bf, actual, coefs = xprize_inputs(16, T_h, H, seed=1)
    eps = epsilon_grid(16).numpy()
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve",
                         pareto_chunk=4, num_monte_carlo=32)
    u_random = random_npi_schedules(torch.Generator().manual_seed(1), 32,
                                    MINS, NPI_MAXES_DEFAULT, H)
    run = lambda: run_pipeline(
        bt, bf, actual, T_h, WEIGHTS, eps, MINS, NPI_MAXES_DEFAULT, T_h, cfg,
        dtype=F32, device=device, u_random=u_random,
        trained=trained_params_from_numpy(coefs, F32, device))
    k = run()
    with plain_versions():
        p = run()
    errs = {
        "s_hist": scaled_err(k.s_hist, p.s_hist),
        "scenario_J0": max(rel_err(k.scenarios[n].J0, p.scenarios[n].J0)
                           for n in p.scenarios),
        "pareto_u_diff": float((k.pareto["u_prescribed"][:, :, :-1]
                                != p.pareto["u_prescribed"][:, :, :-1])
                               .double().mean()),
        "pareto_J1_med": float(torch.median(
            torch.abs(k.pareto["J1"] / p.pareto["J1"] - 1))),
        "mc_J0": rel_err(k.monte_carlo["J0"], p.monte_carlo["J0"]),
    }
    log("small reference (kernels vs plain versions, 16 regions x "
        f"{T_h}+{H} days, 16 eps): "
        + " ".join(f"{n}={v:.3e}" for n, v in errs.items()))
    bounds = {"s_hist": 1e-3, "scenario_J0": 1e-3, "pareto_u_diff": 5e-3,
              "pareto_J1_med": 1e-2, "mc_J0": 1e-3}
    for n, bound in bounds.items():
        check(errs[n] <= bound, f"small reference {n} {errs[n]:.3e} > "
                                f"{bound}")


def all_tensors(res):
    sc = [t for s in res.scenarios.values() for t in s]
    yield from (res.trained.a1, res.trained.b1, res.trained.a2,
                res.trained.b2, res.pareto_front, res.s_hist, *sc)
    yield from (v for v in res.pareto.values() if v is not None)
    yield from res.monte_carlo.values()


def main_path(device, bt, bf, actual):
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve",
                         pareto_chunk=CHUNK, num_monte_carlo=N_MC)
    eps = epsilon_grid(N_EPS).numpy()

    def run():
        ekf3_kernel.launches = 0
        ekf6_kernel.launches = 0
        t0 = time.perf_counter()
        res = run_pipeline(bt, bf, actual, T_HIST, WEIGHTS, eps, MINS,
                           NPI_MAXES_DEFAULT, T_HIST, cfg,
                           generator=torch.Generator().manual_seed(0),
                           dtype=F32, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, wall, {"ekf3": ekf3_kernel.launches,
                           "ekf6": ekf6_kernel.launches}

    for tag in ("cold", "warm"):
        res, wall, launches = run()
        stages = " ".join(f"{k}={v:.3f}s" for k, v in
                          res.stage_seconds.items())
        log(f"main path {tag}: wall={wall:.3f}s {stages} "
            f"launches={launches}")
    device_time(run, wall)
    fd_rate = N_EPS * R_REGIONS * (T_HIST + HORIZON) \
        / res.stage_seconds["pareto"]
    log(f"sweep filter-days/s (warm, pareto stage wall): {fd_rate:.4e}")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")

    check(launches["ekf3"] >= 3, f"ekf3 launched {launches['ekf3']} times")
    check(launches["ekf6"] >= 10, f"ekf6 launched {launches['ekf6']} times")
    check(all(t.device == device for t in all_tensors(res)),
          f"an output tensor is not on {device}")
    a2 = res.trained.a2
    check(bool(torch.isfinite(a2).all() and (a2 >= 0).all()),
          "a2 not finite and >= 0")
    for src, d in (("pareto", res.pareto), ("monte carlo", res.monte_carlo),
                   *((f"scenario {n}", s._asdict())
                     for n, s in res.scenarios.items())):
        check(bool(torch.isfinite(d["J0"]).all()
                   and torch.isfinite(d["J1"]).all()),
              f"{src} costs not finite")
    u = res.pareto["u_prescribed"]
    check(tuple(u.shape) == (N_EPS, R_REGIONS, HORIZON, 12),
          f"u_prescribed shape {tuple(u.shape)}")
    hi = to_tensor(NPI_MAXES_DEFAULT, F32, device)
    check(bool(((u == 0) | (u == hi)).all()),
          "a prescribed cell is neither u_min nor u_max")
    lo_eps, hi_eps = float(u[0].mean()), float(u[-1].mean())
    log(f"mean prescribed NPI level: eps={eps[0]:.0e} -> {lo_eps:.4f}, "
        f"eps={eps[-1]:.6f} -> {hi_eps:.4f}")
    check(lo_eps >= hi_eps, "NPI level at eps=1e-12 below that at eps~1")
    check(int(res.pareto_front.sum(dim=0).min()) >= 1,
          "a region has an empty Pareto front")
    check(tuple(res.monte_carlo["J0"].shape) == (N_MC, R_REGIONS),
          "monte carlo shape")
    return res, wall, launches


def device_time(run, wall):
    """Device busy time of one more main-path run under torch.profiler, as
    a share of the warm (unprofiled) wall, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # kernels and copies only: the host ops that launch them carry the
    # same device time again
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=dev, reverse=True)
    busy_ms = sum(dev(e) for e in events) / 1e3
    if busy_ms == 0:
        log("device time: not measured (the profiler saw no device time)")
        return
    log(f"device busy (profiled run): {busy_ms:.3f} ms = "
        f"{busy_ms / 1e3 / wall:.4f} of the warm wall; device launches "
        f"{sum(e.count for e in events)}")
    for e in events[:8]:
        log(f"  {dev(e) / 1e3:9.3f} ms x{e.count:6d}  {e.key[:90]}")


def nnls_counts(device, bt):
    """Iterations of the batched NNLS on the round-2 regression of the
    XPRIZE-size train stage (each iteration is one host sync)."""
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve")
    out = train_regions(bt, MINS, NPI_MAXES_DEFAULT, T_HIST, cfg, dtype=F32,
                        device=device)
    bt_d, _, _ = device_batch(bt, F32, device)
    x_win = to_tensor(NPI_MAXES_DEFAULT, F32, device) - bt_d.npis
    counts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nnls_with_intercept(x_win, out.s_smooth_round2[:, :, 2], counts=counts)
    torch.cuda.synchronize()
    log(f"nnls round-2 regression at {R_REGIONS} regions: {counts} "
        f"in {time.perf_counter() - t0:.3f}s")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs one card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | device_count "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    for name in KERNELS:
        _, report = build.build(name)
        for line in report.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f}s")

    bt, bf, actual, _ = xprize_inputs(R_REGIONS, T_HIST, HORIZON, seed=0)
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve",
                         pareto_chunk=CHUNK, num_monte_carlo=N_MC)
    measured = {}
    for name, tag, args, bounds, timed in kernel_cases(bt, bf, actual, cfg,
                                                       device):
        measured.setdefault(name, []).append(
            compare_kernel(name, tag, args, device, bounds, timed))

    small_reference_check(device)
    _, _, launches = main_path(device, bt, bf, actual)
    nnls_counts(device, bt)

    kernels = []
    for name, k in KERNELS.items():
        big = max((m for m in measured[name] if m["ms"] is not None),
                  key=lambda m: m["T"] * m["B"])
        kernels.append(dict(
            name=name, route="cuda", source=k["source"],
            replaces=k["replaces"], launches=launches[name],
            max_abs_err=max(m["abs_err"] for m in measured[name]),
            ms=big["ms"], plain_ms=big["plain_ms"],
            shape=f"T={big['T']} B={big['B']}"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
