#!/usr/bin/env python3
"""Time the ekf3, ekf6 and pairwise CUDA kernels against the first
design of their sources, in one process on one card.

    mkdir -p build/parent
    git archive 4f97d94 epidemicmodeling_torch/csrc | tar -x -C build/parent
    python3 scripts/kernel_ab.py --old-csrc build/parent/epidemicmodeling_torch/csrc

Run it from the root of a checkout on a machine with one CUDA card and nvcc.
The old sources must be those of commit 4f97d94, the last with the first
designs of ekf6.cu and pairwise.cu: the script calls them through that
commit's C interface, and it checks the parameter count of every function
it calls in the old sources (OLD_SIGNATURES) and stops before loading
anything if one differs. It builds the old ekf3.cu, ekf6.cu and pairwise.cu
with the port's own nvcc flags (one nvcc each, started together) and prints
their ptxas lines, then times the old and the new kernels in turns (old,
new, new, old; each a median of CUDA-event timed warm runs) on the same
inputs:
- ekf3 and ekf6, forward and backward launched on their own, on the inputs
  of chip_smoke.py's kernel phase: ekf3's two pipeline inputs (T = 440 and
  532, B = 235); ekf6's at T = 532, B = 5,875, the pipeline's sweep chunk
  (float32 overflow) and the two per-capita inputs;
- pairwise at N = 20,000 and 100,000 uniform agents in the default
  environment (chip_smoke.py's seeds); the old library is the
  one-thread-per-row kernel (pos, obs, force, N, O, weights, stream).
Last, it builds the old ekf6.cu once more without its backward's
smoothed_cov call, whose result no output reads, and counts the SASS
instructions of both backward kernels (cuobjdump), which says whether nvcc
had dropped that dead work.

It prints one JSON line with every time and, last, the card's name and
power limit. Needs no network; writes only under build/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from epidemicmodeling_torch.ops.cuda import (build,  # noqa: E402
                                             ekf3_kernel, ekf6_kernel,
                                             pairwise_kernel)
from epidemicmodeling_torch.spatial import PopulationSimConfig  # noqa: E402
from epidemicmodeling_torch.spatial.agents import \
    default_environment  # noqa: E402

F32 = torch.float32
OUT = build.BUILD_DIR.parent / "kernel_ab"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
EKF6_SIG = {"ekf6_forward": [_P] * 11 + [_I, _I, _F, _I, _F, _F, _I, _P],
            "ekf6_backward": [_P] * 11 + [_I, _I, _P]}
EKF3_SIG = {"ekf3_forward": [_P] * 11 + [_I, _I, _F, _I, _F, _F, _I, _P],
            "ekf3_backward": [_P] * 8 + [_I, _I, _P]}
# the C interface of the old sources, by file
OLD_SIGNATURES = {
    "ekf3": EKF3_SIG, "ekf6": EKF6_SIG,
    "pairwise": {"pairwise_forces": [_P, _P, _P, _I, _I, _F, _F, _F, _F,
                                     _P]}}
ORDER = ("old", "new", "new", "old")


def n_params(source: str, fn: str) -> int:
    """The parameter count of ``int fn(...)`` as declared in ``source``."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)", source)
    if not m:
        raise SystemExit(f"{fn} is not declared in the old sources")
    return m.group(1).count(",") + 1


def check_old_interface(csrc: Path) -> None:
    """Stop unless every function this script calls in the old sources has
    the parameter count it passes (the old sources must be commit
    4f97d94's)."""
    for name, sig in OLD_SIGNATURES.items():
        text = (csrc / f"{name}.cu").read_text()
        for fn, argtypes in sig.items():
            if n_params(text, fn) != len(argtypes):
                raise SystemExit(
                    f"{csrc / name}.cu: {fn} takes {n_params(text, fn)} "
                    f"parameters, this script passes {len(argtypes)}; it "
                    "compares against commit 4f97d94's sources only")


def build_old(csrc: Path):
    """nvcc the old ekf3.cu, ekf6.cu and pairwise.cu; returns {name: ctypes
    lib}."""
    check_old_interface(csrc)
    OUT.mkdir(parents=True, exist_ok=True)

    def one(name):
        so = OUT / f"old_{name}.so"
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                               str(so), str(csrc / f"{name}.cu")],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on old {name}.cu:\n"
                               f"{proc.stderr}")
        for line in proc.stderr.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas old {name}: {line.strip()}", flush=True)
        return so

    with ThreadPoolExecutor(len(OLD_SIGNATURES)) as pool:
        paths = dict(zip(OLD_SIGNATURES, pool.map(one, OLD_SIGNATURES)))
    libs = {}
    for name, sig in OLD_SIGNATURES.items():
        lib = ctypes.CDLL(str(paths[name]))
        for fn, argtypes in sig.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def ekf_launchers(name, lib, args, device):
    """(forward, backward, S_SMOOTH) for one ekf3 / ekf6 library on ``args``
    (NEWCASES, fixed R, gamma 0.995, as the pipeline runs them)."""
    u, x, Rv, scal, vecs, s_init, Ps_init, s_final, Ps_final = args
    T, _, B = u.shape
    m = s_init.shape[0]
    e = lambda *shape: torch.empty(shape, dtype=F32, device=device)
    S_MINUS, S_PLUS, S_SMOOTH = e(T, m, B), e(T, m, B), e(T, m, B)
    P_MINUS, P_PLUS, U_SM = e(T, m * m, B), e(T, m * m, B), e(T, 12, B)
    stream = torch.cuda.current_stream(device).cuda_stream
    p = lambda t: t.data_ptr()

    def forward():
        code = getattr(lib, f"{name}_forward")(
            p(u), p(x), p(Rv), p(scal), p(vecs), p(s_init), p(Ps_init),
            p(S_MINUS), p(S_PLUS), p(P_MINUS), p(P_PLUS), T, B, 0.995, 0,
            1.0, 0.0, 21, stream)
        assert code == 0, f"{name}_forward: CUDA error {code}"

    def backward():
        if name == "ekf3":
            code = lib.ekf3_backward(p(S_PLUS), p(S_MINUS), p(P_PLUS),
                                     p(P_MINUS), p(scal), p(s_final),
                                     p(Ps_final), p(S_SMOOTH), T, B, stream)
        else:
            code = lib.ekf6_backward(p(u), p(S_PLUS), p(S_MINUS), p(P_PLUS),
                                     p(P_MINUS), p(scal), p(vecs),
                                     p(s_final), p(Ps_final), p(S_SMOOTH),
                                     p(U_SM), T, B, stream)
        assert code == 0, f"{name}_backward: CUDA error {code}"

    return forward, backward, S_SMOOTH


def ekf_ab(libs, device):
    bt, bf, actual, _ = cs.xprize_inputs(cs.R_REGIONS, cs.T_HIST, cs.HORIZON,
                                         seed=0)
    cfg = cs.PipelineConfig(backend="pallas", smoother_gain="solve",
                            pareto_chunk=cs.CHUNK,
                            num_monte_carlo=cs.N_MC)
    new_libs = {"ekf3": build.load("ekf3", ekf3_kernel._SIGNATURES),
                "ekf6": build.load("ekf6", ekf6_kernel._SIGNATURES)}
    out = {}
    for name, tag, args, _, _ in cs.kernel_cases(bt, bf, actual, cfg,
                                                 device):
        runs = {v: ekf_launchers(name, libs[name] if v == "old"
                                 else new_libs[name], args, device)
                for v in ("old", "new")}
        times = {v: {"fwd_ms": [], "bwd_ms": []} for v in runs}
        for v in ORDER:
            fwd, bwd, _ = runs[v]
            fwd()
            times[v]["fwd_ms"].append(cs.cuda_ms(fwd, reps=10))
            times[v]["bwd_ms"].append(cs.cuda_ms(bwd, reps=10))
        torch.cuda.synchronize()
        a, b = runs["old"][2], runs["new"][2]
        both = torch.isfinite(a) & torch.isfinite(b)
        m = {v: {k: float(np.mean(ts)) for k, ts in t.items()}
             for v, t in times.items()}
        for v in m:
            m[v]["ms"] = m[v]["fwd_ms"] + m[v]["bwd_ms"]
            m[v]["runs"] = times[v]
        m["s_smooth_old_vs_new"] = cs.scaled_err(a[both], b[both]) \
            if bool(both.any()) else None
        out[f"{name} {tag}"] = m
        print(f"{name} [{tag}]: old {m['old']['fwd_ms']:.4f} + "
              f"{m['old']['bwd_ms']:.4f} = {m['old']['ms']:.4f} ms; new "
              f"{m['new']['fwd_ms']:.4f} + {m['new']['bwd_ms']:.4f} = "
              f"{m['new']['ms']:.4f} ms; S_SMOOTH old vs new "
              f"{m['s_smooth_old_vs_new']}", flush=True)
    return out


def sass_counts(so: Path) -> dict:
    """SASS instruction count of each kernel in a library (cuobjdump)."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and line.strip().startswith("/*") and ";" in line:
            counts[fn] += 1
    return counts


def dead_cov_check(old_csrc: Path) -> dict:
    """SASS instructions of the old ekf6 backward with and without its
    smoothed_cov call."""
    call = "    smoothed_cov<M>(Pp, Pm, J, Psn);\n"
    text = (old_csrc / "ekf6.cu").read_text()
    assert call in text, "the old ekf6.cu has no smoothed_cov call"
    out = {}
    for tag, src in (("with_call", text), ("without_call",
                                           text.replace(call, ""))):
        cu, so = OUT / f"old_ekf6_{tag}.cu", OUT / f"old_ekf6_{tag}.so"
        cu.write_text(src)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(old_csrc), "-o", str(so), str(cu)],
                       capture_output=True, text=True, check=True)
        out[tag] = next(n for f, n in sass_counts(so).items()
                        if "ekf6_bwd_kernel" in f)
    print(f"old ekf6 backward SASS instructions: {out}", flush=True)
    return out


def pairwise_ab(libs, device):
    cfg0 = PopulationSimConfig(n_subjects=cs.SIM_N)
    _, obs_np = default_environment(cfg0)
    obs = torch.tensor(obs_np, dtype=F32, device=device)
    gen = torch.Generator(device).manual_seed(7)
    lo = torch.tensor([cfg0.x_min, cfg0.y_min], device=device)
    span = torch.tensor([cfg0.x_max - cfg0.x_min, cfg0.y_max - cfg0.y_min],
                        device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    for N in (cs.SIM_N, cs.BIG_N):
        cfg = PopulationSimConfig(n_subjects=N)
        pos = lo + span * torch.rand((N, 2), generator=gen, device=device)
        force = torch.empty((N, 2), dtype=F32, device=device)

        def old():
            code = libs["pairwise"].pairwise_forces(
                pos.data_ptr(), obs.data_ptr(), force.data_ptr(), N,
                obs.shape[0], cfg.subject_subject_weight,
                cfg.subject_obstacle_weight, cfg.inter_subject_opt_dist,
                cfg.no_further_effect_dist, stream)
            assert code == 0, f"old pairwise_forces: CUDA error {code}"

        new = lambda: pairwise_kernel.social_forces(pos, obs, cfg)
        times = {"old": [], "new": []}
        for v in ORDER:
            times[v].append(cs.cuda_ms(old if v == "old" else new, reps=10))
        old()
        diff = float((new() - force).abs().max())
        m = {v: float(np.mean(ts)) for v, ts in times.items()}
        out[f"N={N}"] = dict(old_ms=m["old"], new_ms=m["new"], runs=times,
                             max_abs_old_vs_new=diff)
        print(f"pairwise N={N} O={obs.shape[0]}: old {m['old']:.4f} ms, new "
              f"{m['new']:.4f} ms (runs {times}); max |old - new| {diff:.3e}",
              flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-csrc", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this timing needs one card")
    device = torch.device("cuda", 0)
    cs.build_all()
    libs = build_old(args.old_csrc)
    res = {"ekf": ekf_ab(libs, device),
           "pairwise": pairwise_ab(libs, device),
           "old_ekf6_bwd_sass": dead_cov_check(args.old_csrc)}
    print(json.dumps(res))
    print(cs.card_line())


if __name__ == "__main__":
    main()
