#!/usr/bin/env python3
"""Time the hand-written CUDA kernels against earlier designs of their
sources, in one process on one card.

    mkdir -p build/parent build/base
    git archive 4f97d94 epidemicmodeling_torch/csrc | tar -x -C build/parent
    git archive 925b1be epidemicmodeling_torch/csrc | tar -x -C build/base
    python3 scripts/kernel_ab.py \\
        --old-csrc build/parent/epidemicmodeling_torch/csrc \\
        --base-csrc build/base/epidemicmodeling_torch/csrc

Run it from the root of a checkout on a machine with one CUDA card and nvcc.
Any option may be left out; its legs are then skipped.

--old-csrc: commit 4f97d94's sources, the first designs of ekf6.cu and
pairwise.cu, called through that commit's C interface:
- ekf6, forward and backward launched on their own, at T = 532, B = 5,875:
  the pipeline's sweep chunk (float32 overflow) and the two per-capita
  inputs of chip_smoke.py's kernel phase;
- pairwise at N = 20,000 and 100,000 uniform agents in the default
  environment (chip_smoke.py's seeds); the old library is the
  one-thread-per-row kernel (pos, obs, force, N, O, weights, stream);
- the old ekf6.cu built once more without its backward's smoothed_cov
  call, whose result no output reads, and the SASS instructions of both
  backward kernels counted (cuobjdump): whether nvcc had dropped that work.
--base-csrc: commit 925b1be's sources, the designs of ekf3.cu and
stencil.cu before the fused ekf3 and the multi-step stencil:
- ekf3 on chip_smoke.py's two pipeline inputs (T = 440 and 532, B = 235):
  the old forward and backward launches against the one fused launch;
- the stencil's single step at 2048 x 2048 and 8191 x 8193, both schemes,
  each a loop of STENCIL_REPS back-to-back launches through ctypes, so that
  the device, not the host, sets the time; and the 2048 x 2048 rollout of
  249 steps that keeps every frame: the old kernel launched once a step
  against the new one's single call (ceil(249 / 8) launches), and the new
  one keeping only the last field.
--stencil-variant NAME (repeatable): a stencil.cu design tried and not
kept, made from the port's source by the edits in STENCIL_VARIANTS
(unroll2: the row loop unrolled two rows deep, not four; src_ahead: also
the next step's dense source loaded two rows ahead), held bit for bit
against the port's stencil and timed against it in turns on the 2048 x
2048 rollout (every frame, last field only, 4-neighbour, dense sources),
500 steps of 64 sparse injections on 1024 x 1024, and the 8191 x 8193
single step.
--ekf3-variant FILE (repeatable): another ekf3.cu with the port's C
interface (scripts/variants/ekf3_team.cu: the forward on a team of three
threads a lane), its outputs compared with the port's kernel and timed
against it in turns on chip_smoke.py's two pipeline inputs and on the
larger one widened to B = 1,000 (step records in the device scratch).
Variants are built with -I on the port's csrc/, so they may include its
headers.
--roofline-csrc: commit d671226's sources, whose roofline.cu holds the copy
(x + 1) before the persistent TMA ring (65,536 blocks of 256 threads for
1 GiB, four float4 a thread):
    mkdir -p build/prev
    git archive d671226 epidemicmodeling_torch/csrc | tar -x -C build/prev
    python3 scripts/kernel_ab.py \\
        --roofline-csrc build/prev/epidemicmodeling_torch/csrc
It builds that roofline.cu, the port's, the port's with the edits in
ROOFLINE_VARIANTS (other blocks an SM, chunk sizes and stage counts of the
same ring) and scripts/variants/roofline_stream.cu (a persistent
grid-stride copy through registers with streaming hints), and times each,
and PyTorch's x + 1 (torch.add into a preallocated output, as the C entries
write), in turns at 2**26, 2**28 and 2**30 float32 elements: a timed
sample is ROOFLINE_BATCH calls back to back between two CUDA events, so
that the device, not the host, sets the time; rounds alternate the order.
Every version's output, written into a NaN-filled buffer before and again
after the timed calls, must equal x + 1 bit for bit.

--newcase-csrc: commit fa6b3ff's sources, whose newcase_ekf.cu is the
deployment artefact's card build before the team design (one thread an
epsilon lane, 32 lanes a block):
    mkdir -p build/prev_newcase
    git archive fa6b3ff epidemicmodeling_torch/csrc | tar -x -C build/prev_newcase
    python3 scripts/kernel_ab.py \\
        --newcase-csrc build/prev_newcase/epidemicmodeling_torch/csrc
It builds that newcase_ekf.cu (with its own newcase_ekf.cuh) with the
port's flags for the kernel (--fmad=false), runs it and the port's through
the device-pointer entry on chip_smoke.deploy_case() (2,000 epsilons x T
= 532 x P = 12, float64, beta_ekf = 0.9), holds both bit for bit against
each other and against the CPU build (U_OPT_SMOOTH, J0, J1) and times them
in turns (old, new, new, old; each a median of 5 CUDA-event timed warm
calls); it prints each build's ptxas lines and the SMs the new design's
blocks ran on. Then, each in turns with the port's kernel: the probes of
NEWCASE_PROBES (edits of its source: the smoother's loop removed, the
smoother's barrier or the forward's second barrier taken twice, scoring
without J1 or without J0; timed, not held to its outputs), the port's
kernel with no scoring (J0, J1 null) and at beta_ekf = 1 (no monitor),
and the designs of NEWCASE_VARIANT_FILES (scripts/variants/
newcase_ekf_rounds.cu: one gain at a time, a barrier each pivot round),
each held bit for bit against the port's outputs; and one launch of the
port's kernel with clock64() counters added (NEWCASE_CLOCKS), whose
outputs must stay bit for bit, printing the cycles of each phase of lane
0 of block 0.
For every source set it checks the parameter count of every function it
calls (OLD_SIGNATURES, BASE_SIGNATURES) and stops before loading anything
if one differs. It builds the old sources with the port's own nvcc flags
(one nvcc each, started together) and prints their ptxas lines, then times
old and new in turns (old, new, new, old; each a median of CUDA-event timed
warm runs) on the same inputs. It prints one JSON line with every time and,
last, the card's name and power limit. Needs no network; writes only under
build/.
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
                                             pairwise_kernel, roofline_kernel,
                                             stencil_kernel)
from epidemicmodeling_torch.deploy import native as deploy_native  # noqa: E402
from epidemicmodeling_torch.spatial import PopulationSimConfig  # noqa: E402
from epidemicmodeling_torch.spatial.agents import \
    default_environment  # noqa: E402

F32 = torch.float32
OUT = build.BUILD_DIR.parent / "kernel_ab"
_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
EKF6_SIG = {"ekf6_forward": [_P] * 11 + [_I, _I, _F, _I, _F, _F, _I, _P],
            "ekf6_backward": [_P] * 11 + [_I, _I, _P]}
EKF3_SIG = {"ekf3_forward": [_P] * 11 + [_I, _I, _F, _I, _F, _F, _I, _P],
            "ekf3_backward": [_P] * 8 + [_I, _I, _P]}
STENCIL_SIG = {"stencil_f32": [_P, _P, _I, _I, _D, _D, _D, _D, _P],
               "stencil_f64": [_P, _P, _I, _I, _D, _D, _D, _D, _P]}
# the C interface of the old sources, by file: commit 4f97d94's, and commit
# 925b1be's
OLD_SIGNATURES = {
    "ekf6": EKF6_SIG,
    "pairwise": {"pairwise_forces": [_P, _P, _P, _I, _I, _F, _F, _F, _F,
                                     _P]}}
BASE_SIGNATURES = {"ekf3": EKF3_SIG, "stencil": STENCIL_SIG}
# commit d671226's roofline.cu
PREV_SIGNATURES = {"roofline": roofline_kernel._SIGNATURES}
# commit fa6b3ff's newcase_ekf.cu: the device-pointer entry
NEWCASE_SIG = {"newcase_ekf_sweep_device":
               deploy_native._CARD_SIGNATURES["newcase_ekf_sweep_device"]}
# probes of where the port's newcase_ekf kernel spends its time, as edits of
# its source (timed beside it, not held to its outputs)
_BWD_BARRIER = "            cp_wait_all();\n            __syncthreads();\n"
_FWD_BARRIER = "        __syncthreads();  // P+[t] and s+[t] are in place\n"
NEWCASE_PROBES = {
    # the smoother's loop removed: the forward, the terminal row, scoring
    "forward only": [("    const int n_iter = T >= 2 ? T + 4 : 0;\n",
                      "    const int n_iter = 0;\n")],
    # the smoother's one barrier a step taken twice
    "smoother barrier twice": [(_BWD_BARRIER, _BWD_BARRIER
                                + "            __syncthreads();\n")],
    # the forward's second barrier a step taken twice
    "forward barrier twice": [(_FWD_BARRIER, 2 * _FWD_BARRIER)],
    # scoring without J1 (thread 0) or without J0 (the monitor thread)
    "scoring without J1": [
        ("        if (g == 0)\n"
         "            a.J1[lane] = weighted_sum(U, T * P, p.w, P) / "
         "(double)(T * P);\n        else if (g == MON)\n",
         "        if (g == MON)\n")],
    "scoring without J0": [
        ("        else if (g == MON)\n"
         "            a.J0[lane] = horizon_j0(U, a, p);\n", "")],
}
# the clocks probe: clock64() read by thread 0 (row 0) and the monitor
# thread of lane 0 of block 0 at each barrier, each span added to its slot:
# (0) the forward's first phase, (1) the wait at its second barrier, (2)
# the input terms, (3) the wait at the third barrier, (4) the products and
# the next prior, (5) the wait at the step's first barrier (the forward's
# last included); (6) a smoother iteration's work, (7) its barrier; (8) the
# scoring. The values are the port's; only the counters are added.
_CLK_TOP = ("        // step t's inputs, the rows of P-[t], R and x_pred are in "
            "place\n        cp_wait_all();\n        __syncthreads();\n")
NEWCASE_CLOCKS = [
    ("__device__ int block_sm[MAX_SM_RECORD];\n",
     "__device__ int block_sm[MAX_SM_RECORD];\n"
     "__device__ long long probe_clk[2][10];\n"),
    ("    const bool adaptive = (a.beta_ekf != 1.0);\n",
     "    const bool adaptive = (a.beta_ekf != 1.0);\n"
     "    const bool clk_on = blockIdx.x == 0 && l == 0 && (g == 0 || g == MON);\n"
     "    long long clk_t = clock64();\n"
     "    auto clk = [&](int slot) {\n"
     "        if (!clk_on) return;\n"
     "        const long long now = clock64();\n"
     "        probe_clk[g == MON][slot] += now - clk_t;\n"
     "        clk_t = now;\n"
     "    };\n"),
    (_CLK_TOP, "        clk(4);\n" + _CLK_TOP + "        clk(5);\n"),
    (_FWD_BARRIER, "        clk(0);\n" + _FWD_BARRIER + "        clk(1);\n"),
    ("        __syncthreads();  // the input terms are in place\n",
     "        clk(2);\n        __syncthreads();  // the input terms are in "
     "place\n        clk(3);\n"),
    ("    __syncthreads();  // the forward's scratch and shared memory are "
     "done\n",
     "    clk(4);\n    __syncthreads();  // the forward's scratch and shared "
     "memory are done\n    clk(5);\n"),
    (_BWD_BARRIER, "            clk(6);\n" + _BWD_BARRIER
     + "            clk(7);\n"),
    ("    __syncthreads();  // U_OPT_SMOOTH is in place\n",
     "    clk(6);\n    __syncthreads();  // U_OPT_SMOOTH is in place\n"
     "    clk(7);\n"),
    ("    }\n}\n\nint launch(const SweepArgs& a",
     "    }\n    clk(8);\n}\n\nint launch(const SweepArgs& a"),
    ("const char* newcase_ekf_error_string(int code) {",
     "int newcase_ekf_probe_clocks(long long* out, int reset) {\n"
     "    if (reset) {\n"
     "        static const long long zero[2][10] = {};\n"
     "        return (int)cudaMemcpyToSymbol(probe_clk, zero, sizeof(zero));\n"
     "    }\n"
     "    return (int)cudaMemcpyFromSymbol(out, probe_clk, sizeof(probe_clk));\n"
     "}\n\n"
     "const char* newcase_ekf_error_string(int code) {"),
]
CLOCK_SLOTS = ("first phase", "second barrier", "input terms", "third barrier",
               "products and prior", "first barrier", "smoother work",
               "smoother barrier", "scoring")
# newcase_ekf designs tried and not kept, in scripts/variants/: held bit for
# bit against the port's kernel and timed beside it
NEWCASE_VARIANT_FILES = {"a barrier each pivot round": "newcase_ekf_rounds.cu"}
COPY_SIG = {"roofline_copy": roofline_kernel._SIGNATURES["roofline_copy"]}
ROOFLINE_SIZES = (1 << 26, 1 << 28, 1 << 30)
ROOFLINE_BATCH = 5
ROOFLINE_ROUNDS = 10
# the port's copy ring with other constants, as edits of its roofline.cu
_BLOCKS = ("constexpr int BLOCKS_PER_SM = 1;", "constexpr int BLOCKS_PER_SM = 2;")
_CHUNK16 = ("constexpr int CHUNK = 32768;", "constexpr int CHUNK = 16384;")
# other designs of the copy, in scripts/variants/
ROOFLINE_VARIANT_FILES = {"tma claimed chunks": "roofline_tma_claim.cu",
                          "stream": "roofline_stream.cu"}
_STAGES = "constexpr int STAGES = 6;"
_POLICY = ("      uint64_t policy;\n"
           "      asm volatile(\"createpolicy.fractional.L2::evict_first.b64 "
           "%0, 1.0;\\n\" : \"=l\"(policy));\n")
ROOFLINE_VARIANTS = {
    "tma 2 blocks an SM, 3 x 32 KiB": [
        _BLOCKS, (_STAGES, "constexpr int STAGES = 3;")],
    "tma 1 block an SM, 12 x 16 KiB": [
        _CHUNK16, (_STAGES, "constexpr int STAGES = 12;")],
    "tma 2 blocks an SM, 6 x 16 KiB": [_BLOCKS, _CHUNK16],
    "tma 1 block an SM, 4 x 32 KiB": [(_STAGES, "constexpr int STAGES = 4;")],
    "tma 1 block an SM, 3 x 64 KiB": [
        ("constexpr int CHUNK = 32768;", "constexpr int CHUNK = 65536;"),
        (_STAGES, "constexpr int STAGES = 3;")],
    "tma 4 blocks an SM, 3 x 16 KiB": [
        ("constexpr int BLOCKS_PER_SM = 1;", "constexpr int BLOCKS_PER_SM = 4;"),
        _CHUNK16, (_STAGES, "constexpr int STAGES = 3;")],
    # loads and stores marked L2 evict-first (the data is touched once)
    "tma evict-first": [
        ('  asm volatile(\n'
         '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::'
         'bytes "\n'
         '      "[%0], [%1], %2, [%3];\\n"\n'
         '      :: "r"(stage), "l"(src), "r"(bytes), "r"(bar) : "memory");\n',
         _POLICY[2:].replace("\n      ", "\n    ")
         + '  asm volatile(\n'
         '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::'
         'bytes.L2::cache_hint "\n'
         '      "[%0], [%1], %2, [%3], %4;\\n"\n'
         '      :: "r"(stage), "l"(src), "r"(bytes), "r"(bar), "l"(policy)\n'
         '      : "memory");\n'),
        ('      asm volatile("cp.async.bulk.global.shared::cta.bulk_group "\n'
         '                   "[%0], [%1], %2;\\n"\n'
         '                   :: "l"(out + off), "r"(ring0 + s * CHUNK), '
         '"r"(nb)\n',
         _POLICY
         + '      asm volatile("cp.async.bulk.global.shared::cta.bulk_group'
         '.L2::cache_hint "\n'
         '                   "[%0], [%1], %2, %3;\\n"\n'
         '                   :: "l"(out + off), "r"(ring0 + s * CHUNK), '
         '"r"(nb), "l"(policy)\n')],
    # each block walks a contiguous run of chunks, not b, b + blocks, ...
    "tma contiguous chunks a block": [
        ("  // this block's chunks k = 0 .. count - 1 (gridDim.x <= chunks)\n"
         "  const long long count = (chunks - blockIdx.x + gridDim.x - 1) / "
         "gridDim.x;\n",
         "  const long long per = (chunks + gridDim.x - 1) / gridDim.x;\n"
         "  const long long first = blockIdx.x * per;\n"
         "  const long long count = chunks - first < per ? chunks - first : "
         "per;\n"),
        ("    return (blockIdx.x + k * gridDim.x) * (long long)CHUNK;\n",
         "    return (first + k) * (long long)CHUNK;\n")],
    # the ring's bulk loads, but each thread stores its x + 1 from registers
    # (STG.128, streaming): no bulk store, no fence, no wait before a refill
    "tma loads, register stores": [
        ("      v[i] = t;\n",
         "      __stcs(reinterpret_cast<float4*>(out + off) + i, t);\n"),
        ('      asm volatile("cp.async.bulk.global.shared::cta.bulk_group "\n'
         '                   "[%0], [%1], %2;\\n"\n'
         '                   :: "l"(out + off), "r"(ring0 + s * CHUNK), '
         '"r"(nb)\n'
         '                   : "memory");\n'
         '      asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");\n',
         ""),
        ('        asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: '
         '"memory");\n', "")],
}
ORDER = ("old", "new", "new", "old")
STENCIL_REPS = 20
# stencil.cu designs tried and not kept, as edits of the port's source: each
# (old, new) pair must occur once in it
_ROW_WINDOW = ("      T dl = buf0[off_d - 1], d = buf0[off_d], dr = "
               "buf0[off_d + 1];\n")
_SRC_STORE = ("              buf0[off_m + to_nxt] = add_rn(v, *sp);\n"
              "              sp += Ly;\n")
STENCIL_VARIANTS = {
    # the row loop unrolled two rows deep, not four
    "unroll2": [("#pragma unroll 4\n", "#pragma unroll 2\n")],
    # unrolled two deep, and the next step's dense source loaded two rows
    # ahead of its use
    "src_ahead": [
        ("#pragma unroll 4\n", "#pragma unroll 2\n"),
        (_ROW_WINDOW, _ROW_WINDOW
         + "      T src0 = T(0), src1 = T(0);\n"
           "      if constexpr (SRC) {\n"
           "        if (!last) {\n"
           "          src0 = sp[0];\n"
           "          if (r0 + 1 < r1) src1 = sp[Ly];\n"
           "        }\n"
           "      }\n"),
        (_SRC_STORE,
         "              const T src2 = r + 2 < r1 ? sp[2 * Ly] : T(0);\n"
         "              buf0[off_m + to_nxt] = add_rn(v, src0);\n"
         "              src0 = src1;\n"
         "              src1 = src2;\n"
         "              sp += Ly;\n")],
}


def n_params(source: str, fn: str) -> int:
    """The parameter count of ``int fn(...)`` as declared in ``source``."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)", source)
    if not m:
        raise SystemExit(f"{fn} is not declared in the old sources")
    return m.group(1).count(",") + 1


def check_old_interface(csrc: Path, signatures: dict, commit: str) -> None:
    """Stop unless every function this script calls in the old sources has
    the parameter count it passes (the old sources must be ``commit``'s)."""
    for name, sig in signatures.items():
        text = (csrc / f"{name}.cu").read_text()
        for fn, argtypes in sig.items():
            if n_params(text, fn) != len(argtypes):
                raise SystemExit(
                    f"{csrc / name}.cu: {fn} takes {n_params(text, fn)} "
                    f"parameters, this script passes {len(argtypes)}; it "
                    f"compares against commit {commit}'s sources only")


def build_old(csrc: Path, signatures: dict, commit: str):
    """nvcc the old sources named in ``signatures``; returns {name: ctypes
    lib}."""
    check_old_interface(csrc, signatures, commit)
    OUT.mkdir(parents=True, exist_ok=True)

    def one(name):
        so = OUT / f"old_{commit}_{name}.so"
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                               str(so), str(csrc / f"{name}.cu")],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on old {name}.cu:\n"
                               f"{proc.stderr}")
        for line in proc.stderr.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas old {commit} {name}: {line.strip()}",
                      flush=True)
        return so

    with ThreadPoolExecutor(len(signatures)) as pool:
        paths = dict(zip(signatures, pool.map(one, signatures)))
    libs = {}
    for name, sig in signatures.items():
        lib = ctypes.CDLL(str(paths[name]))
        for fn, argtypes in sig.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def turns(runs: dict, reps: int) -> dict:
    """Each of runs["old"], runs["new"] timed in the turns ORDER; returns
    {version: [ms, ms]}."""
    times = {v: [] for v in runs}
    for v in ORDER:
        times[v].append(cs.cuda_ms(runs[v], reps=reps))
    return times


def pipeline_cases(device, names):
    """chip_smoke.py's kernel cases of the kernels ``names``."""
    bt, bf, actual, _ = cs.xprize_inputs(cs.R_REGIONS, cs.T_HIST, cs.HORIZON,
                                         seed=0)
    cfg = cs.PipelineConfig(backend="pallas", smoother_gain="solve",
                            pareto_chunk=cs.CHUNK,
                            num_monte_carlo=cs.N_MC)
    for name, tag, args, _, _ in cs.kernel_cases(bt, bf, actual, cfg,
                                                 device):
        if name in names:
            yield name, tag, args


def old_ekf_launchers(name, lib, args, device):
    """(forward, backward, S_SMOOTH) for an old ekf3 / ekf6 library on
    ``args`` (NEWCASES, fixed R, gamma 0.995, as the pipeline runs them)."""
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


def ekf6_ab(libs, device):
    """ekf6: the old forward and backward against the new ones."""
    new_lib = build.load("ekf6", ekf6_kernel._SIGNATURES)
    out = {}
    for name, tag, args in pipeline_cases(device, ("ekf6",)):
        runs = {v: old_ekf_launchers(name, libs[name] if v == "old"
                                     else new_lib, args, device)
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


def ekf3_ab(libs, device):
    """ekf3: the old forward and backward launches against the one fused
    launch, on the pipeline's two inputs."""
    new_lib = build.load("ekf3", ekf3_kernel._SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    p = lambda t: t.data_ptr()
    out = {}
    for _, tag, args in pipeline_cases(device, ("ekf3",)):
        u, x, Rv, scal, vecs, s_init, Ps_init, s_final, _ = args
        T, _, B = u.shape
        fwd, bwd, old_sm = old_ekf_launchers("ekf3", libs["ekf3"], args,
                                             device)
        e = lambda: torch.empty((T, 3, B), dtype=F32, device=device)
        S_MINUS, S_PLUS, new_sm = e(), e(), e()
        g = ekf3_kernel.ekf3_geometry(T, B)
        hist = (torch.empty((T, ekf3_kernel.REC, B), dtype=F32,
                            device=device) if g.hist_floats else None)

        def new():
            code = new_lib.ekf3_smoother(
                p(u), p(x), p(Rv), p(scal), p(vecs), p(s_init), p(Ps_init),
                p(s_final), p(S_MINUS), p(S_PLUS), p(new_sm),
                None if hist is None else p(hist), T, B, 0.995, 0, 1.0, 0.0,
                21, stream)
            assert code == 0, f"ekf3_smoother: CUDA error {code}"

        def old():
            fwd()
            bwd()

        times = turns({"old": old, "new": new}, reps=10)
        torch.cuda.synchronize()
        m = {v: float(np.mean(ts)) for v, ts in times.items()}
        err = cs.scaled_err(new_sm, old_sm)
        ns = {v: m[v] * 1e6 / (T * B) for v in m}
        out[f"ekf3 {tag}"] = dict(old_ms=m["old"], new_ms=m["new"],
                                  runs=times, T=T, B=B,
                                  ns_per_lane_step=ns, lanes_a_block=g.lanes,
                                  s_smooth_old_vs_new=err)
        print(f"ekf3 [{tag}] T={T} B={B}: old {m['old']:.4f} ms (two "
              f"launches), new {m['new']:.4f} ms (one; {g.lanes} lanes a "
              f"block); ns per lane-step old {ns['old']:.2f} new "
              f"{ns['new']:.2f}; runs {times}; S_SMOOTH old vs new "
              f"{err:.3e}", flush=True)
    return out


def stencil_ab(libs, device):
    """The stencil: single steps and the 2048 x 2048 rollout, old kernel
    (one launch a step) against the new one."""
    new_lib = build.load("stencil", stencil_kernel._SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    old_lib = libs["stencil"]
    ax = cs.STENCIL_D * cs.STENCIL_DT / cs.STENCIL_DX ** 2
    ay = cs.STENCIL_D * cs.STENCIL_DT / cs.STENCIL_DY ** 2
    axy8 = cs.STENCIL_D * cs.STENCIL_DT / (cs.STENCIL_DX ** 2
                                           + cs.STENCIL_DY ** 2)
    launched = ctypes.c_int(0)

    def new_call(C, dst, scratch, n, w, keep):
        weights = (ctypes.c_double * (3 * n))(*(w * n))
        code = new_lib.stencil_rollout_f32(
            C.data_ptr(), dst.data_ptr(),
            None if scratch is None else scratch.data_ptr(), None, None,
            None, 0, 0, C.shape[0], C.shape[1], n, weights, keep,
            ctypes.byref(launched), stream)
        assert code == 0, f"stencil_rollout_f32: CUDA error {code}"

    def old_call(C, dst, w):
        c0 = 1.0 - 2.0 * w[0] - 2.0 * w[1] - 4.0 * w[2]
        code = old_lib.stencil_f32(C.data_ptr(), dst.data_ptr(), C.shape[0],
                                   C.shape[1], c0, *w, stream)
        assert code == 0, f"old stencil_f32: CUDA error {code}"

    out = {}
    gen = torch.Generator(device).manual_seed(5)
    for shape in cs.STENCIL_TIMED:
        C = torch.rand(shape, generator=gen, device=device)
        dst = torch.empty_like(C)
        for eight in (False, True):
            w = (ax, ay, axy8 if eight else 0.0)

            def old():
                for _ in range(STENCIL_REPS):
                    old_call(C, dst, w)

            def new():
                for _ in range(STENCIL_REPS):
                    new_call(C, dst, None, 1, w, 0)

            times = turns({"old": old, "new": new}, reps=5)
            m = {v: float(np.mean(ts)) / STENCIL_REPS for v, ts in
                 times.items()}
            key = f"{shape[0]}x{shape[1]} {8 if eight else 4}-neighbour"
            out[key] = dict(old_ms=m["old"], new_ms=m["new"], runs=times)
            print(f"stencil [{key}] one step: old {m['old']:.4f} ms, new "
                  f"{m['new']:.4f} ms ({STENCIL_REPS} launches back to back, "
                  f"runs {times})", flush=True)
    L, n = cs.ROLLOUT_L, cs.ROLLOUT_STEPS
    traj = torch.zeros((n + 1, L, L), device=device)
    traj[0, L // 2, L // 2] = 1.0
    last, scratch = torch.empty((L, L), device=device), torch.empty(
        (L, L), device=device)
    w = (0.1 * 0.01 / 0.1 ** 2, 0.1 * 0.01 / 0.1 ** 2,
         0.1 * 0.01 / (2 * 0.1 ** 2))

    def old_roll():
        for t in range(n):
            old_call(traj[t], traj[t + 1], w)

    runs = {"old": old_roll,
            "new": lambda: new_call(traj[0], traj[1], None, n, w, 1),
            "new, last field only": lambda: new_call(traj[0], last, scratch,
                                                     n, w, 0)}
    times = {v: [] for v in runs}
    for v in ("old", "new", "new, last field only", "new, last field only",
              "new", "old"):
        times[v].append(cs.cuda_ms(runs[v], reps=5))
    ref = traj.clone()
    old_roll()
    torch.cuda.synchronize()
    m = {v: float(np.mean(ts)) for v, ts in times.items()}
    err = float((traj - ref).abs().max())
    out[f"rollout {L}x{L} x {n}"] = dict(ms=m, runs=times,
                                         new_launches=launched.value,
                                         max_abs_old_vs_new=err)
    print(f"stencil rollout {L}x{L} x {n} steps, 8-neighbour, every frame: "
          f"old {m['old']:.4f} ms ({n} launches), new {m['new']:.4f} ms; "
          f"new keeping the last field only {m['new, last field only']:.4f} "
          f"ms ({launched.value} launches); runs {times}; max |old - new| "
          f"{err:.3e}", flush=True)
    return out


def build_variant(variant: Path, signatures: dict,
                  flags: tuple = build.NVCC_FLAGS):
    """nvcc a variant of a port kernel's source (it may include the port's
    headers) with ``flags`` and bind the functions of ``signatures``, which
    must have the port's parameter counts; prints its ptxas lines."""
    text = variant.read_text()
    for fn, sig in signatures.items():
        if n_params(text, fn) != len(sig):
            raise SystemExit(f"{variant}: {fn} takes another parameter list "
                             "than the port's")
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"variant_{variant.stem}.so"
    proc = subprocess.run([build.nvcc_path(), *flags, "-I",
                           str(build.CSRC), "-o", str(so), str(variant)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {variant}:\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {variant.name}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(so))
    for fn, sig in signatures.items():
        getattr(lib, fn).argtypes = sig
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def ekf3_variant_ab(variant: Path, device):
    """An ekf3.cu variant ("old") against the port's ekf3 ("new") on the
    pipeline's two inputs and at B = 1,000 (records in the scratch): the
    outputs compared, then times in turns."""
    libs = {"old": build_variant(variant, ekf3_kernel._SIGNATURES),
            "new": build.load("ekf3", ekf3_kernel._SIGNATURES)}
    stream = torch.cuda.current_stream(device).cuda_stream
    p = lambda t: None if t is None else t.data_ptr()
    cases = [(tag, args) for _, tag, args in pipeline_cases(device,
                                                            ("ekf3",))]
    u, x, Rv, scal, vecs, s_init, Ps_init, s_final, Ps_final = cases[-1][1]
    wide = lambda a: a.repeat(*(1,) * (a.dim() - 1), 5)[..., :1000] \
        .contiguous()
    cases.append(("actual scenario, B = 1,000", tuple(
        wide(a) for a in (u, x, Rv, scal, vecs, s_init, Ps_init, s_final,
                          Ps_final))))
    out = {}
    for tag, args in cases:
        u, x, Rv, scal, vecs, s_init, Ps_init, s_final, _ = args
        T, _, B = u.shape
        g = ekf3_kernel.ekf3_geometry(T, B)
        hist = (torch.empty((T, ekf3_kernel.REC, B), dtype=F32,
                            device=device) if g.hist_floats else None)
        res = {v: [torch.empty((T, 3, B), dtype=F32, device=device)
                   for _ in range(3)] for v in libs}

        def run(v):
            sm, sp, ss = res[v]
            code = libs[v].ekf3_smoother(
                p(u), p(x), p(Rv), p(scal), p(vecs), p(s_init), p(Ps_init),
                p(s_final), p(sm), p(sp), p(ss), p(hist), T, B, 0.995, 0,
                1.0, 0.0, 21, stream)
            assert code == 0, f"ekf3_smoother: CUDA error {code}"

        times = turns({v: (lambda v=v: run(v)) for v in libs}, reps=10)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(res["old"],
                                                      res["new"]))
        err = cs.scaled_err(res["old"][2], res["new"][2])
        m = {v: float(np.mean(ts)) for v, ts in times.items()}
        out[tag] = dict(variant_ms=m["old"], port_ms=m["new"], runs=times,
                        T=T, B=B, lanes_a_block=g.lanes,
                        equal_bit_for_bit=equal, s_smooth_err=err)
        print(f"ekf3 variant {variant.name} [{tag}] T={T} B={B}: variant "
              f"{m['old']:.4f} ms, port {m['new']:.4f} ms (runs {times}); "
              f"equal bit for bit {equal}, S_SMOOTH scaled error {err:.3e}",
              flush=True)
    return out


def stencil_variant_source(name: str) -> Path:
    """The port's stencil.cu with STENCIL_VARIANTS[name]'s edits, written
    under build/."""
    text = (build.CSRC / "stencil.cu").read_text()
    for old, new in STENCIL_VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"stencil variant {name}: {old!r} does not occur "
                             "once in the port's stencil.cu")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"stencil_{name}.cu"
    path.write_text(text)
    return path


def stencil_variant_ab(name: str, device):
    """A stencil.cu variant ("old") against the port's stencil ("new"):
    equal results, then times in turns."""
    variant = stencil_variant_source(name)
    libs = {"old": build_variant(
        variant, {"stencil_rollout_f32":
                  stencil_kernel._SIGNATURES["stencil_rollout_f32"]}),
            "new": build.load("stencil", stencil_kernel._SIGNATURES)}
    stream = torch.cuda.current_stream(device).cuda_stream
    launched = ctypes.c_int(0)

    def call(lib, C, dst, n, w, keep, src=None, cells=None, amts=None,
             scratch=None):
        p = lambda t: None if t is None else t.data_ptr()
        ws = (ctypes.c_double * (3 * n))(*(w * n))
        code = lib.stencil_rollout_f32(
            C.data_ptr(), dst.data_ptr(), p(scratch), p(src), p(cells),
            p(amts), 0 if cells is None else cells.shape[1],
            0 if cells is None else cells.shape[0], C.shape[0], C.shape[1],
            n, ws, keep, ctypes.byref(launched), stream)
        assert code == 0, f"stencil_rollout_f32: CUDA error {code}"

    L, n = cs.ROLLOUT_L, cs.ROLLOUT_STEPS
    w8, w4 = (0.1, 0.1, 0.05), (0.1, 0.1, 0.0)
    traj = torch.zeros((n + 1, L, L), device=device)
    traj[0, L // 2, L // 2] = 1.0
    src = torch.zeros((n, L, L), device=device)
    src[:, L // 3, L // 4] = 1e-3
    last, scratch = (torch.empty((L, L), device=device) for _ in range(2))
    gen = torch.Generator(device).manual_seed(2)
    W = cs.WALK_L
    field = torch.rand((W, W), generator=gen, device=device)
    cells = torch.randint(0, W * W, (cs.WALK_STEPS, cs.WALKERS),
                          generator=gen, device=device, dtype=torch.int32)
    amts = torch.ones((cs.WALK_STEPS, cs.WALKERS), device=device)
    walk_out, walk_scratch = torch.empty_like(field), torch.empty_like(field)
    big = torch.rand((8191, 8193), generator=gen, device=device)
    big_out = torch.empty_like(big)
    cases = {
        "rollout 2048 every frame": lambda lib: call(lib, traj[0], traj[1],
                                                     n, w8, 1),
        "rollout 2048 last field": lambda lib: call(lib, traj[0], last, n,
                                                    w8, 0, scratch=scratch),
        "rollout 2048 last field, 4-neighbour": lambda lib: call(
            lib, traj[0], last, n, w4, 0, scratch=scratch),
        "rollout 2048 every frame, dense sources": lambda lib: call(
            lib, traj[0], traj[1], n, w8, 1, src),
        "walkers 1024 x 500": lambda lib: call(
            lib, field, walk_out, cs.WALK_STEPS, w4, 0, None, cells, amts,
            walk_scratch),
        "single step 8191x8193 (20 back to back)": lambda lib: [
            call(lib, big, big_out, 1, w8, 0) for _ in range(20)],
    }
    out = {}
    for case, run in cases.items():
        results = []
        for v in ("old", "new"):
            run(libs[v])
            results.append((traj.clone() if "frame" in case else
                            walk_out.clone() if "walkers" in case else
                            big_out.clone() if "single" in case
                            else last.clone()))
        torch.cuda.synchronize()
        if not torch.equal(*results):
            raise SystemExit(f"{variant}: {case} differs from the port's")
        times = turns({v: (lambda v=v: run(libs[v])) for v in libs}, reps=5)
        m = {v: float(np.mean(ts)) for v, ts in times.items()}
        out[case] = dict(variant_ms=m["old"], port_ms=m["new"], runs=times)
        print(f"stencil variant {variant.name} [{case}]: variant "
              f"{m['old']:.4f} ms, port {m['new']:.4f} ms (runs {times}); "
              "equal bit for bit", flush=True)
    return out


def edited_source(name: str, tag: str, edits) -> Path:
    """The port's csrc/<name>.cu with ``edits`` ((old, new) pairs, each old
    occurring once), written under build/ with ``tag`` in its name."""
    text = (build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}.cu: {old!r} does not occur once")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    slug = re.sub(r"[^0-9a-z]+", "_", tag.lower()).strip("_")
    path = OUT / f"{name}_{slug}.cu"
    path.write_text(text)
    return path


def roofline_ab(prev_csrc: Path, device):
    """The copy (x + 1): commit d671226's design, the port's TMA ring and
    its ROOFLINE_VARIANTS, the streaming variant and torch.add, each held
    bit for bit against x + 1 and timed in turns at ROOFLINE_SIZES."""
    libs = {"old (d671226)": build_old(prev_csrc, PREV_SIGNATURES,
                                       "d671226")["roofline"],
            "tma (port)": build.load("roofline", roofline_kernel._SIGNATURES)}
    sources = {name: edited_source("roofline", name, edits)
               for name, edits in ROOFLINE_VARIANTS.items()}
    for name, file in ROOFLINE_VARIANT_FILES.items():
        sources[name] = Path(__file__).resolve().parent / "variants" / file
    with ThreadPoolExecutor(len(sources)) as pool:
        libs.update(zip(sources, pool.map(
            lambda src: build_variant(src, COPY_SIG), sources.values())))
    geo = {}
    for name, lib in libs.items():
        lib.roofline_error_string.argtypes = [ctypes.c_int]
        lib.roofline_error_string.restype = ctypes.c_char_p
        if hasattr(lib, "roofline_copy_geometry"):
            fn = lib.roofline_copy_geometry
            fn.argtypes, fn.restype = [ctypes.c_longlong, _P], ctypes.c_int
            out = (ctypes.c_int * 4)()
            assert fn(1 << 28, ctypes.addressof(out)) == 0
            geo[name] = dict(zip(("blocks", "stages", "chunk_bytes",
                                  "smem_bytes"), out))
            print(f"roofline {name}: geometry at 2**28 {geo[name]}",
                  flush=True)
    res = {"geometry_at_2_28": geo}
    for n in ROOFLINE_SIZES:
        x = torch.rand(n, device=device)
        ref = x + 1
        outs = {v: torch.full_like(x, float("nan")) for v in libs}
        outs["x + 1"] = torch.full_like(x, float("nan"))
        runs = {v: (lambda v=v: cs.copy_into(libs[v], x, outs[v]))
                for v in libs}
        runs["x + 1"] = lambda: torch.add(x, 1.0, out=outs["x + 1"])

        def hold():
            """Each version once more into its NaN-filled output."""
            for v, run in runs.items():
                outs[v].fill_(float("nan"))
                run()
            torch.cuda.synchronize()
            return {v: torch.equal(o, ref) for v, o in outs.items()}

        equal = hold()
        batched = {v: (lambda run=run: [run() for _ in range(ROOFLINE_BATCH)])
                   for v, run in runs.items()}
        times = cs.turns_ms(batched, ROOFLINE_ROUNDS)
        # again after the timed calls: a launch that left work undone would
        # show here
        equal = {v: e and a for (v, e), a in zip(equal.items(),
                                                 hold().values())}
        del ref
        ms = {v: float(np.median(ts)) / ROOFLINE_BATCH
              for v, ts in times.items()}
        bound_ms = cs.bound(8 * n, n)[0]
        res[f"n=2**{n.bit_length() - 1}"] = {
            v: dict(ms=ms[v], tb_s=8 * n / (ms[v] * 1e-3) / 1e12,
                    bound_share=bound_ms / ms[v], equal_bit_for_bit=equal[v],
                    runs_ms=[t / ROOFLINE_BATCH for t in times[v]])
            for v in runs}
        for v in runs:
            print(f"roofline copy n=2**{n.bit_length() - 1} [{v}]: "
                  f"{ms[v]:.4f} ms a call, {8 * n / (ms[v] * 1e-3) / 1e12:.4f}"
                  f" TB/s, {bound_ms / ms[v]:.3f} of the {bound_ms:.4f} ms "
                  f"bound; / x + 1 {ms[v] / ms['x + 1']:.4f}; equal bit for "
                  f"bit {equal[v]}", flush=True)
        del x, outs, runs, batched
        if not all(equal.values()):
            raise SystemExit(f"roofline copy n={n}: a version differs from "
                             f"x + 1 {equal}")
    return res


def newcase_ab(prev_csrc: Path, device):
    """The deployment artefact's sweep kernel: commit fa6b3ff's design (one
    thread a lane) against the port's (a team of threads a lane) on
    chip_smoke.deploy_case(), bit for bit against each other and the CPU
    build, timed in turns."""
    check_old_interface(prev_csrc, {"newcase_ekf": NEWCASE_SIG}, "fa6b3ff")
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "old_fa6b3ff_newcase_ekf.so"
    proc = subprocess.run([build.nvcc_path(), *build.flags("newcase_ekf"),
                           "-o", str(so), str(prev_csrc / "newcase_ekf.cu")],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on old newcase_ekf.cu:\n"
                           f"{proc.stderr}")
    _, new_report = build.build("newcase_ekf")
    ptxas = {}
    for v, report in (("old", proc.stderr), ("new", new_report)):
        ptxas[v] = {w: cs.ptxas_usage(report, "newcase_ekf_kernel", w)
                    for w in ("registers", "stack frame")}
        print(f"  ptxas {v} newcase_ekf_kernel: {ptxas[v]['registers']}; "
              f"{ptxas[v]['stack frame']}", flush=True)
    libs = {"old": ctypes.CDLL(str(so)), "new": deploy_native._card_lib()}
    fn = "newcase_ekf_sweep_device"
    getattr(libs["old"], fn).argtypes = NEWCASE_SIG[fn]
    getattr(libs["old"], fn).restype = ctypes.c_int
    probe_sources = {name: edited_source("newcase_ekf", name, edits)
                     for name, edits in NEWCASE_PROBES.items()}
    for name, file in NEWCASE_VARIANT_FILES.items():
        probe_sources[name] = Path(__file__).resolve().parent / "variants" / file
    with ThreadPoolExecutor(len(probe_sources)) as pool:
        probes = dict(zip(probe_sources, pool.map(
            lambda src: build_variant(src, NEWCASE_SIG,
                                      build.flags("newcase_ekf")),
            probe_sources.values())))

    case = cs.deploy_case()
    d = deploy_native.native_inputs(*(case[k] for k in (
        "u", "x", "params", "s_init", "Ps_init", "s_final", "Ps_final", "Q",
        "R_v")))
    dc = deploy_native.to_device(d, device)
    eps = torch.from_numpy(case["eps_values"]).to(device)
    sia = torch.from_numpy(case["sia_hist"]).to(device)
    T, P, E = d["T"], d["P"], eps.numel()
    stream = torch.cuda.current_stream(device).cuda_stream
    p = lambda t: t.data_ptr()
    nan = lambda *shape: torch.full(shape, float("nan"), dtype=torch.float64,
                                    device=device)
    def launcher(lib, beta_ekf=case["beta_ekf"], score=True):
        out = dict(U_OPT_SMOOTH=nan(E, T, P), J0=nan(E), J1=nan(E))
        scratch = nan(T * deploy_native.SCRATCH_PER_LANE_STEP * E)
        costs = (p(out["J0"]), p(out["J1"])) if score else (None, None)

        def run():
            code = lib.newcase_ekf_sweep_device(
                *deploy_native._head(dc, case["T_hist"], eps, E, beta_ekf,
                                     0.995, 21),
                p(sia), p(scratch), p(out["U_OPT_SMOOTH"]), *costs, None,
                None, stream)
            assert code == 0, f"newcase_ekf_sweep_device: CUDA error {code}"

        run()
        return out, run

    outs, runs = {}, {}
    for v, lib in libs.items():
        outs[v], runs[v] = launcher(lib)
    torch.cuda.synchronize()
    sms = deploy_native.block_sms(E)   # the new design's last launch
    cpu = deploy_native.newcase_ekf_pareto_sweep_native(**case, device="cpu")
    got = {v: {k: o.cpu().numpy() for k, o in out.items()}
           for v, out in outs.items()}
    same = {"old vs new": all(np.array_equal(got["old"][k], got["new"][k])
                              for k in cpu),
            "new vs CPU build": all(np.array_equal(got["new"][k], cpu[k])
                                    for k in cpu)}
    times = turns(runs, reps=5)
    m = {v: float(np.mean(ts)) for v, ts in times.items()}
    # the probes, each in turns with the port's kernel (port, probe, probe,
    # port): the edits above, no scoring (J0, J1 null) and beta_ekf = 1 (no
    # monitor; other prescriptions, the same work otherwise)
    probe_runs, probe_outs = {}, {}
    for name, lib in probes.items():
        probe_outs[name], probe_runs[name] = launcher(lib)
    # the clocks probe: one launch, its counters read back
    clocks_src = edited_source("newcase_ekf", "clocks", NEWCASE_CLOCKS)
    clk_lib = build_variant(clocks_src, {
        **NEWCASE_SIG, "newcase_ekf_probe_clocks": [ctypes.c_void_p, _I]},
        build.flags("newcase_ekf"))
    clk_out, clk_run = launcher(clk_lib)
    counts = np.zeros((2, 10), dtype=np.int64)
    torch.cuda.synchronize()
    assert clk_lib.newcase_ekf_probe_clocks(counts.ctypes.data, 1) == 0
    clk_run()
    torch.cuda.synchronize()
    assert clk_lib.newcase_ekf_probe_clocks(counts.ctypes.data, 0) == 0
    clocks = {who: {slot: int(c) for slot, c in zip(CLOCK_SLOTS, row)}
              for who, row in zip(("row 0", "monitor"), counts)}
    clocks["bit_for_bit"] = all(np.array_equal(o.cpu().numpy(), got["new"][k])
                                for k, o in clk_out.items())
    print(f"newcase_ekf clocks (cycles, lane 0 of block 0, one launch at "
          f"T={T}): {clocks}", flush=True)
    probe_runs["no scoring"] = launcher(libs["new"], score=False)[1]
    probe_runs["beta_ekf 1"] = launcher(libs["new"], beta_ekf=1.0)[1]
    torch.cuda.synchronize()
    probe_ms = {}
    for name, run in probe_runs.items():
        t = turns({"old": runs["new"], "new": run}, reps=5)
        probe_ms[name] = dict(port_ms=float(np.mean(t["old"])),
                              probe_ms=float(np.mean(t["new"])), runs=t)
        if name in NEWCASE_VARIANT_FILES:
            probe_ms[name]["bit_for_bit"] = all(
                np.array_equal(o.cpu().numpy(), got["new"][k])
                for k, o in probe_outs[name].items())
        print(f"newcase_ekf {'variant' if name in NEWCASE_VARIANT_FILES else 'probe'}"
              f" [{name}]: {probe_ms[name]['probe_ms']:.4f} ms beside the "
              f"port's {probe_ms[name]['port_ms']:.4f}"
              + (f"; bit for bit {probe_ms[name]['bit_for_bit']}"
                 if name in NEWCASE_VARIANT_FILES else ""), flush=True)
    b_ms, b_by, _ = cs.newcase_bound(case)
    res = dict(old_ms=m["old"], new_ms=m["new"], runs=times,
               probes=probe_ms, clocks=clocks,
               speedup=m["old"] / m["new"], bound_ms=b_ms, bound_by=b_by,
               new_over_bound=m["new"] / b_ms, bit_for_bit=same,
               ptxas=ptxas, blocks=len(sms),
               sms_used=len(set(sms.tolist())),
               shape=f"E={E} T={T} P={P} float64 beta_ekf="
                     f"{case['beta_ekf']}")
    print(f"newcase_ekf E={E} T={T} P={P}: old {m['old']:.4f} ms, new "
          f"{m['new']:.4f} ms ({res['speedup']:.2f}x; {res['new_over_bound']:.1f}x "
          f"its {b_ms:.4f} ms bound, {b_by}); runs {times}; bit for bit "
          f"{same}; new blocks {res['blocks']} on {res['sms_used']} SMs",
          flush=True)
    if not all(same.values()):
        raise SystemExit(f"newcase_ekf: the designs differ ({same})")
    return res


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
        times = turns({"old": old, "new": new}, reps=10)
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
    ap.add_argument("--old-csrc", type=Path,
                    help="commit 4f97d94's epidemicmodeling_torch/csrc")
    ap.add_argument("--base-csrc", type=Path,
                    help="commit 925b1be's epidemicmodeling_torch/csrc")
    ap.add_argument("--stencil-variant", choices=sorted(STENCIL_VARIANTS),
                    action="append", default=[], help="a stencil.cu variant "
                    "to time against the port's (repeatable)")
    ap.add_argument("--ekf3-variant", type=Path, action="append",
                    default=[], help="an ekf3.cu variant to time against "
                    "the port's (repeatable)")
    ap.add_argument("--roofline-csrc", type=Path,
                    help="commit d671226's epidemicmodeling_torch/csrc")
    ap.add_argument("--newcase-csrc", type=Path,
                    help="commit fa6b3ff's epidemicmodeling_torch/csrc")
    args = ap.parse_args()
    if (args.old_csrc is None and args.base_csrc is None
            and not args.stencil_variant and not args.ekf3_variant
            and args.roofline_csrc is None and args.newcase_csrc is None):
        ap.error("give --old-csrc, --base-csrc, --stencil-variant, "
                 "--ekf3-variant, --roofline-csrc or --newcase-csrc")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this timing needs one card")
    device = torch.device("cuda", 0)
    old = (build_old(args.old_csrc, OLD_SIGNATURES, "4f97d94")
           if args.old_csrc else None)
    base = (build_old(args.base_csrc, BASE_SIGNATURES, "925b1be")
            if args.base_csrc else None)
    cs.build_all()
    res = {}
    if base is not None:
        res["ekf3"] = ekf3_ab(base, device)
        res["stencil"] = stencil_ab(base, device)
    for variant in args.ekf3_variant:
        res[f"ekf3 variant {variant.name}"] = ekf3_variant_ab(variant, device)
    for name in args.stencil_variant:
        res[f"stencil variant {name}"] = stencil_variant_ab(name, device)
    if args.roofline_csrc is not None:
        res["roofline copy"] = roofline_ab(args.roofline_csrc, device)
    if args.newcase_csrc is not None:
        res["newcase_ekf"] = newcase_ab(args.newcase_csrc, device)
    if old is not None:
        res["ekf6"] = ekf6_ab(old, device)
        res["pairwise"] = pairwise_ab(old, device)
        res["old_ekf6_bwd_sass"] = dead_cov_check(args.old_csrc)
    print(json.dumps(res))
    print(cs.card_line())


if __name__ == "__main__":
    main()
