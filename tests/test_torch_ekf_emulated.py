"""The EKS kernels' sources (csrc/ekf3.cu, csrc/ekf6.cu) run on the CPU.

Each source is compiled by g++ against a header that emulates the CUDA
runtime calls it makes: a launch runs the blocks one after another, each
block's threads as std::threads meeting at a real barrier for
__syncthreads, its shared memory one static object, its device memory the
host's (cp.async is a plain copy there: the kernels' own fallback where no
card compiles them). Both instances, float and double, are called through
their C entries with the wrappers' signatures on CPU tensors and held
against the plain versions (ops/cuda/ekf3_kernel.ekf3_plain,
ekf6_kernel.ekf6_plain) in the same dtype: the kernels' indexing, rings,
team exchanges and NaN semantics, on a machine without a card. The card
tests (tests/test_torch_cuda.py) hold the same on the card.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from epidemicmodeling_torch.ops.cuda import build, ekf3_kernel, ekf6_kernel
from tests._torch_helpers import make_inputs, masked_err, packed_args, \
    scaled_err

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not available")

_EMULATION = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
using std::isnan;
struct EmuIdx { unsigned x; };
static thread_local EmuIdx blockIdx, threadIdx;
static std::barrier<>* emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// one block at a time, each of its threads a std::thread
template <class F>
void emu_launch(unsigned blocks, unsigned threads, F kernel) {
    for (unsigned b = 0; b < blocks; ++b) {
        std::barrier<> bar(threads);
        emu_barrier = &bar;
        std::vector<std::thread> block;
        for (unsigned t = 0; t < threads; ++t)
            block.emplace_back([&, b, t] {
                blockIdx.x = b;
                threadIdx.x = t;
                kernel();
            });
        for (auto& th : block) th.join();
    }
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
template <class K>
int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
"""
# a kernel launch, its kernel (with template arguments) and its arguments
_LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
# the dynamic shared memory: one static buffer as large as a block may take
_DYNAMIC = re.compile(r"extern __shared__ (float|double) (\w+)\[\];")
_SMEM_BYTES = 232448
# the launch shape of either ekf3 instance, for the geometry test (the
# library exports the float instance's only)
_GEOMETRY = r"""
extern "C" void emulated_geometry(int T, int B, int itemsize, int* lanes,
                                  int* blocks, int* smem_hist,
                                  long long* smem_bytes) {
  const Geometry g = itemsize == 8 ? geometry<double>(T, B)
                                   : geometry<float>(T, B);
  *lanes = g.lanes;
  *blocks = g.blocks;
  *smem_hist = g.smem_hist;
  *smem_bytes = (long long)g.smem_bytes;
}
"""


def _emulated_source(name: str) -> str:
    src = (build.CSRC / build.SOURCES[name][0]).read_text()
    src = src.replace('#include "ekf_common.cuh"',
                      f'#include "{build.CSRC / "ekf_common.cuh"}"')

    def launch(m):
        grid = [a.strip() for a in m[2].split(",")]
        return (f"emu_launch((unsigned)({grid[0]}), (unsigned)({grid[1]}), "
                f"[&] {{ {m[1]}({m[3]}); }});")
    src, n = _LAUNCH.subn(launch, src)
    # every launch rewritten: one the pattern misses fails here, not in g++
    assert n >= 1 and "<<<" not in src, name
    src, n = _DYNAMIC.subn(
        rf"alignas(16) static \1 \2[{_SMEM_BYTES} / sizeof(\1)];", src)
    assert n == 1, name
    return src + (_GEOMETRY if name == "ekf3" else "")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{"ekf3": lib, "ekf6": lib}: each source compiled by g++ on the
    emulation header, its entries declared as the wrappers declare them."""
    d = tmp_path_factory.mktemp("emulated_eks")
    (d / "cuda_runtime.h").write_text(_EMULATION)
    libs = {}
    for name, sigs in (("ekf3", ekf3_kernel._SIGNATURES),
                       ("ekf6", ekf6_kernel._SIGNATURES)):
        (d / f"{name}.cpp").write_text(_emulated_source(name))
        so = d / f"lib{name}.so"
        subprocess.run(["g++", "-O1", "-std=c++20", "-shared", "-fPIC",
                        "-pthread", "-I", str(d), str(d / f"{name}.cpp"),
                        "-o", str(so)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run_ekf3(lib, args, dtype, beta, obs_type):
    """ekf3_kernel.ekf3's call of the emulated entry of ``dtype``."""
    u = args[0]
    T, _, B = u.shape
    outs = [torch.empty((T, 3, B), dtype=dtype) for _ in range(3)]
    g = ekf3_kernel.ekf3_geometry(T, B, u.element_size())
    hist = (torch.empty((T, ekf3_kernel.REC, B), dtype=dtype)
            if g.hist_floats else None)
    entry = ekf3_kernel.card_entry("ekf3_smoother", dtype)
    code = getattr(lib, entry)(
        *(_ptr(a) for a in args[:8]), *(_ptr(o) for o in outs), _ptr(hist),
        T, B, 0.995, int(obs_type == "TOTALCASES"), beta, 1.0 - beta, 21,
        None)
    assert code == 0
    S_MINUS, S_PLUS, S_SMOOTH = outs
    return S_SMOOTH, S_PLUS, S_MINUS, g


def _run_ekf6(lib, args, dtype, beta, obs_type):
    """ekf6_kernel.ekf6's two calls of the emulated entries of ``dtype``."""
    u = args[0]
    T, _, B = u.shape
    e = lambda *shape: torch.empty(shape, dtype=dtype)
    S_MINUS, S_PLUS, S_SMOOTH = e(T, 6, B), e(T, 6, B), e(T, 6, B)
    P_MINUS, P_PLUS, U_SM = e(T, 21, B), e(T, 21, B), e(T, 12, B)
    fwd = getattr(lib, ekf3_kernel.card_entry("ekf6_forward", dtype))
    bwd = getattr(lib, ekf3_kernel.card_entry("ekf6_backward", dtype))
    assert fwd(*(_ptr(a) for a in args[:7]), _ptr(S_MINUS), _ptr(S_PLUS),
               _ptr(P_MINUS), _ptr(P_PLUS), T, B, 0.995,
               int(obs_type == "TOTALCASES"), beta, 1.0 - beta, 21,
               None) == 0
    assert bwd(_ptr(u), _ptr(S_PLUS), _ptr(S_MINUS), _ptr(P_PLUS),
               _ptr(P_MINUS), _ptr(args[3]), _ptr(args[4]), _ptr(args[7]),
               _ptr(args[8]), _ptr(S_SMOOTH), _ptr(U_SM), T, B, None) == 0
    return S_SMOOTH, U_SM, S_PLUS


# the largest scaled gap |a - b| / (|b| + 1) of the kernel against its plain
# version, by instance: float as the card tests hold it (chip_smoke's
# EKF3_BOUNDS, tests/test_torch_cuda.py; these cases read <= 8.1e-7); double
# at 1e-12, where the two differ only in the order of the operations (the
# kernel's 1 / S formed once, its Joseph update times 1 / gd, its row-wise
# team products): these cases read <= 5.8e-16 (ekf3) and <= 1.9e-14 (ekf6's
# smoothed costates), and every prescription equal
EKF3_TOL = {torch.float32: dict(s_plus=1e-4, s_smooth=1e-3),
            torch.float64: dict(s_plus=1e-12, s_smooth=1e-12)}
EKF6_TOL = {torch.float32: dict(s_plus=1e-3, s_smooth=1e-2, u_diff=5e-3),
            torch.float64: dict(s_plus=1e-12, s_smooth=1e-12, u_diff=0.0)}
DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
@pytest.mark.parametrize("B,T", [(9, 30), (40, 17), (3, 4000)])
def test_ekf3_source_matches_plain(emulated, B, T, obs_type, beta, dtype):
    """Both instances of csrc/ekf3.cu, the step records in shared memory
    and (T = 4000) in the device-memory scratch, against ekf3_plain."""
    args = packed_args(3, make_inputs(3, B=B, T=T, T_hist=T - T // 4,
                                      seed=B + T, obs_type=obs_type,
                                      dtype=DTYPES[dtype]), "cpu")
    ssm, sp, sm, g = _run_ekf3(emulated["ekf3"], args, dtype, beta,
                               obs_type)
    assert g.smem_hist == (T < 4000)
    r_ssm, r_sp, r_sm = ekf3_kernel.ekf3_plain(
        *args, gamma_discount=0.995, obs_type=obs_type, beta=beta,
        inv_monitor_len=21)
    assert all(o.dtype == dtype for o in (ssm, sp, sm, r_ssm))
    assert all(bool(torch.isfinite(o).all()) for o in (ssm, sp, sm))
    tol = EKF3_TOL[dtype]
    assert scaled_err(sp, r_sp) < tol["s_plus"]
    assert scaled_err(sm, r_sm) < tol["s_plus"]
    assert scaled_err(ssm, r_ssm) < tol["s_smooth"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
def test_ekf6_source_matches_plain(emulated, obs_type, beta, dtype):
    """Both instances of csrc/ekf6.cu (a block and a ragged quarter block
    of lanes) against ekf6_plain: the filtered and smoothed states where
    both are finite, no cell finite in one only, the prescriptions, and
    U_OPT_SMOOTH's zero last row."""
    T, T_hist = 40, 28
    args = packed_args(6, make_inputs(6, B=40, T=T, T_hist=T_hist, seed=4,
                                      obs_type=obs_type,
                                      dtype=DTYPES[dtype]), "cpu")
    ssm, usm, sp = _run_ekf6(emulated["ekf6"], args, dtype, beta, obs_type)
    r_ssm, r_usm, r_sp = ekf6_kernel.ekf6_plain(
        *args, gamma_discount=0.995, obs_type=obs_type, beta=beta,
        inv_monitor_len=21)
    assert all(o.dtype == dtype for o in (ssm, usm, sp, r_ssm))
    tol = EKF6_TOL[dtype]
    for got, ref, name in ((sp, r_sp, "s_plus"), (ssm, r_ssm, "s_smooth")):
        err, mismatch = masked_err(got, ref)
        assert err < tol[name] and mismatch == 0.0, name
    diff = (usm[T_hist:-1] != r_usm[T_hist:-1]).double().mean()
    assert float(diff) <= tol["u_diff"]
    assert bool((usm[-1] == 0).all())


def test_ekf3_emulated_geometry_matches_the_wrapper(emulated):
    """ekf3_geometry (the wrapper's restatement) against the source's own,
    in both instances, in every branch."""
    fn = emulated["ekf3"].emulated_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = None
    for itemsize in (4, 8):
        for T in (1, 8, 380, 440, 532, 3000, 4000):
            for B in (1, 235, 1000, 14100):
                out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
                       ctypes.c_longlong()]
                fn(T, B, itemsize, *(ctypes.byref(o) for o in out))
                g = ekf3_kernel.ekf3_geometry(T, B, itemsize)
                assert (out[0].value, out[1].value, bool(out[2].value),
                        out[3].value) == (g.lanes, g.blocks, g.smem_hist,
                                          g.smem_bytes), (itemsize, T, B)
