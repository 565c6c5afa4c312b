"""The port's native deployment artefact (epidemicmodeling_torch/deploy/)
on the CPU, against the JAX package's library and the port's own EKF/EKS.

- The CPU build (deploy/src/newcase_ekf.cpp on csrc/newcase_ekf.cuh, g++
  with the JAX package's flags) equals the JAX package's library
  (epidemicmodeling_tpu/deploy) bit for bit, the single-epsilon entry and
  the sweep alike, on tests/test_deploy.py's inputs (rebuilt with NumPy
  from the same draws, tests._torch_helpers.deploy_inputs).
- It matches the port's new_case_ekf_optimal_npi (the generic core, another
  operation order) at tests/test_deploy.py's bounds.
- The sweep's plain version (deploy/plain.py) gives the same prescriptions
  and J0 / J1 at rtol 1e-9, with control active on about a tenth of the
  prescribed cells.
- The card source (csrc/newcase_ekf.cu) cannot run here. Its logic, lanes-
  last scratch and host-pointer entries are checked by compiling it with
  g++ against a header that emulates the CUDA runtime calls it makes (its
  launch runs each block's threads as std::threads meeting at a real
  barrier, its shared memory one object a block): it equals the CPU build
  bit for bit. The card itself is held against the
  CPU build by tests/test_torch_cuda.py and chip_smoke.py.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from epidemicmodeling_tpu.deploy import (
    newcase_ekf_optimal_npi_native as jax_single,
    newcase_ekf_pareto_sweep_native as jax_sweep)
from epidemicmodeling_torch.deploy import (native,
                                           newcase_ekf_optimal_npi_native,
                                           newcase_ekf_pareto_sweep_native,
                                           pareto_sweep_plain)
from epidemicmodeling_torch.models import SIAlphaParams
from epidemicmodeling_torch.ops.cuda import build
from epidemicmodeling_torch.pipelines.prescribe import \
    new_case_ekf_optimal_npi
from epidemicmodeling_torch.utils.profiling import recording
from tests._torch_helpers import deploy_inputs, deploy_sweep_args
from tests.test_deploy import build_case

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not available")

T_HIST = 90          # deploy_sweep_args's default history length
OUTPUTS = ("S_PLUS", "S_SMOOTH", "U_OPT_SMOOTH")


@pytest.fixture(scope="module", autouse=True)
def jax_library(tmp_path_factory):
    """The JAX package's library, built by its own build_library from its
    own source and flags, but into a private directory: its loader rebuilds
    the copy next to the source in place whenever the source looks newer,
    and this module must not do that while another test process loads it."""
    import epidemicmodeling_tpu.deploy.native as jax_native
    lib = tmp_path_factory.mktemp("jax_native") / "libnewcase_ekf.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", str(lib))
        mp.setattr(jax_native, "_lib_handle", None)
        jax_native.build_library(force=True)
        yield


def _assert_equal(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_inputs_rebuild_the_jax_recipe():
    mine = deploy_inputs(epsilon=0.05)
    theirs = build_case(epsilon=0.05)
    for a, b in zip(mine[:2] + mine[3:], theirs[:2] + theirs[3:]):
        np.testing.assert_array_equal(a, b)
    for k, v in mine[2].items():
        np.testing.assert_array_equal(np.asarray(theirs[2][k]), v,
                                      err_msg=k)


@pytest.mark.parametrize("beta_ekf", [1.0, 0.9])
@pytest.mark.parametrize("epsilon", [0.05, 0.5])
def test_cpu_build_equals_the_jax_library(epsilon, beta_ekf):
    args = deploy_inputs(epsilon=epsilon)
    got = newcase_ekf_optimal_npi_native(*args, beta_ekf=beta_ekf,
                                         device="cpu")
    _assert_equal(got, jax_single(*args, beta_ekf=beta_ekf))


@pytest.mark.parametrize("beta_ekf", [1.0, 0.9])
def test_cpu_sweep_equals_the_jax_library(beta_ekf):
    args = deploy_sweep_args(np.logspace(-8, 0, 24))
    got = newcase_ekf_pareto_sweep_native(*args, beta_ekf=beta_ekf,
                                          n_threads=3, device="cpu")
    _assert_equal(got, jax_sweep(*args, beta_ekf=beta_ekf, n_threads=2))


@pytest.mark.parametrize("beta_ekf", [1.0, 0.9])
@pytest.mark.parametrize("epsilon", [0.05, 0.5])
def test_cpu_build_matches_the_port_ekf(epsilon, beta_ekf):
    """tests/test_deploy.py's bounds against the port's generic core."""
    u, obs, params, s_init, Ps_init, s_final, Ps_final, Q, R_v = \
        deploy_inputs(epsilon=epsilon)
    native_res = newcase_ekf_optimal_npi_native(
        u, obs, params, s_init, Ps_init, s_final, Ps_final, Q, R_v,
        beta_ekf=beta_ekf, device="cpu")
    t = lambda a: torch.from_numpy(np.asarray(a, float))
    res = new_case_ekf_optimal_npi(
        t(u), t(obs), SIAlphaParams(**params, device="cpu"), t(s_init),
        t(Ps_init), t(s_final), t(Ps_final), Q=t(Q), R=t(R_v),
        beta=beta_ekf, gamma=0.995, device="cpu")
    np.testing.assert_allclose(native_res["S_PLUS"], res.s_plus.numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(native_res["S_SMOOTH"], res.s_smooth.numpy(),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(native_res["U_OPT_SMOOTH"],
                               res.u_opt_smooth.numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("beta_ekf", [1.0, 0.9])
def test_plain_sweep_matches_the_cpu_build(beta_ekf):
    args = deploy_sweep_args(np.logspace(-8, -2, 32))
    ref = newcase_ekf_pareto_sweep_native(*args, beta_ekf=beta_ekf,
                                          device="cpu")
    got = pareto_sweep_plain(*args, beta_ekf=beta_ekf, device="cpu")
    fut = ref["U_OPT_SMOOTH"][:, T_HIST:-1]
    share = (fut == args[3]["u_max"]).mean()
    assert 0.05 < share < 0.5      # control is active on some cells
    np.testing.assert_array_equal(got["U_OPT_SMOOTH"].numpy(),
                                  ref["U_OPT_SMOOTH"])
    for k in ("J0", "J1"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-9,
                                   atol=0, err_msg=k)


def test_sweep_does_not_depend_on_threads_and_equals_single_calls():
    eps = np.logspace(-8, -2, 12)
    args = deploy_sweep_args(eps, seed=1)
    runs = [newcase_ekf_pareto_sweep_native(*args, beta_ekf=0.9,
                                            n_threads=n, device="cpu")
            for n in (1, 4, 0)]
    for r in runs[1:]:
        _assert_equal(r, runs[0])
    u, obs, _, params, _, s_init, Ps_init, s_final, Ps_final, Q, R_v, _ = \
        args
    for ll, e in enumerate(eps):
        one = newcase_ekf_optimal_npi_native(
            u, obs, dict(params, epsilon=e), s_init, Ps_init, s_final,
            Ps_final, Q, R_v, beta_ekf=0.9, device="cpu")
        np.testing.assert_array_equal(runs[0]["U_OPT_SMOOTH"][ll],
                                      one["U_OPT_SMOOTH"])


def _bad_single(kind):
    u, obs, params, *rest = deploy_inputs()
    if kind == "x length":
        obs = obs[:-1]
    elif kind == "NPI dim":
        u = np.zeros((u.shape[0], 65))
        params = dict(params, **{k: np.zeros(65) for k in
                                 ("a", "u_min", "u_max", "w")})
    elif kind == "params length":
        params = dict(params, a=params["a"][:-1])
    return (u, obs, params, *rest)


@pytest.mark.parametrize("kind", ["x length", "NPI dim", "params length"])
def test_single_entry_checks_raise_as_the_jax_ones(kind):
    args = _bad_single(kind)
    with pytest.raises(ValueError) as theirs:
        jax_single(*args)
    with pytest.raises(ValueError) as mine:
        newcase_ekf_optimal_npi_native(*args, device="cpu")
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("T_hist", [0, 121])
def test_sweep_refuses_a_history_outside_the_window(T_hist):
    """The C sweep returns 1 unless 1 <= T_hist <= T; both wrappers raise."""
    args = list(deploy_sweep_args(np.array([0.1, 0.2])))
    args[2], args[11] = T_hist, np.zeros((T_hist, 3))
    with pytest.raises(RuntimeError, match="code 1"):
        jax_sweep(*args)
    with pytest.raises(RuntimeError, match="code 1"):
        newcase_ekf_pareto_sweep_native(*args, device="cpu")


def test_port_only_checks():
    """Inputs the JAX library would read or write out of bounds: a monitor
    of no days, and the sweep's NPI dim and x length (the JAX sweep wrapper
    checks neither)."""
    args = deploy_sweep_args(np.array([0.1]))
    with pytest.raises(ValueError, match="inv_monitor_len"):
        newcase_ekf_pareto_sweep_native(*args, inv_monitor_len=0,
                                        device="cpu")
    with pytest.raises(ValueError, match="inv_monitor_len"):
        newcase_ekf_optimal_npi_native(*deploy_inputs(), inv_monitor_len=0,
                                       device="cpu")
    bad = list(args)
    bad[1] = bad[1][:-1]
    with pytest.raises(ValueError, match="x length"):
        newcase_ekf_pareto_sweep_native(*bad, device="cpu")
    bad = list(args)
    bad[0] = np.zeros((120, 65))
    with pytest.raises(ValueError, match="NPI dim"):
        newcase_ekf_pareto_sweep_native(*bad, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        newcase_ekf_optimal_npi_native(*deploy_inputs())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        newcase_ekf_pareto_sweep_native(*deploy_sweep_args(np.array([0.1])))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pareto_sweep_plain(*deploy_sweep_args(np.array([0.1])))


def test_cpu_build_is_keyed_under_the_build_directory():
    path = Path(native.build_library())
    assert path.parent == build.BUILD_DIR
    assert path == native.library_path()
    assert path.name.startswith("libnewcase_ekf_cpu_")


# --- the C interfaces and the kernel's constants, read from the sources ---

CSRC = build.CSRC
JAX_CPP = (Path(__file__).resolve().parents[1] / "epidemicmodeling_tpu"
           / "deploy" / "src" / "newcase_ekf.cpp")


def _c_params(path: Path, fn: str) -> list:
    """The parameter declarations of the C function ``fn`` in ``path``,
    whitespace-normalized."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)", path.read_text())
    assert m, f"{fn} not in {path.name}"
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def _constant(source: str, name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return m.group(1)


def test_c_interfaces_match_the_jax_library_and_the_wrappers():
    cpu, cu = native.SRC, CSRC / "newcase_ekf.cu"
    single = _c_params(JAX_CPP, "newcase_ekf_optimal_npi")
    sweep = _c_params(JAX_CPP, "newcase_ekf_pareto_sweep")
    assert _c_params(cpu, "newcase_ekf_optimal_npi") == single
    assert _c_params(cpu, "newcase_ekf_pareto_sweep") == sweep
    assert _c_params(cu, "newcase_ekf_optimal_npi_cuda") == single
    assert _c_params(cu, "newcase_ekf_pareto_sweep_cuda") == [
        p for p in sweep if p != "int n_threads"]
    device = _c_params(cu, "newcase_ekf_sweep_device")
    assert device[:len(sweep) - 5] == sweep[:-5]      # up to sia_hist
    assert device[-1] == "void* stream"
    # every parameter's ctypes type: int, double, else a pointer
    ctype = {"int": ctypes.c_int, "double": ctypes.c_double}
    for lib, sigs in ((cpu, native._CPU_SIGNATURES),
                      (cu, native._CARD_SIGNATURES)):
        for fn, argtypes in sigs.items():
            params = _c_params(lib, fn)
            assert [ctype.get(p.split()[0], ctypes.c_void_p)
                    for p in params] == argtypes, fn


def test_kernel_constants_match_the_wrapper():
    assert int(_constant("newcase_ekf.cuh", "MAX_NPI")) == native.NPI_MAX
    assert int(_constant("newcase_ekf.cuh", "M")) == native.M
    assert int(_constant("newcase_ekf.cu", "MAX_MONITOR")) == \
        native.MONITOR_MAX
    assert int(_constant("newcase_ekf.cu", "LANES")) == native.LANES
    assert [native.blocks(e) for e in (1, 16, 17, 2000)] == [1, 1, 2, 125]
    expr = _constant("newcase_ekf.cu", "SCRATCH_PER_LANE_STEP")
    assert re.fullmatch(r"[0-9M*+ ]+", expr)
    assert eval(expr, {"M": native.M}) == native.SCRATCH_PER_LANE_STEP
    # the CPU build is compiled with the JAX package's flags, the card
    # build without fused multiply-adds
    jax_native = (JAX_CPP.parents[1] / "native.py").read_text()
    assert all(f'"{f}"' in jax_native for f in native.GXX_FLAGS)
    assert "--fmad=false" in build.flags("newcase_ekf")
    assert build.SOURCES["newcase_ekf"] == ("newcase_ekf.cu",
                                            "newcase_ekf.cuh")


# --- the card source, emulated on the CPU ---

_EMULATION = r"""
#pragma once
#include <barrier>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
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
enum cudaMemcpyKind { cudaMemcpyHostToDevice, cudaMemcpyDeviceToHost };
inline int cudaMalloc(double** p, size_t n) {
    *p = (double*)std::malloc(n); return *p ? 0 : 2; }
inline int cudaFree(void* p) { std::free(p); return 0; }
inline int cudaMemcpy(void* d, const void* s, size_t n, cudaMemcpyKind) {
    std::memcpy(d, s, n); return 0; }
template <class T>
int cudaMemcpyFromSymbol(void* d, const T& symbol, size_t n) {
    std::memcpy(d, &symbol, n); return 0; }
inline int cudaDeviceSynchronize() { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
"""
_LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), 0, (\w+)>>>\((\w+)\);")
# the emulated cases: T days, the prescribed window from EMU_T_HIST
EMU_T, EMU_T_HIST = 60, 45


@pytest.fixture(scope="module")
def emulated_card(tmp_path_factory):
    """csrc/newcase_ekf.cu compiled by g++ on the emulation header: its
    launch runs the blocks one after another, each block's threads as
    std::threads meeting at a real barrier for __syncthreads, its shared
    memory one object, its device memory the host's. Loaded with the card
    library's signatures."""
    d = tmp_path_factory.mktemp("emulated_card")
    (d / "cuda_runtime.h").write_text(_EMULATION)
    src = (CSRC / "newcase_ekf.cu").read_text()
    src = src.replace('#include "newcase_ekf.cuh"',
                      f'#include "{CSRC / "newcase_ekf.cuh"}"')
    src, n = _LAUNCH.subn(
        lambda m: (f"emu_launch((unsigned)({m[2]}), (unsigned)({m[3]}), "
                   f"[&] {{ {m[1]}({m[5]}); }}); (void){m[4]};"), src)
    assert n == 1
    (d / "emu.cpp").write_text(src)
    subprocess.run(["g++", *native.GXX_FLAGS, "-std=c++20", "-I", str(d),
                    str(d / "emu.cpp"), "-o", str(d / "libemu.so")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "libemu.so"))
    for fn, argtypes in native._CARD_SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("beta_ekf", [1.0, 0.9])
@pytest.mark.parametrize("E", [1, 16, 17, 37])
def test_card_source_emulated_equals_the_cpu_build(emulated_card, E,
                                                   beta_ekf):
    """Both host-pointer entries and the device-pointer entry (lanes-last
    scratch) of the card source equal the CPU build bit for bit: one lane,
    a whole block, a ragged block, several blocks."""
    eps = np.logspace(-8, 0, E)
    args = deploy_sweep_args(eps, T_hist=EMU_T_HIST, T=EMU_T)
    ref = newcase_ekf_pareto_sweep_native(*args, beta_ekf=beta_ekf,
                                          device="cpu")
    u, obs, _, params, _, s_init, Ps_init, s_final, Ps_final, Q, R_v, sia = \
        args
    d = native.native_inputs(u, obs, params, s_init, Ps_init, s_final,
                             Ps_final, Q, R_v)
    T, P = d["T"], d["P"]
    out = dict(U_OPT_SMOOTH=np.zeros((E, T, P)), J0=np.zeros(E),
               J1=np.zeros(E))
    assert emulated_card.newcase_ekf_pareto_sweep_cuda(
        *native._head(d, EMU_T_HIST, eps, E, beta_ekf, 0.995, 21),
        native._ptr(sia), *(native._ptr(v) for v in out.values())) == 0
    _assert_equal(out, ref)
    phases = np.full(5, np.nan)
    assert emulated_card.newcase_ekf_host_phases(native._ptr(phases)) == 0
    assert (phases >= 0).all()

    dev = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in d.items()}
    eps_t, sia_t = torch.from_numpy(eps), torch.from_numpy(sia)
    scratch = torch.full((T * native.SCRATCH_PER_LANE_STEP * E,), np.nan,
                         dtype=torch.float64)
    outs = [torch.full(s, np.nan, dtype=torch.float64)
            for s in ((E, T, P), (E,), (E,), (E, T, 6), (E, T, 6))]
    assert emulated_card.newcase_ekf_sweep_device(
        *native._head(dev, EMU_T_HIST, eps_t, E, beta_ekf, 0.995, 21),
        sia_t.data_ptr(), scratch.data_ptr(),
        *(o.data_ptr() for o in outs), None) == 0
    for k, o in zip(("U_OPT_SMOOTH", "J0", "J1"), outs):
        np.testing.assert_array_equal(o.numpy(), ref[k], err_msg=k)
    for ll in sorted({0, E - 1}):
        one = newcase_ekf_optimal_npi_native(
            u, obs, dict(params, epsilon=eps[ll]), s_init, Ps_init, s_final,
            Ps_final, Q, R_v, beta_ekf=beta_ekf, device="cpu")
        np.testing.assert_array_equal(outs[3][ll].numpy(), one["S_PLUS"])
        np.testing.assert_array_equal(outs[4][ll].numpy(), one["S_SMOOTH"])
    sms = np.zeros(native.blocks(E), dtype=np.int32)
    assert emulated_card.newcase_ekf_block_sms(native._ptr(sms),
                                               len(sms)) == 0

    args1 = deploy_inputs(T=EMU_T, T_hist=EMU_T_HIST, epsilon=eps[E // 2])
    ref1 = newcase_ekf_optimal_npi_native(*args1, beta_ekf=beta_ekf,
                                          device="cpu")
    d1 = native.native_inputs(*args1)
    out1 = {k: np.zeros_like(v) for k, v in ref1.items()}
    assert emulated_card.newcase_ekf_optimal_npi_cuda(
        *native._single(d1, beta_ekf, 0.995, 21),
        *(native._ptr(out1[k]) for k in OUTPUTS)) == 0
    _assert_equal(out1, ref1)


def test_card_source_emulated_refuses_what_it_cannot_take(emulated_card):
    args = deploy_sweep_args(np.array([0.1, 0.2]))
    d = native.native_inputs(*(args[i] for i in (0, 1, 3, 5, 6, 7, 8, 9,
                                                  10)))
    out = [np.zeros(s) for s in ((2, 120, 12), (2,), (2,))]
    for T_hist, L in ((0, 21), (121, 21), (T_HIST, 0),
                      (T_HIST, native.MONITOR_MAX + 1)):
        sia = np.zeros((max(T_hist, 1), 3))
        assert emulated_card.newcase_ekf_pareto_sweep_cuda(
            *native._head(d, T_hist, np.array([0.1, 0.2]), 2, 0.9, 0.995, L),
            native._ptr(sia), *(native._ptr(v) for v in out)) == 1


def test_kernel_wrapper_runs_the_plain_version_on_cpu_tensors():
    """newcase_ekf_sweep on CPU tensors is the plain version: no launch,
    the CPU build's prescriptions, the states only when asked for."""
    eps = np.logspace(-8, -2, 6)
    args = deploy_sweep_args(eps)
    d = native.native_inputs(*(args[i] for i in (0, 1, 3, 5, 6, 7, 8, 9,
                                                  10)))
    with recording() as rec:
        got = native.newcase_ekf_sweep(native.to_device(d, "cpu"),
                                       torch.from_numpy(eps), T_HIST,
                                       torch.from_numpy(args[11]), 0.9)
    assert build.launches(rec, "newcase_ekf") == 0
    assert set(got) == {"U_OPT_SMOOTH", "J0", "J1"}
    ref = newcase_ekf_pareto_sweep_native(*args, beta_ekf=0.9, device="cpu")
    np.testing.assert_array_equal(got["U_OPT_SMOOTH"].numpy(),
                                  ref["U_OPT_SMOOTH"])
    states = native.newcase_ekf_sweep(native.to_device(d, "cpu"),
                                      torch.from_numpy(eps), states=True)
    assert set(states) == {"U_OPT_SMOOTH", "S_PLUS", "S_SMOOTH"}
