"""The rollout kernel's source (csrc/rollout.cu) runs on the CPU.

The source is compiled by g++ against tests/test_torch_ekf_emulated.py's
header that emulates the CUDA runtime (a launch runs the blocks one after
another, each block's threads as std::threads). Both instances, float and
double, are called through their C entries with the wrapper's own argument
list (ops/cuda/rollout_kernel.entry_args) on CPU tensors and held against
the plain version (rollout_kernel.rollout_plain) in the same dtype: the
kernel's lane and stride arithmetic, its noise and NaN semantics and its
outputs, on a machine without a card. tests/test_torch_cuda.py holds the
same on the card.

Bounds, on |kernel - plain| / (1 + |plain|) over every output: the two
differ only in the order of the sum over the 12 NPIs (sequential in the
kernel, torch.sum's vectorised order in the plain version), a rounding of
the drive term a step that the next steps carry along. Double: 1e-13, a
few hundred ulps; float: 1e-5, ~100 ulps of float32 (eps 6e-8).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import pytest
import torch

from epidemicmodeling_torch.ops.cuda import build, rollout_kernel
from epidemicmodeling_torch.ops.cuda.rollout_kernel import (entry_args,
                                                            rollout_plain)
from tests._torch_helpers import npi_levels, rollout_params
from tests.test_torch_ekf_emulated import _EMULATION, _LAUNCH

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not available")

TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
P = 12


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The source compiled once by g++ on the emulation header, both
    instances' entries declared as the wrapper declares them."""
    d = tmp_path_factory.mktemp("emulated_rollout")
    (d / "cuda_runtime.h").write_text(_EMULATION)
    src = (build.CSRC / build.SOURCES["rollout"][0]).read_text()

    def launch(m):
        grid = [a.strip() for a in m[2].split(",")]
        return (f"emu_launch((unsigned)({grid[0]}), (unsigned)({grid[1]}), "
                f"[&] {{ {m[1]}({m[3]}); }});")
    src, n = _LAUNCH.subn(launch, src)
    assert n == 1 and "<<<" not in src
    (d / "rollout.cpp").write_text(src)
    so = d / "librollout.so"
    subprocess.run(["g++", "-O1", "-std=c++20", "-shared", "-fPIC",
                    "-pthread", "-I", str(d), str(d / "rollout.cpp"), "-o",
                    str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in rollout_kernel._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _case(name, dtype):
    """(s0, params, u, noise, out) of one case; out's tensors are
    allocated twice by the caller (one set a side)."""
    g = torch.Generator().manual_seed(7)
    if name == "scenarios":           # (G, R, H, P) schedules, the fields
        G, R, H = 3, 7, 30
        s0, p = rollout_params(R, dtype, 1)
        return s0, p, npi_levels(g, (G, R, H, P), dtype), None, (G, R, H)
    if name == "noise":               # one draw shared by the G schedules
        G, R, H = 3, 7, 30
        s0, p = rollout_params(R, dtype, 2)
        noise = torch.randn((R, H, 3), generator=g, dtype=torch.float64)
        return (s0, p, npi_levels(g, (G, R, H, P), dtype),
                noise.to(dtype).expand(G, R, H, 3), (G, R, H))
    if name == "monte_carlo":         # schedules at stride 0 over regions
        G, R, H = 37, 7, 25           # 259 lanes: 3 blocks, the last ragged
        s0, p = rollout_params(R, dtype, 3)
        noise = torch.randn((G, R, H, 3), generator=g, dtype=torch.float64)
        return (s0, p, npi_levels(g, (G, H, P), dtype)[:, None].expand(
            G, R, H, P), noise.to(dtype), None)
    if name == "sweep":               # batch-last (H, P, G * R) prescription
        G, R, H = 5, 29, 20           # 145 lanes: 2 blocks, the last ragged
        s0, p = rollout_params(R, dtype, 4)
        u_bl = npi_levels(g, (H, G * R, P), dtype).permute(0, 2, 1)
        u = u_bl.contiguous().reshape(H, P, G, R).permute(2, 3, 0, 1)
        return s0, p, u, None, "sweep"
    if name == "nan_and_clips":       # NaN in u; states driven to 0 and 1
        G, R, H = 2, 6, 12
        s0, p = rollout_params(R, dtype, 5)
        s0[0] = torch.tensor([0.9, 0.9, 1.5])     # s falls below 0
        s0[1] = torch.tensor([1.0, 0.95, 3.0])    # i rises above 1
        p["beta"][1] = 0.01
        u = npi_levels(g, (G, R, H, P), dtype)
        u[0, 2, 3, 5] = float("nan")              # alpha -> alpha_max
        u[1, 3, :, :] = float("nan")
        return s0, p, u, None, (G, R, H)
    assert name == "empty_horizon"
    s0, p = rollout_params(4, dtype, 6)
    return s0, p, torch.zeros((2, 4, 0, P), dtype=dtype), None, (2, 4, 0)


def _outs(spec, u):
    """Fresh output tensors of a case: three (G, R, H) fields, or for the
    sweep the horizon slices of (G, R, T_full) buffers (T_hist = 9)."""
    if spec is None:
        return None
    if spec == "sweep":
        G, R, H, _ = u.shape
        return tuple(torch.full((G, R, 9 + H), -7.0, dtype=u.dtype)[..., 9:]
                     for _ in range(3))
    return tuple(torch.full(spec, -7.0, dtype=u.dtype) for _ in range(3))


def _err(got, want):
    return float(((got - want).abs() / (1 + want.abs())).max()) \
        if got.numel() else 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["scenarios", "noise", "monte_carlo",
                                  "sweep", "nan_and_clips", "empty_horizon"])
def test_rollout_source_matches_plain(emulated, case, dtype):
    """Either instance of csrc/rollout.cu against rollout_plain in the same
    dtype: the horizon sums and every trajectory field, on every lane."""
    s0, p, u, noise, spec = _case(case, dtype)
    out_k, out_p = _outs(spec, u), _outs(spec, u)
    G, R = u.shape[:2]
    cases = torch.full((G, R), -7.0, dtype=dtype)
    entry = getattr(emulated, f"rollout_{rollout_kernel._SUFFIX[dtype]}")
    assert entry(*entry_args(s0, p, u, noise, out_k, cases), None) == 0
    want = rollout_plain(s0, p, u, noise, out_p)
    assert want.dtype == dtype and want.shape == (G, R)
    assert bool(torch.isfinite(cases).all())
    assert _err(cases, want) < TOL[dtype]
    for got, ref in zip(out_k or (), out_p or ()):
        assert bool(torch.isfinite(got).all())
        assert _err(got, ref) < TOL[dtype]
    if spec == "sweep":   # the history part of the buffers is not written
        assert bool((out_k[0]._base[..., :9] == -7.0).all())
    if case == "nan_and_clips":
        s, i, al = out_k
        amax = p["alpha_max"][0]
        assert bool((al[0, 2, 3] == amax) & (al[1, 3] == amax).all())
        assert float(s[:, 0].min()) == 0.0 and float(i[:, 1].max()) == 1.0
        assert bool(((s >= 0) & (s <= 1) & (i >= 0) & (i <= 1)).all())
    if case == "empty_horizon":
        assert bool((cases == 0).all())


def test_rollout_routes_cpu_tensors_to_the_plain_version():
    """rollout() on CPU tensors is rollout_plain, and the launch counter
    does not move; the kernel's route refuses CPU tensors and other
    dtypes."""
    s0, p, u, noise, _ = _case("noise", torch.float64)
    before = rollout_kernel.launches
    got = rollout_kernel.rollout(s0, p, u, noise)
    assert torch.equal(got, rollout_plain(s0, p, u, noise))
    assert rollout_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        rollout_kernel.rollout_cuda(s0, p, u, noise)
    half = {k: v.half() for k, v in p.items()}
    with pytest.raises(ValueError, match="float32 or float64"):
        rollout_kernel.rollout_cuda(s0.half(), half, u.half(), noise.half())
    with pytest.raises(ValueError, match="shape"):
        rollout_kernel.rollout(s0[:3], p, u, noise)
    five = dict(p, a=p["a"][:, :5], u_max=p["u_max"][:, :5])
    with pytest.raises(ValueError, match="P = 12"):
        rollout_kernel.rollout_cuda(s0, five, u[..., :5], noise)


@pytest.mark.parametrize("P", [5, 16])
def test_rollout_source_refuses_other_npi_counts(emulated, P):
    """The kernel takes the OxCGRT's 12 NPIs (NPI, as ekf3 and ekf6): its
    entry refuses another count without a launch, while the plain version
    rolls any count out."""
    s0, p, u, _, spec = _case("scenarios", torch.float64)
    idx = torch.arange(P) % 12
    p = dict(p, a=p["a"][:, idx], u_max=p["u_max"][:, idx])
    u = u[..., idx]
    cases = torch.full(u.shape[:2], -7.0, dtype=torch.float64)
    out = _outs(spec, u)
    assert emulated.rollout_f64(*entry_args(s0, p, u, None, out, cases),
                                None) != 0
    assert bool((cases == -7.0).all() and (out[0] == -7.0).all())
    assert bool(torch.isfinite(rollout_plain(s0, p, u)).all())
