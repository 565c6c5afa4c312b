#!/usr/bin/env python3
"""Probe PyTorch's square root on the CPU (no card needed).

    python scripts/torch_cpu_sqrt_probe.py first-call [--procs 160] [--parallel 8]
    python scripts/torch_cpu_sqrt_probe.py vml-modes

first-call: starts ``--procs`` fresh Python processes, ``--parallel`` at a
time, and in each takes the first square root of the process on a
(150, 1064) tensor, the shape of the force-parity test's pair terms, one
of four ways: PyTorch's root in float32 or float64, or NumPy's (the plain
force law's route on the CPU, ops/cuda/pairwise_kernel.pair_terms). It
prints, for each way, how many processes read a relative error above
1e-6 (float32) or 1e-15 (float64) against NumPy's root, which is the
correctly rounded one.

vml-modes: calls MKL's vmsSqrt, which ATen's CPU float32 sqrt calls on each
thread's share of a contiguous tensor (ATen/cpu/vml.h, mode VML_HA), in its
three accuracy modes (LA, HA, EP) and prints each one's largest relative
error. Run it with MKL_ENABLE_INSTRUCTIONS=AVX2 to read MKL's AVX2 branch.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

SHAPE = (150, 1064)
CHILD = """
import sys, numpy as np, torch
way, dtype = sys.argv[1], getattr(torch, sys.argv[2])
x = (torch.rand({shape}, dtype=torch.float64) * 4000).to(dtype)
# the root under test first: it must be the process's first vector root
got = torch.sqrt(x) if way == "torch" else torch.from_numpy(np.sqrt(x.numpy()))
ref = torch.from_numpy(np.sqrt(x.numpy()))
print(float(((got.double() - ref.double()).abs() / ref.double()).max()))
"""
WAYS = (("torch", "float32", 1e-6), ("numpy", "float32", 1e-6),
        ("torch", "float64", 1e-15), ("numpy", "float64", 1e-15))


def first_call(procs: int, parallel: int) -> None:
    src = CHILD.format(shape=SHAPE)
    for way, dtype, tol in WAYS:
        bad, worst = 0, 0.0
        for start in range(0, procs, parallel):
            batch = [subprocess.Popen([sys.executable, "-c", src, way, dtype],
                                      stdout=subprocess.PIPE, text=True)
                     for _ in range(min(parallel, procs - start))]
            for p in batch:
                err = float(p.communicate()[0])
                bad += err > tol
                worst = max(worst, err)
        print(f"{way} {dtype}: {bad} of {procs} processes read > {tol:g} "
              f"on their first call (largest {worst:.3e}; {parallel} at a "
              f"time, {os.cpu_count()} cores)")


def vml_modes() -> None:
    import numpy as np
    import torch
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    x = (np.random.default_rng(0).random(SHAPE[0] * SHAPE[1])
         * 4000).astype(np.float32)
    ref = np.sqrt(x.astype(np.float64))
    errmode_ignore = 0x100
    for name, mode in (("LA", 0x1), ("HA", 0x2), ("EP", 0x3)):
        out = np.empty_like(x)
        lib.vmsSqrt(ctypes.c_int(x.size),
                    x.ctypes.data_as(ctypes.c_void_p),
                    out.ctypes.data_as(ctypes.c_void_p),
                    ctypes.c_longlong(mode | errmode_ignore))
        err = float(np.max(np.abs(out - ref) / ref))
        print(f"vmsSqrt {name} (MKL_ENABLE_INSTRUCTIONS="
              f"{os.environ.get('MKL_ENABLE_INSTRUCTIONS', 'unset')}): "
              f"{err:.3e}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("first-call", "vml-modes"))
    ap.add_argument("--procs", type=int, default=160)
    ap.add_argument("--parallel", type=int, default=8)
    args = ap.parse_args()
    if args.what == "first-call":
        first_call(args.procs, args.parallel)
    else:
        vml_modes()


if __name__ == "__main__":
    main()
