"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each kernel is compiled at first use by ``nvcc`` into a shared library with
a plain C interface, keyed by a hash of its own sources (``SOURCES``) and
the flags, under ``build/torch_kernels/`` at the root of the checkout, and
loaded with ctypes. A change to a header rebuilds only the kernels that
include it. Nothing here runs at import time, so the CPU tests import every
module of the port on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# sm_90a keeps Hopper-only instructions available; no --use_fast_math: the
# NaN masks and IEEE division/sqrt are the kernels' semantics
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# each kernel's translation unit first, then the headers it includes
SOURCES = {
    "ekf3": ("ekf3.cu", "ekf_common.cuh"),
    "ekf6": ("ekf6.cu", "ekf_common.cuh"),
    "stencil": ("stencil.cu",),
    "pairwise": ("pairwise.cu",),
    "roofline": ("roofline.cu",),
    "newcase_ekf": ("newcase_ekf.cu", "newcase_ekf.cuh"),
    "nnls": ("nnls.cu",),
    "rollout": ("rollout.cu",),
}
# flags of one kernel beside NVCC_FLAGS (keyed into its hash): the
# deployment artefact's card build must equal its CPU build bit for bit,
# and the rollout's products and sums must round as its plain version's
# separate tensor ops do, so nvcc may not contract a * b + c into a fused
# multiply-add there
EXTRA_FLAGS = {"newcase_ekf": ("--fmad=false",),
               "rollout": ("--fmad=false",)}

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    nvcc on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are compiled on the machine that runs them")
    return found


def flags(name: str) -> tuple:
    """nvcc's flags for the kernel ``name``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def compile_into(so: Path, command: list) -> str:
    """Run the compiler ``command`` with ``-o`` a temporary file beside
    ``so``, then move that into place (atomic: builds running at once agree).
    Returns the compiler's stderr; raises with it when the compiler
    fails."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        proc = subprocess.run([*command, "-o", tmp], capture_output=True,
                              text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(command[0]).name} failed on "
                               f"{Path(command[-1]).name}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stderr


def build(name: str) -> tuple[Path, str]:
    """Compile the kernel ``name`` (csrc/<SOURCES[name][0]>) unless its
    hashed library exists. Returns the library path and the compiler's
    register/spill report (``-Xptxas -v``, kept beside the library). Safe to
    call for several kernels at once from threads: each runs its own nvcc."""
    so = library_path(name)
    if so.exists():
        report = so.with_suffix(".ptxas.txt")
        return so, report.read_text() if report.exists() else ""
    report = compile_into(so, [nvcc_path(), *flags(name),
                               str(CSRC / SOURCES[name][0])])
    so.with_suffix(".ptxas.txt").write_text(report)
    return so, report


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load the kernel ``name``, declaring each C
    entry's argument types: ``signatures`` maps entry name -> argtypes list.
    Every entry returns an int (a cudaError_t)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            so, _ = build(name)
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, entry: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {code} ({msg})")
