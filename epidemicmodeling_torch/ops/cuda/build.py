"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each kernel is compiled at first use by ``nvcc`` into a shared library with
a plain C interface, keyed by a hash of its own sources (``SOURCES``) and
the flags, under ``build/torch_kernels/`` at the root of the checkout, and
loaded with ctypes. A change to a header rebuilds only the kernels that
include it. Nothing here runs at import time, so the CPU tests import every
module of the port on a machine with no CUDA toolkit.

It is also every kernel wrapper's launch seam: ``instance`` maps a dtype
to the C entry of its instance, ``check_args`` holds a launch's tensors to
the rules every kernel shares (a wrapper keeps only its kernel's own
limits), and ``launch`` calls an entry on the device's current stream and
counts it as ``<kernel>.launches`` in the recording in force
(utils/profiling.py), the one launch counter.
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

import torch

from ...utils.profiling import count

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

# the dtypes the kernels' instances take, in the order of INSTANCES' pairs
DTYPES = (torch.float32, torch.float64)
# the C entries of each kernel that has a float and a double instance: the
# entry that float32 and float64 pick (the EKS kernels' float entries are
# older than their double twins and kept their names)
INSTANCES = {
    "ekf3_smoother": ("ekf3_smoother", "ekf3_smoother_f64"),
    "ekf6_forward": ("ekf6_forward", "ekf6_forward_f64"),
    "ekf6_backward": ("ekf6_backward", "ekf6_backward_f64"),
    "nnls_intercept": ("nnls_intercept_f32", "nnls_intercept_f64"),
    "nnls_masked_solve": ("nnls_masked_solve_f32", "nnls_masked_solve_f64"),
    "rollout": ("rollout_f32", "rollout_f64"),
    "stencil_rollout": ("stencil_rollout_f32", "stencil_rollout_f64"),
}
# the recording's counter of each kernel's launches
LAUNCHES = {name: f"{name}.launches" for name in SOURCES}

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


def instance(entry: str, dtype) -> str:
    """The C entry of ``entry``'s instance for ``dtype`` (INSTANCES): the
    float one for float32, the double one for float64. Raises on any other
    dtype: a kernel runs the caller's precision or none."""
    if dtype not in DTYPES:
        raise ValueError(f"{entry} takes float32 or float64 (got {dtype})")
    return INSTANCES[entry][DTYPES.index(dtype)]


def check_args(named: dict, dtypes=DTYPES, shapes=None, contiguous=True,
               device=None) -> torch.device:
    """Hold the tensors ``named`` (name -> tensor) to a kernel's rules, in
    order: each a tensor of one dtype among ``dtypes``, the same for all;
    a CUDA tensor on one device (``device`` where given); contiguous where
    ``contiguous``; of the shape ``shapes[name]`` where ``shapes`` has it.
    Raises ValueError naming the first tensor at fault; returns the
    device."""
    takes = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
    dtype = None
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a CUDA tensor (got "
                             f"{type(t).__name__})")
        if t.dtype not in dtypes or t.dtype != (dtype or t.dtype):
            raise ValueError(f"{name} is {t.dtype}: the kernel takes "
                             f"{takes}, one dtype for every input")
        if t.device.type != "cuda" or t.device != (device or t.device):
            raise ValueError(f"{name} must be a CUDA tensor (got "
                             f"{t.device}): the kernel takes CUDA tensors on "
                             "one device")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shapes and name in shapes and t.shape != tuple(shapes[name]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shapes[name])}")
        dtype, device = t.dtype, t.device
    return device


def launch(kernel: str, signatures: dict, entry: str, device, *args,
           n=1) -> None:
    """Call the C entry ``entry`` of the kernel ``kernel`` (loaded with
    ``signatures``, built at first use) on ``device``, with ``args`` and
    the device's current stream last; raise if it returned a CUDA error;
    count ``n`` launches of the kernel (LAUNCHES[kernel]) in the recording
    in force. ``n`` may be a ctypes int that the entry writes the number of
    its launches into."""
    lib = load(kernel, signatures)
    with torch.cuda.device(device):
        code = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, kernel, entry, code)
    count(LAUNCHES[kernel], n if isinstance(n, int) else n.value)


def launches(rec, kernel: str) -> int:
    """The launches of ``kernel`` counted in the recording ``rec``."""
    return rec.counters.get(LAUNCHES[kernel], 0)
