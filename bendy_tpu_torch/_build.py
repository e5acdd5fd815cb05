"""Build the CUDA kernels in ``csrc/`` at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds). The library goes to ``_build/<hash>/`` inside the package, keyed
by a hash of the sources and flags, so a checkout builds everything it
needs from its own sources and an edit builds anew. The flags keep IEEE
division and sqrt and no multiply-add contraction: never
``--use_fast_math`` (see ``csrc/trace_surface.cu``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false",  # round as the plain version does (csrc/trace_surface.cu)
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in build.log
]
LIB_NAME = "libbendy_kernels.so"

c_void_p, c_int, c_uint, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float

# every C entry point with its ctypes signature: without argtypes ctypes
# passes a Python int as a 32-bit int and cuts the pointer
_TRACE_ARGS = [
    c_void_p, c_int, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,
    c_int, c_int, c_int, c_int, c_int, c_uint, c_uint, c_uint, c_uint,
    c_int, c_int, c_float, c_float, c_int, c_int, c_int, c_int, c_int, c_int,
    c_int,
]
SIGNATURES = {
    "bendy_trace_surface": (_TRACE_ARGS + [c_void_p], c_int),
    # + n_mass, eta, min_step, max_step, far, max_steps, growth, near_steps
    "bendy_trace_geodesic": (
        _TRACE_ARGS + [c_int, c_float, c_float, c_float, c_float, c_int, c_float,
                       c_void_p, c_void_p],
        c_int,
    ),
    # + the geodesic arguments, grid, G, D, H, W, volume_step,
    #   max_volume_bounces, nearest, vevents
    "bendy_trace_volume": (
        _TRACE_ARGS + [c_int, c_float, c_float, c_float, c_float, c_int, c_float,
                       c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_float, c_int,
                       c_int, c_void_p, c_void_p],
        c_int,
    ),
    "bendy_cuda_error_string": ([c_int], ctypes.c_char_p),
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): cannot build "
                           "the bendy_tpu_torch CUDA kernels")
    return nvcc


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, seconds spent compiling; 0.0 when it was built
    before). Raises if nvcc fails, with its output.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so", delete=False) as tmp:
        tmp_path = Path(tmp.name)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp_path), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp_path, lib)  # atomic: a concurrent build never sees half a file
    return lib, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_log() -> str:
    """nvcc's output of the current build (ptxas register/spill report)."""
    return (BUILD_ROOT / source_hash() / "build.log").read_text()
