"""Build the CUDA kernels in ``csrc/`` at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds). The library goes to ``_build/<hash>/`` inside the package, keyed
by a hash of the sources and flags, so a checkout builds everything it
needs from its own sources and an edit builds anew. The flags keep IEEE
division and sqrt and no multiply-add contraction: never
``--use_fast_math`` (see ``csrc/trace_surface.cu``); the FP32-chain probe
(``csrc/probes.cu``) fuses with ``__fmaf_rn`` where it means to, and the
pass's accumulate kernel (``csrc/accumulate.cu``) only adds.
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
    c_int, c_int, c_void_p,  # ... want_aovs, bvh0, bvh_tests
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
    # flags, volumes, want_aovs, table_floats, out [3] int32 (host)
    "bendy_item_occupancy": ([c_int, c_int, c_int, c_int, c_void_p], c_int),
    # samp, cnt, n, spp, n_out, first, max_iters, out, rays, iters, vevents,
    #   near_steps, over_cap, stream
    "bendy_fold_samples": (
        [c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_void_p, c_void_p, c_void_p,
         c_void_p, c_void_p, c_void_p, c_void_p],
        c_int,
    ),
    # csrc/accumulate.cu: out, n_out, lanes, row0, step, rays, pixels, nn, film, add,
    #   ray_total, stream
    "bendy_accumulate": (
        [c_void_p, c_int, c_int, c_int, c_int, c_void_p, c_int, c_int, c_void_p, c_int,
         c_void_p, c_void_p],
        c_int),
    "bendy_cuda_error_string": ([c_int], ctypes.c_char_p),
    # csrc/probes.cu: x, out, n, iters, fma, stream
    "bendy_fp32_chain": ([c_void_p, c_void_p, c_int, c_int, c_int, c_void_p], c_int),
    # tab (f32), onehot (bf16), partial, n, iters, bn, ks, stream
    "bendy_bf16_dot_chain": (
        [c_void_p, c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_void_p], c_int),
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
    """Compile the kernels if this source hash has no library yet: one
    ``nvcc -c`` per source, all started together, then one link.

    Returns (library path, seconds spent compiling; 0.0 when it was built
    before). Raises if nvcc fails, with its output.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))  # private to this build
    try:
        nvcc = find_nvcc()
        objs = [str(tmp_dir / f"{src.stem}.o") for src in sources()]
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[nvcc, *flags, "-c", "-o", o, str(src)] for o, src in zip(objs, sources())]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        runs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
        if not any(rc for _, _, rc in runs):
            link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_dir / LIB_NAME), *objs]
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            runs.append((link, proc.stdout, proc.returncode))
        (out_dir / "build.log").write_text("".join(" ".join(c) + "\n" + o for c, o, _ in runs))
        failed = [f"{' '.join(c)} ({rc}):\n{o}" for c, o, rc in runs if rc]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp_dir / LIB_NAME, lib)  # atomic: a concurrent build never sees half a file
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
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
