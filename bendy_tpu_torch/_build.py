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

The tracer's threads per block are a build parameter
(``-DBENDY_TRACE_BLOCK=n``): :func:`library` builds the library for
``TRACE_BLOCK`` (128) unless asked for another block, each into its own
hashed directory, and the host side (the launch glue's walk stacks, lanes
per block and occupancy) reads the same ``TRACE_BLOCK``, which
``tools/block_sweep.py`` sets per variant (:func:`trace_block`).

The phase probe (``tools/phase_probe.py``) runs a second build of the
tracer's source alone, ``-DBENDY_PHASE_STUBS``, whose instantiations replace
phases of the loop with stand-ins (the stub build, ``stubs=True``, in a
hashed directory of its own). The tracer's launches take their library
from :func:`tracer`: while :func:`phase_stubs` holds a stub mask, that is
the stub build, with the mask for their flags (``STUB_SHIFT``; the default
build refuses such a launch). :func:`library` is always the default build.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
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
# the tracer's threads per block that launches run (csrc/trace_surface.cu BLOCK)
TRACE_BLOCK = 128
# the stub build: its source, the entry points it has, and the place of the
# stub mask in a launch's flags (csrc/trace_surface.cu STUB_SHIFT); the mask
# :func:`phase_stubs` holds for :func:`tracer`, else None
STUB_SOURCES = ("trace_surface.cu",)
STUB_ENTRIES = ("bendy_trace_surface", "bendy_trace_volume", "bendy_fold_samples",
                "bendy_staged_floats", "bendy_cuda_error_string")
STUB_SHIFT = 9
PHASE_STUBS: int | None = None

c_void_p, c_int, c_uint, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float

# every C entry point with its ctypes signature: without argtypes ctypes
# passes a Python int as a 32-bit int and cuts the pointer
_TRACE_ARGS = [
    c_void_p, c_int, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,
    c_int, c_int, c_int, c_int, c_int, c_uint, c_uint, c_uint, c_uint,
    c_int, c_int, c_float, c_float, c_int, c_int, c_int, c_int, c_int, c_int,
    c_int, c_int, c_void_p, c_void_p,  # ... want_aovs, bvh0, bvh_tests, loop_use
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
    # flags, volumes, table_floats, n_sph, n_rct, n_box
    "bendy_staged_floats": ([c_int] * 6, c_int),
    # flags, volumes, want_aovs, table_floats, n_sph, n_rct, n_box, out [3] int32 (host)
    "bendy_item_occupancy": ([c_int] * 7 + [c_void_p], c_int),
    # samp, cnt, n, spp, n_out, first, max_iters, out, rays, iters, vevents,
    #   near_steps, over_cap, stream
    "bendy_fold_samples": (
        [c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_void_p, c_void_p, c_void_p,
         c_void_p, c_void_p, c_void_p, c_void_p],
        c_int,
    ),
    # csrc/accumulate.cu: out, n_out, lanes, row0, step, rays, pixels, nn, pix, pix0, film,
    #   add, ray_total, stream
    "bendy_accumulate": (
        [c_void_p, c_int, c_int, c_int, c_int, c_void_p, c_int, c_int, c_void_p, c_int,
         c_void_p, c_int, c_void_p, c_void_p],
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


def sources(stubs: bool = False) -> list[Path]:
    """The sources of a build: every ``csrc/*.cu``, or the stub build's."""
    if stubs:
        return [CSRC / name for name in STUB_SOURCES]
    return sorted(CSRC.glob("*.cu"))


def nvcc_flags(block: int, stubs: bool = False) -> list[str]:
    """The flags of a build whose tracer runs ``block`` threads a block
    (``stubs``: the stub build's)."""
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"the tracer's block is whole warps, 32 to 1024 threads, not {block}")
    return [*NVCC_FLAGS, f"-DBENDY_TRACE_BLOCK={block}", *(["-DBENDY_PHASE_STUBS"] * stubs)]


def _block(block: int | None) -> int:
    return TRACE_BLOCK if block is None else block


def source_hash(block: int | None = None, stubs: bool = False) -> str:
    h = hashlib.sha256(" ".join(nvcc_flags(_block(block), stubs)).encode())
    for src in sources(stubs):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(block: int | None = None, stubs: bool = False) -> tuple[Path, float]:
    """Compile the kernels, the tracer at ``block`` threads a block (default
    ``TRACE_BLOCK``; ``stubs``: the stub build), if this source hash has no
    library yet: one ``nvcc -c`` per source, all started together, then one
    link.

    Returns (library path, seconds spent compiling; 0.0 when it was built
    before). Raises if nvcc fails, with its output.
    """
    return _build(_block(block), stubs)


@functools.cache
def _build(block: int, stubs: bool = False) -> tuple[Path, float]:
    flags_all = nvcc_flags(block, stubs)
    out_dir = BUILD_ROOT / source_hash(block, stubs)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))  # private to this build
    try:
        nvcc = find_nvcc()
        srcs = sources(stubs)
        objs = [str(tmp_dir / f"{src.stem}.o") for src in srcs]
        flags = [f for f in flags_all if f != "-shared"]
        cmds = [[nvcc, *flags, "-c", "-o", o, str(src)] for o, src in zip(objs, srcs)]
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


def library(block: int | None = None) -> ctypes.CDLL:
    """The built kernel library, its tracer at ``block`` threads a block
    (default ``TRACE_BLOCK``), with every entry point's signature set."""
    return _library(_block(block))


def tracer() -> tuple[ctypes.CDLL, int]:
    """The library whose tracer entry points the launches run now, and the
    bits their flags carry: the default build at ``TRACE_BLOCK`` and 0, or,
    while :func:`phase_stubs` holds a mask, the stub build and
    :func:`stub_flags`."""
    return _library(TRACE_BLOCK, PHASE_STUBS is not None), stub_flags()


@functools.cache
def _library(block: int, stubs: bool = False) -> ctypes.CDLL:
    from bendy_tpu_torch import telemetry

    with telemetry.one_off("kernel.library"):
        lib = ctypes.CDLL(str(_build(block, stubs)[0]))
        for name, (argtypes, restype) in SIGNATURES.items():
            if stubs and name not in STUB_ENTRIES:
                continue
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


def build_log(block: int | None = None, stubs: bool = False) -> str:
    """nvcc's output of a build (ptxas register/spill report)."""
    return (BUILD_ROOT / source_hash(block, stubs) / "build.log").read_text()


def stub_flags() -> int:
    """The flag bits of the stub mask :func:`phase_stubs` holds (0 without)."""
    return 0 if PHASE_STUBS is None else PHASE_STUBS << STUB_SHIFT


@contextlib.contextmanager
def phase_stubs(mask: int):
    """The tracer's launches in one block of code run the stub build's
    instantiation of ``mask`` (csrc/trace_surface.cu STUB_*; 0: no phase
    stubbed), built at first use."""
    global PHASE_STUBS
    if not 0 <= mask < 1 << 6:
        raise ValueError(f"a stub mask is 6 bits, not {mask}")
    old, PHASE_STUBS = PHASE_STUBS, mask
    try:
        yield
    finally:
        PHASE_STUBS = old


@contextlib.contextmanager
def trace_block(block: int):
    """``TRACE_BLOCK`` set to ``block`` for one block of code: the tracer's
    launches, and the host's walk stacks, lanes per block and occupancy,
    follow the build of that block (built at first use)."""
    global TRACE_BLOCK
    nvcc_flags(block)  # refuse a block the kernel does not take
    old, TRACE_BLOCK = TRACE_BLOCK, block
    try:
        yield
    finally:
        TRACE_BLOCK = old


def trace_label(aovs: int, geo: int, vol: int, loopm: int, gtab: int, bvh: int,
                stub: int | None = None) -> str:
    """A tracer instantiation's name: its flags (and its stub mask in the
    stub build), and ITEM for the item instantiations (one thread per (lane,
    sample) without LOOPM: geodesics, and media without the BVH; the
    kernel's PER_ITEM)."""
    item = " ITEM" if not loopm and (geo or (vol and not bvh)) else ""
    mask = "" if stub is None else f",STUB={stub}"
    return (f"trace_kernel<AOVS={aovs},GEO={geo},VOL={vol},LOOPM={loopm},GTAB={gtab},"
            f"BVH={bvh}{mask}>{item}")


def ptxas_report(log: str) -> list[str]:
    """One line per kernel instantiation: registers, stack frame, spills."""
    lines, name, frame = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            frame = f"{m.group(1)} B stack, {m.group(2)}/{m.group(3)} B spill st/ld"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            t = re.search(r"trace_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E"
                          r"(?:Li(\d+)E)?", name)
            p = re.search(r"fp32_chain_kernelILb(\d)E", name)
            d = re.search(r"bf16_dot_chain_kernelILi(\d+)ELi(\d+)E", name)
            k = re.search(r"fold_kernel|accumulate_kernel", name)
            label = (trace_label(*(int(g) for g in t.groups()[:6]),
                                 None if t.group(7) is None else int(t.group(7))) if t else
                     f"fp32_chain_kernel<FMA={p.group(1)}>" if p else
                     f"bf16_dot_chain_kernel<BN={d.group(1)},KS={d.group(2)}>" if d else
                     k.group(0) if k else
                     name)
            lines.append(f"{label}: {m.group(1)} registers, {frame}")
    return lines
