"""The tracer's primitive sweep on the card: its SASS counted per loop
iteration, and how often a warp could skip a primitive's exact test.

    python3 -m bendy_tpu_torch.tools.sweep_sass [--root DIR] [--skips] [--out JSON]

:func:`sass_counts` compiles ``csrc/trace_surface.cu`` (this package's, or
that of the checkout whose root is ``--root``) once more with
``-lineinfo`` into a cubin, disassembles the surface instantiation and the
geodesic item instantiation (kernel 1d), each in FULL output with its table
in shared memory (``nvdisasm -g``), and finds each loop of the sweep by the
source line of its backward branch: the sphere, rect and box loops of the
nearest hit and the face loop of ``light_pdf``.
Per iteration (a loop that nvcc unrolled u times: its counts over u) it
counts the shared loads by width, FFMA, FMUL, FADD, FSETP, FSEL, FMNMX,
MUFU, CALL, BSSY/BSYNC, branches and all instructions. It also holds the
lineinfo build's opcodes to those of the checkout's built library
(``cuobjdump -sass``), so that the counts are of the code that runs. The
listing parser (:func:`functions`, :func:`instructions`, :func:`loops`)
reads both tools' listings and also serves ``chip_smoke.py``'s counts of
the probes' SASS, and :func:`same_tracers` holds every tracer instantiation
of one built library to another's (a parent checkout's, built by
:func:`checkout_library`).

:func:`skip_shares` builds the measuring build of the tracer's source
(``-DBENDY_SWEEP_STATS``, its own hashed directory under ``_build/``),
runs one tracer call of a scene at its main path's geometry through it
(cornell's surface segments, blackhole's geodesic chords: ``SKIP_PATHS``),
and reads its counters: the lane rect tests, the share of them whose lane
could skip the division and containment test (its t cannot pass cmin, cmax
and t_best: ``quotient_may_win`` in the source) and the share whose whole
warp could. It raises without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

# the surface instantiation: trace_kernel<AOVS=0,GEO=0,VOL=0,LOOPM=0,GTAB=0,BVH=0>
SURFACE = "trace_kernelILb0ELb0ELb0ELb0ELb0ELb0EEEvNS_6ParamsE"
# the geodesic item instantiation (kernel 1d): GEO=1, the rest 0
GEODESIC = "trace_kernelILb0ELb1ELb0ELb0ELb0ELb0EEEvNS_6ParamsE"
# the lane pool: the surface instantiation in the LOOPM slot
LANE_POOL = "trace_kernelILb0ELb0ELb0ELb1ELb0ELb0EEEvNS_6ParamsE"
# skip_shares' scenes at their main paths (chip_smoke.py phases 4 and 5):
# width, height, spp, subsample and the Config's keywords
SKIP_PATHS = {"cornell": (256, 256, 64, 2, {}), "blackhole": (512, 512, 32, 1, {"max_bounces": 2})}
# each loop's for statement in the source: the line its backward branch
# carries (light_pdf's: the first face loop after its definition)
LOOPS = {
    "sphere": r"for \(int k = 0; k < n_sph;",
    "rect": r"for \(int k = 0; k < n_rct;",
    "box": r"for \(int k = 0; k < n_box;",
    "light_pdf": r"for \(int f = 0; f < n_face;",
    # the tracer's thread loop, each of its back edges a natural loop
    "thread": r"for \(; LOOPM \|\| it < P\.max_iters; \+\+it\)",
}
# the counted classes: shared loads by width, then each class of opcode
GROUPS = ("LDS", "LDS.64", "LDS.128", "FFMA", "FMUL", "FADD", "FSETP", "FSEL", "FMNMX", "MUFU",
          "CALL", "BSSY/BSYNC", "BRA")
STATS_FLAG = "-DBENDY_SWEEP_STATS"
SIGNATURE_STATS = ([ctypes.c_void_p], ctypes.c_int)


def loop_lines(source: str) -> dict[str, set[int]]:
    """{loop: the 1-based source lines of its for statements}; light_pdf's
    only the first face loop after ``float light_pdf(``."""
    lines = source.splitlines()
    out = {k: set() for k in LOOPS}
    pdf_at = next((i for i, ln in enumerate(lines) if re.search(r"float light_pdf\(", ln)), None)
    for i, ln in enumerate(lines):
        for kind, pat in LOOPS.items():
            if re.search(pat, ln) and kind != "light_pdf":
                out[kind].add(i + 1)
    if pdf_at is not None:
        j = next((i for i in range(pdf_at, len(lines)) if re.search(LOOPS["light_pdf"], lines[i])),
                 None)
        if j is not None:
            out["light_pdf"].add(j + 1)
    return out


def functions(disasm: str) -> dict[str, str]:
    """{mangled name: its text} of an ``nvdisasm`` or ``cuobjdump -sass``
    listing."""
    out = {}
    nxt = re.compile(r"//-{5,} \.text\.|\n\s*Function : ")
    for m in re.finditer(r"(?:\.text\.|Function : )(\w+)", disasm):
        name = m.group(1)
        if name in out:
            continue
        end = nxt.search(disasm, m.end())
        out[name] = disasm[m.end():end.start() if end else len(disasm)]
    return out


def function(disasm: str, name: str) -> str:
    """The text of the one function of a listing whose mangled name ends
    with ``name``."""
    found = [t for k, t in functions(disasm).items() if k.endswith(name)]
    if len(found) != 1:
        raise ValueError(f"{len(found)} functions named *{name} in the listing")
    return found[0]


def instructions(text: str) -> tuple[list[tuple[int | None, str]], dict[str | int, int]]:
    """The (source line, instruction) list of one function's listing, with
    its branch targets ({label, or address as an int: index of the
    instruction there}; ``nvdisasm`` branches to ``.L_x_N`` labels,
    ``cuobjdump`` to addresses); lines from the ``//## File ..., line N``
    comments of ``nvdisasm -g``."""
    ins, labels, line = [], {}, None
    for ln in text.splitlines():
        s = ln.strip()
        if s.startswith("//##"):
            m = re.search(r"line (\d+)", s)
            line = int(m.group(1)) if m else line
            continue
        m = re.match(r"(\.L_x_\d+):", s)
        if m:
            labels[m.group(1)] = len(ins)
            continue
        m = re.match(r"/\*([0-9a-f]+)\*/\s+(.*?)\s*;", s)
        if m:
            labels[int(m.group(1), 16)] = len(ins)
            ins.append((line, m.group(2)))
    return ins, labels


def opcode(text: str) -> str:
    """An instruction's mnemonic, its predicate dropped."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]


def group(op: str) -> str | None:
    """The counted class of a mnemonic (GROUPS), or None."""
    base = op.split(".")[0]
    if base == "LDS":
        return "LDS.128" if ".128" in op else "LDS.64" if ".64" in op else "LDS"
    if base in ("BSSY", "BSYNC"):
        return "BSSY/BSYNC"
    return base if base in GROUPS else None


def successors(ins, labels) -> list[list[int]]:
    """Each instruction's successors: its branch target, and the next
    instruction unless it is an unpredicated BRA, EXIT or RET."""
    out = []
    for i, (_, text) in enumerate(ins):
        base = opcode(text).split(".")[0]
        nxt = []
        m = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)$", text)
        target = m and (m.group(1) or int(m.group(2), 16))
        if base == "BRA" and target in labels:
            nxt.append(labels[target])
        if not (base in ("BRA", "EXIT", "RET") and not text.startswith("@")):
            nxt.append(i + 1)
        out.append([j for j in nxt if j < len(ins)])
    return out


def loops(ins, labels) -> list[tuple[list[int], int | None]]:
    """Each natural loop as (its instructions' indices, in order; the
    source line of its last backward branch): the target of
    a backward branch and every instruction that reaches one of the
    branches to it without passing it, so that code nvcc placed out of
    line (a rare branch's block after the loop) is counted with the loop."""
    succ = successors(ins, labels)
    pred = [[] for _ in ins]
    for i, js in enumerate(succ):
        for j in js:
            pred[j].append(i)
    latches = {}
    for i, js in enumerate(succ):
        for h in js:
            if h <= i and opcode(ins[i][1]).split(".")[0] == "BRA":
                latches.setdefault(h, []).append(i)
    out = []
    for h, ends in latches.items():
        body, todo = {h}, list(ends)
        while todo:
            i = todo.pop()
            if i not in body:
                body.add(i)
                todo.extend(pred[i])
        out.append((sorted(body), ins[max(ends)][0]))
    return out


def unroll(body, branch_line) -> int:
    """How many iterations one trip of a loop body runs: the step of its
    counter's ``IADD3 Rn, Rn, -0xN`` on its backward branch's line, else
    1."""
    for line, text in body:
        m = re.search(r"IADD3 (R\d+), \1, -0x([0-9a-f]+)", text)
        if line == branch_line and m:
            return int(m.group(2), 16)
    return 1


def count_body(body) -> dict:
    """The GROUPS counts and all instructions of a loop body, per trip."""
    c = Counter(group(opcode(t)) for _, t in body)
    out = {g: c.get(g, 0) for g in GROUPS}
    out["instructions"] = len(body)
    return out


def sweep_counts(disasm: str, source: str, name: str = SURFACE) -> dict:
    """{loop: its counts per iteration, with ``unroll`` and ``trips_found``}
    of the function ``name`` (an ``nvdisasm -g`` listing) whose source is
    ``source``; a loop absent from the code (a scene kind the function does
    not sweep) is left out. Where nvcc left several loops on one for line
    (a remainder loop), the one with the most instructions is counted: its
    natural loop (:func:`loops`), each instruction once a trip."""
    ins, labels = instructions(function(disasm, name))
    where = loop_lines(source)
    out = {}
    found = loops(ins, labels)
    for kind, lines in where.items():
        mine = [(idx, line) for idx, line in found if line in lines]
        if not mine:
            continue
        idx, line = max(mine, key=lambda m: len(m[0]))
        body = [ins[i] for i in idx]
        u = unroll(body, line)
        per = {k: v / u for k, v in count_body(body).items()}
        out[kind] = dict(per, unroll=u, trips_found=len(mine))
    return out


def same_code(lineinfo: str, library: str, name: str = SURFACE) -> bool:
    """Whether the function ``name`` has the same opcodes, in order, in
    both listings."""
    ops = [[opcode(t) for _, t in instructions(function(d, name))[0]] for d in (lineinfo, library)]
    return ops[0] == ops[1]


def same_tracers(library: str, other: str) -> dict[str, bool | None]:
    """{label (``_build.trace_label``): whether it has the same opcodes in
    both listings} over the tracer instantiations of the library listing
    ``library``, each found in ``other`` by its mangled name after the
    anonymous namespace (whose hash follows the source's path); None where
    ``other`` has no such function."""
    from bendy_tpu_torch import _build

    theirs = functions(other)
    out = {}
    for name in functions(library):
        m = re.search(r"trace_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E.*", name)
        if m:
            tail = m.group(0)
            found = any(k.endswith(tail) for k in theirs)
            out[_build.trace_label(*(int(g) for g in m.groups()))] = (
                same_code(library, other, tail) if found else None)
    return out


def checkout_library(root: Path) -> tuple[Path, str]:
    """(the library, its build log) of the checkout at ``root``, built by
    its own ``_build`` (its flags, into its own ``_build/``) in a process of
    its own."""
    cmd = [sys.executable, "-c", "import sys; from bendy_tpu_torch import _build; "
           "lib, _ = _build.build(); print(lib.resolve()); sys.stdout.write(_build.build_log())"]
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True, check=True,
                         timeout=900).stdout
    lib, _, log = out.partition("\n")
    return Path(lib.strip()), log


def _tool(name: str) -> str:
    from bendy_tpu_torch import _build

    return str(Path(_build.find_nvcc()).parent / name)


def lineinfo_listing(root: Path | None = None) -> tuple[str, str]:
    """(``nvdisasm -g`` listing, source text) of ``csrc/trace_surface.cu`` of
    the checkout at ``root`` (default: this package's), built with this
    package's flags for the default block and ``-lineinfo``."""
    from bendy_tpu_torch import _build

    src = (Path(root) / "bendy_tpu_torch" / "csrc" if root else _build.CSRC) / "trace_surface.cu"
    flags, skip = [], False
    for f in _build.nvcc_flags(_build.TRACE_BLOCK):
        if skip or f in ("-shared", "-Xcompiler"):
            skip = f == "-Xcompiler"
            continue
        flags.append(f)
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "trace_surface.cubin"
        subprocess.run([_build.find_nvcc(), *flags, "-lineinfo", "-cubin", "-o", str(cubin),
                        str(src)], check=True, capture_output=True, text=True, timeout=600)
        listing = subprocess.run([_tool("nvdisasm"), "-g", "-c", str(cubin)], check=True,
                                 capture_output=True, text=True, timeout=300).stdout
    return listing, src.read_text()


def library_listing(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    return subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout


def sass_counts(root: Path | None = None, lib: Path | None = None, listing=None) -> dict:
    """The sweep's counts per iteration (:func:`sweep_counts`) of the
    checkout at ``root`` (default: this package's), in the surface
    instantiation (``loops``) and the geodesic item one (``geodesic``), and
    whether its lineinfo build has the opcodes of its library ``lib`` in
    both (default: this package's default build; the newest built library
    under ``root``). ``listing``: :func:`lineinfo_listing`'s result, where
    it was made already."""
    from bendy_tpu_torch import _build

    listing, source = listing or lineinfo_listing(root)
    if lib is None:
        if root is None:
            lib = _build.build()[0]
        else:
            libs = sorted((Path(root) / "bendy_tpu_torch" / "_build").glob("*/" + _build.LIB_NAME),
                          key=lambda p: p.stat().st_mtime)
            lib = libs[-1] if libs else None
    library = None if lib is None else library_listing(lib)
    match = None if library is None else all(same_code(listing, library, name)
                                             for name in (SURFACE, GEODESIC))
    pool = LANE_POOL if any(k.endswith(LANE_POOL) for k in functions(listing)) else None
    return {"instantiation": _build.trace_label(0, 0, 0, 0, 0, 0),
            "lineinfo_matches_library": match, "loops": sweep_counts(listing, source),
            "geodesic": {"instantiation": _build.trace_label(0, 1, 0, 0, 0, 0),
                         "loops": sweep_counts(listing, source, GEODESIC)},
            "lane_pool": pool and {"instantiation": _build.trace_label(0, 0, 0, 1, 0, 0),
                                   "loops": sweep_counts(listing, source, LANE_POOL)}}


# --- how often a warp could skip ------------------------------------------

def stats_library() -> ctypes.CDLL:
    """The measuring build of the tracer's source (``-DBENDY_SWEEP_STATS``),
    built at first use into ``_build/stats-<hash>/``, with the surface and
    geodesic entries', ``bendy_staged_floats``', the error string's,
    ``bendy_sweep_stats``' and ``bendy_lane_pool_stats``' (the lane pool's
    draws and its threads' loop trips) signatures."""
    from bendy_tpu_torch import _build

    flags = [*_build.nvcc_flags(_build.TRACE_BLOCK), STATS_FLAG]
    src = _build.CSRC / "trace_surface.cu"
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
    lib = _build.BUILD_ROOT / f"stats-{h}" / "libsweep_stats.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(".tmp")
        proc = subprocess.run([_build.find_nvcc(), *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the measuring build:\n{proc.stdout}{proc.stderr}")
        tmp.replace(lib)
    cdll = ctypes.CDLL(str(lib))
    for name in ("bendy_trace_surface", "bendy_trace_geodesic", "bendy_staged_floats",
                 "bendy_cuda_error_string"):
        getattr(cdll, name).argtypes, getattr(cdll, name).restype = _build.SIGNATURES[name]
    cdll.bendy_sweep_stats.argtypes, cdll.bendy_sweep_stats.restype = SIGNATURE_STATS
    cdll.bendy_lane_pool_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    cdll.bendy_lane_pool_stats.restype = ctypes.c_int
    return cdll


@contextlib.contextmanager
def measuring(lib: ctypes.CDLL):
    """The tracer's launches in one block of code run ``lib``."""
    from bendy_tpu_torch import _build

    old = _build.tracer
    _build.tracer = lambda: (lib, 0)
    try:
        yield
    finally:
        _build.tracer = old


def tracer_call(scene: str = "cornell", width: int = 256, height: int = 256, spp: int = 64,
                 subsample: int = 2, config=None):
    """A function that runs one tracer call of ``scene`` (the Renderer's
    lanes; ``config``, else perf_report's Config) with a seed, on the
    card."""
    from bendy_tpu_torch.bench import renderer_lanes
    from bendy_tpu_torch.ops.trace_kernel import make_tracer
    from bendy_tpu_torch.tools.perf_report import scene_renderer

    r, cam = scene_renderer(scene, config, width, height, "cuda")
    cfg = r.trace_config(r.config, cam)
    tracer = make_tracer(r.arrays, width, height, spp, subsample, cfg)
    pix, sub = renderer_lanes(r, cfg, width, height, spp, subsample)
    return lambda seed: tracer.words(r._cam_packed, seed, 0, pix, sub)


def skip_shares(scene: str = "cornell") -> dict:
    """One tracer call of ``scene`` at its main path (``SKIP_PATHS``, the
    Renderer's lanes) through the measuring build: its lane rect tests,
    ``lane_skip_share`` (tests whose lane could skip the division) and
    ``warp_skip_share`` (tests whose whole warp could)."""
    import os

    import torch

    from bendy_tpu_torch import Config

    width, height, spp, subsample, kw = SKIP_PATHS[scene]
    call = tracer_call(scene, width, height, spp, subsample, Config(**kw))
    lib = stats_library()
    counts = (ctypes.c_ulonglong * 3)()
    seed = int.from_bytes(os.urandom(4), "little") & 0x3FFFFFFF
    with measuring(lib):
        lib.bendy_sweep_stats(ctypes.addressof(counts))  # zero the counters
        call(seed)
        torch.cuda.synchronize()
        rc = lib.bendy_sweep_stats(ctypes.addressof(counts))
    if rc:
        raise RuntimeError(f"bendy_sweep_stats: CUDA error {rc}")
    tests, lane, warp = counts
    return {"scene": scene, "width": width, "height": height, "spp": spp, "subsample": subsample,
            "rect": {"tests": tests, "lane_skip_share": lane / max(tests, 1),
                     "warp_skip_share": warp / max(tests, 1)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=None,
                    help="the root of another checkout (its source and built library)")
    ap.add_argument("--skips", action="store_true",
                    help="also the skip shares on cornell and blackhole")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = {"sass": sass_counts(args.root)}
    if args.skips:
        res["skips"] = [skip_shares(scene) for scene in SKIP_PATHS]
    text = json.dumps(res)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
