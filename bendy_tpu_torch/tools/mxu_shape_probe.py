"""The tensor-core rate of the card at the brick-fetch dot's shape.

Counterpart of the reference's ``tools/mxu_shape_probe.py`` (its Pallas
kernel, ``_build``, at mxu_shape_probe.py:110). The function is a chain of
``iters`` products ``acc[128, n] += bf16(tab[128, 512] + f32(i)*1e-6) .
onehot[512, n]``, bf16 in and f32 accumulation, with a perturbation that
changes every iteration so no two products fold. ``n`` is the lanes of one
fetch chunk (the reference's production chunk is 2048). The f32-input
control rounds ``tab + pert`` and ``onehot`` to bf16, as DEFAULT precision
rounds a dot's inputs.

The kernel is ``csrc/probes.cu`` (``bf16_dot_chain_kernel``: wgmma
m64nBNk16 on the tensor cores, A rebuilt in registers every iteration
against a B slice held in shared memory; :func:`dot_plan` picks its tile
from ``n``); :func:`bf16_dot_chain_plain` is its plain version, and
:func:`library_dot_chain` the yardstick: the same sum through cuBLAS,
``chunk`` perturbed copies of ``tab`` side by side against
``chunk`` stacked copies of ``onehot``, one ``torch.mm`` of depth
``chunk*512`` per chunk of iterations. :func:`measure` times it captured in
a CUDA graph (no host launch cost) at each of ``LIBRARY_CHUNKS`` and keeps
the fastest.

    python3 -m bendy_tpu_torch.tools.mxu_shape_probe [--iters N] [--ns 1024,2048,4096,8192]
"""

from __future__ import annotations

import json
import statistics
import sys
from dataclasses import dataclass

import numpy as np
import torch

M, K = 128, 512  # the brick-table fetch shape (125 -> 128 padded, NB = 512)
N_ALIGN = 64  # n must be a multiple of the kernel's narrowest column tile
# the kernel's instantiated tiles (csrc/probes.cu bendy_bf16_dot_chain): 256
# output columns a block with a depth slice of 64, 32 or 16 (deepest first),
# and 64 x 64 for the multiples of 64 that 256 does not divide
DOT_WIDE, DOT_KSS = 256, (64, 32, 16)
DOT_NARROW = (64, 64)
SMS = 132  # H100 SXM streaming multiprocessors
PEAK_BF16_S = 989e12  # H100 SXM datasheet dense bf16 tensor FLOP/s
LIBRARY_CHUNKS = (64, 256, 1024)  # iterations per library product, the ones measure() tries
LIBRARY_FORM = "torch.mm(bf16, bf16, out_dtype=torch.float32) per chunk, in a CUDA graph"
MIN_MS = 50.0


def _dtype(name: str) -> torch.dtype:
    if name not in ("bf16", "f32"):
        raise ValueError(f"dtype is 'bf16' or 'f32', not {name!r}")
    return torch.bfloat16 if name == "bf16" else torch.float32


def probe_inputs(n: int, dtype_name: str = "bf16", device="cpu"):
    """The reference tool's inputs: tab [128, 512] = 0.5, onehot [512, n] = 0.25."""
    dt = _dtype(dtype_name)
    return (torch.full((M, K), 0.5, dtype=dt, device=device),
            torch.full((K, n), 0.25, dtype=dt, device=device))


def perturbation(i: int) -> float:
    """f32(i) * f32(1e-6), as the kernels compute it."""
    return float(np.float32(i) * np.float32(1e-6))


def bf16_dot_chain_plain(tab: torch.Tensor, onehot: torch.Tensor, iters: int) -> torch.Tensor:
    """The chain in plain PyTorch on the inputs' device: bf16 operands
    widened to f32 (their products are exact there) and f32 products."""
    oh = onehot.to(torch.bfloat16).float()
    tab32 = tab.float()
    acc = torch.zeros((tab.shape[0], onehot.shape[1]), dtype=torch.float32, device=tab.device)
    for i in range(iters):
        tab_i = (tab32 + perturbation(i)).to(torch.bfloat16).float()
        acc += tab_i @ oh
    return acc


@dataclass(frozen=True)
class DotPlan:
    """The kernel's tile for one n: a block of two warpgroups owns ``bn``
    output columns of all 128 rows and a ``ks``-deep slice of K."""

    n: int
    bn: int
    ks: int

    @property
    def tiles(self) -> int:  # column tiles
        return self.n // self.bn

    @property
    def split(self) -> int:  # slices of K, one f32 partial each
        return K // self.ks

    @property
    def blocks(self) -> int:
        return self.tiles * self.split

    @property
    def fill(self) -> float:
        """Blocks over the SM slots of the waves they take, one block an SM
        (as a 256-column block's registers allow)."""
        return self.blocks / (-(-self.blocks // SMS) * SMS)


def dot_plan(n: int) -> DotPlan:
    """Where 256 divides ``n``, the 256-column tile with the depth slice
    whose grid fills the SMs best in whole waves (the deeper on a tie: fewer
    partials, more products a fragment build); else 64 x 64."""
    if n <= 0 or n % N_ALIGN:
        raise ValueError(f"n must be a positive multiple of {N_ALIGN}, got {n}")
    if n % DOT_WIDE:
        return DotPlan(n, *DOT_NARROW)
    return max((DotPlan(n, DOT_WIDE, ks) for ks in DOT_KSS),
               key=lambda p: (round(p.fill, 9), p.ks))


def sum_partials(partial: torch.Tensor) -> torch.Tensor:
    """partial[0] + partial[1] + ... in index order: the same f32 sums on
    every run."""
    out = partial[0]
    for s in range(1, partial.shape[0]):
        out = out + partial[s]
    return out


def _check(tab: torch.Tensor, onehot: torch.Tensor) -> int:
    n = onehot.shape[1] if onehot.dim() == 2 else -1
    if tab.shape != (M, K) or onehot.shape != (K, n) or n <= 0 or n % N_ALIGN:
        raise ValueError(f"tab must be [{M}, {K}] and onehot [{K}, n] with n a multiple of "
                         f"{N_ALIGN}; got {tuple(tab.shape)}, {tuple(onehot.shape)}")
    if tab.dtype != onehot.dtype or tab.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"tab and onehot must both be bf16 or both f32, got {tab.dtype}, "
                         f"{onehot.dtype}")
    if tab.device != onehot.device or not (tab.is_contiguous() and onehot.is_contiguous()):
        raise ValueError("tab and onehot must be contiguous and on one device")
    return n


def bf16_dot_chain(tab: torch.Tensor, onehot: torch.Tensor, iters: int) -> torch.Tensor:
    """The chain, [128, n] f32. On CUDA tensors one launch of the kernel on
    the current stream at :func:`dot_plan`'s tile, which takes ``tab`` in
    f32 (a bf16 tab widened, exactly) and ``onehot`` in bf16 (the f32
    control's rounded, as DEFAULT precision rounds it), plus
    :func:`sum_partials` of its split-K partials (adds one to
    ``bf16_dot_chain.launches``; a build or launch failure raises); on CPU
    tensors the plain version."""
    n = _check(tab, onehot)
    if tab.device.type == "cpu":
        return bf16_dot_chain_plain(tab, onehot, iters)
    if tab.device.type != "cuda":
        raise ValueError(f"no dot chain on {tab.device}")
    if not 0 <= iters < 2**31:
        raise ValueError("iters must fit int32")
    from bendy_tpu_torch import _build

    plan = dot_plan(n)
    tab32, oh16 = tab.float(), onehot.to(torch.bfloat16)  # no copy where already so
    partial = torch.empty((plan.split, M, n), dtype=torch.float32, device=tab.device)
    lib = _build.library()
    rc = lib.bendy_bf16_dot_chain(tab32.data_ptr(), oh16.data_ptr(), partial.data_ptr(), n,
                                  iters, plan.bn, plan.ks,
                                  torch.cuda.current_stream(tab.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bendy_bf16_dot_chain launch failed: CUDA error {rc} "
                           f"({lib.bendy_cuda_error_string(rc).decode()})")
    bf16_dot_chain.launches += 1
    return sum_partials(partial)


bf16_dot_chain.launches = 0


def library_dot_chain(tab: torch.Tensor, onehot: torch.Tensor, iters: int, chunk: int = 256,
                      stacked: torch.Tensor | None = None) -> torch.Tensor:
    """The same sum through ``torch.mm`` (cuBLAS on the card), the
    yardstick and never the port's path: per chunk of ``chunk`` iterations
    the perturbed copies of ``tab`` side by side, [128, chunk*512] bf16
    (one add that rounds to bf16 on write), against ``stacked`` (``onehot``
    rounded to bf16 and stacked ``chunk`` times, [chunk*512, n]; built
    here when not given), the product taken in f32."""
    if stacked is None:
        stacked = onehot.to(torch.bfloat16).repeat(chunk, 1)
    tab32 = tab.float()
    # f32(i) * f32(1e-6): arange is exact in f32 below 2**24
    perts = torch.arange(iters, dtype=torch.float32, device=tab.device) * perturbation(1)
    a = torch.empty((M, chunk, K), dtype=torch.bfloat16, device=tab.device)
    acc = torch.zeros((M, onehot.shape[1]), dtype=torch.float32, device=tab.device)
    for i0 in range(0, iters, chunk):
        c = min(chunk, iters - i0)
        torch.add(tab32[:, None, :], perts[i0:i0 + c, None], out=a[:, :c])
        acc += _mm_f32(a[:, :c].reshape(M, c * K), stacked[: c * K])
    return acc


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 [M, k] x bf16 [k, n] -> f32."""
    if a.device.type == "cpu":  # no bf16 -> f32 product on the CPU: widen first (exact)
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


def library_graph(tab: torch.Tensor, onehot: torch.Tensor, iters: int, chunk: int):
    """(replay, out): :func:`library_dot_chain` captured in a CUDA graph, so
    a replay costs the device time of its launches and no host time; each
    replay writes the sum to ``out``."""
    stacked = onehot.to(torch.bfloat16).repeat(chunk, 1)
    library_dot_chain(tab, onehot, chunk, chunk, stacked)  # cuBLAS set up outside the capture
    torch.cuda.synchronize(tab.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = library_dot_chain(tab, onehot, iters, chunk, stacked)

    def replay() -> torch.Tensor:
        graph.replay()
        return out

    replay.stacked = stacked  # the graph reads it: it must live as long as the graph
    return replay, out


def flops(n: int, iters: int) -> int:
    return 2 * M * K * n * iters


def measure(n: int, iters: int = 20_000, repeats: int = 5, dtype_name: str = "bf16",
            device="cuda", library: bool = True) -> dict:
    """Median FLOP/s of the kernel over ``repeats`` launches of at least
    ``MIN_MS`` each (``iters`` raised until a launch takes that long), its
    share of the bf16 peak, the medians of the SM clock and power draw that
    nvidia-smi read during those launches (and once after them), its tile
    (:func:`dot_plan`'s), and (``library``) the cuBLAS yardstick's time for
    the same work on the same inputs: the median of 3 graph replays at each
    of ``LIBRARY_CHUNKS``, the fastest chunk's kept as ``library_ms``."""
    from bendy_tpu_torch.tools import card, card_during, cuda_ms
    from bendy_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure runs on the card")
    plan = dot_plan(n)
    tab, oh = probe_inputs(n, dtype_name, dev)
    _, ms = cuda_ms(lambda: bf16_dot_chain(tab, oh, iters), 1, 1, warm_s=0.5)
    while ms < MIN_MS:
        iters = int(iters * max(2.0, 1.2 * MIN_MS / max(ms, 1e-3)))
        _, ms = cuda_ms(lambda: bf16_dot_chain(tab, oh, iters), 1)
    with card_during() as during:
        times = [cuda_ms(lambda: bf16_dot_chain(tab, oh, iters), 1)[1]
                 for _ in range(repeats)]
    clock = card()
    rates = [flops(n, iters) / (t * 1e-3) for t in times]
    med = statistics.median(rates)
    out = dict(n=n, dtype=dtype_name, iters=iters, ms=statistics.median(times), ms_all=times,
               flops_per_s=med, flops_per_s_best=max(rates), share_of_peak=med / PEAK_BF16_S,
               sm_clock=(f"{during['clocks.sm']:.0f} MHz" if during["samples"] else None),
               power_draw=(f"{during['power.draw']:.2f} W" if during["samples"] else None),
               clock_samples=during["samples"], sm_clock_after=clock["clocks.sm"],
               power_draw_after=clock["power.draw"], bn=plan.bn, ks=plan.ks,
               blocks=plan.blocks)
    if library:
        by_chunk = {}
        for chunk in LIBRARY_CHUNKS:
            replay, _ = library_graph(tab, oh, iters, chunk)
            by_chunk[chunk] = [cuda_ms(replay, 1, 1)[1] for _ in range(3)]
            del replay
        best = min(by_chunk, key=lambda c: statistics.median(by_chunk[c]))
        lib_ms = statistics.median(by_chunk[best])
        out.update(library_ms=lib_ms, library_chunk=best, library_ms_by_chunk=by_chunk,
                   library_flops_per_s=flops(n, iters) / (lib_ms * 1e-3))
    return out


def main(argv=None) -> int:
    from bendy_tpu_torch.tools import card

    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[argv.index("--iters") + 1]) if "--iters" in argv else 20_000
    ns = ([int(x) for x in argv[argv.index("--ns") + 1].split(",")] if "--ns" in argv
          else [1024, 2048, 4096, 8192])
    c = card()
    out = {"card": c["name"], "power_limit": c["power.limit"], "M": M, "K": K,
           "peak_flops": PEAK_BF16_S}
    for n in ns:
        out[f"n{n}"] = measure(n, iters)
    out["f32_n2048"] = measure(2048, iters, dtype_name="f32", library=False)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
