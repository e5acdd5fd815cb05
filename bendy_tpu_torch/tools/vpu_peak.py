"""The FP32 ceiling of the card: an FMA chain and an add chain.

Counterpart of the reference's ``tools/vpu_peak.py`` (its Pallas kernel,
``_build``, at vpu_peak.py:85). Two microkernels with exactly known
operation counts, one thread per element in blocks of 128 threads:

  fma   a = a*b + c on 8 independent accumulators: one FFMA per pair of
        operations, so its rate against the datasheet FP32 peak (which
        counts an FMA as 2) is the fused ceiling;
  nofma a = (a + b) + c: two FADDs, no multiply to fuse, against half
        of that peak.

The fma:nofma ratio says how much the card gains from fusion (2.0 = every
pair fuses). The kernel is ``csrc/probes.cu`` (``fp32_chain_kernel``);
:func:`fp32_chain_plain` is its plain version. Times are CUDA events after
at least 0.5 s of warm-up, each launch at least ``MIN_MS``.

    python3 -m bendy_tpu_torch.tools.vpu_peak [--rows 2112] [--iters 200000]
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

OPS_PER_ITER = 64  # operations per element per iteration (both kinds)
PERTURB_OPS = 3  # the per-iteration perturbation: convert, multiply, add
NACC = 8
REPS = OPS_PER_ITER // 2 // NACC
ROWS = 2112  # x 128 lanes = 132 SMs x 2,048 threads: every SM full
PEAK_F32_S = 67e12  # H100 SXM datasheet FP32 (non-tensor) FLOP/s, an FMA counted as 2
MIN_MS = 50.0


def probe_input(rows: int, device) -> torch.Tensor:
    """The reference tool's input: (rows, 128) f32 filled with 1.0000001."""
    return torch.full((rows, 128), 1.0000001, dtype=torch.float32, device=device)


def fp32_chain_plain(x: torch.Tensor, kind: str, iters: int) -> torch.Tensor:
    """The chain in plain PyTorch, on ``x``'s device. An FMA rounds once: it
    is taken in f64 (the product is exact there) and rounded to f32, which
    rounds twice only when the f64 sum is a tie, so the kernel is held to
    it within a stated tolerance."""
    f32 = np.float32
    b = x * float(f32(0.9999999))
    c = x * float(f32(1e-7))
    accs = [x + float(f32(1e-6 * k)) for k in range(NACC)]
    if kind == "fma":
        b64, c64 = b.double(), c.double()
    for i in range(iters):
        for _ in range(REPS):
            for k in range(NACC):
                if kind == "fma":
                    accs[k] = (accs[k].double() * b64 + c64).float()
                else:
                    accs[k] = (accs[k] + b) + c
        accs[0] = accs[0] + float(f32(i) * f32(1e-9))
    acc = accs[0]
    for k in range(1, NACC):
        acc = acc + accs[k]
    return acc


def fp32_chain(x: torch.Tensor, kind: str, iters: int) -> torch.Tensor:
    """The chain over every element of ``x`` (f32, contiguous). On a CUDA
    tensor one launch of the kernel on the current stream (adds one to
    ``fp32_chain.launches``; a build or launch failure raises); on a CPU
    tensor the plain version."""
    if kind not in ("fma", "nofma"):
        raise ValueError(f"kind is 'fma' or 'nofma', not {kind!r}")
    if x.device.type == "cpu":
        return fp32_chain_plain(x, kind, iters)
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"fp32_chain takes a contiguous f32 tensor on cuda, got {x.dtype} "
                         f"on {x.device}")
    if not 0 < x.numel() < 2**31 or not 0 <= iters < 2**31:
        raise ValueError("element count and iters must fit int32")
    from bendy_tpu_torch import _build

    out = torch.empty_like(x)
    lib = _build.library()
    rc = lib.bendy_fp32_chain(x.data_ptr(), out.data_ptr(), x.numel(), iters,
                              int(kind == "fma"),
                              torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bendy_fp32_chain launch failed: CUDA error {rc} "
                           f"({lib.bendy_cuda_error_string(rc).decode()})")
    fp32_chain.launches += 1
    return out


fp32_chain.launches = 0


def ops(rows: int, iters: int) -> int:
    """Operations one launch computes (the reference tool's count)."""
    return rows * 128 * (OPS_PER_ITER + PERTURB_OPS) * iters


def peak(kind: str) -> float:
    """The datasheet rate a kind is held to: FFMA counts 2 operations at the
    FP32 peak, FADD 1 at half of it."""
    return PEAK_F32_S if kind == "fma" else PEAK_F32_S / 2


def measure(kind: str, rows: int = ROWS, iters: int = 200_000, repeats: int = 5,
            device="cuda") -> dict:
    """Median and best operations/s of one kind over ``repeats`` launches of
    at least ``MIN_MS`` each (``iters`` is raised until a launch takes that
    long), with the SM clock read after."""
    from bendy_tpu_torch.tools import card, cuda_ms
    from bendy_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure runs on the card")
    x = probe_input(rows, dev)
    _, ms = cuda_ms(lambda: fp32_chain(x, kind, iters), 1, 1, warm_s=0.5)
    while ms < MIN_MS:
        iters = int(iters * max(2.0, 1.2 * MIN_MS / max(ms, 1e-3)))
        _, ms = cuda_ms(lambda: fp32_chain(x, kind, iters), 1)
    times = [cuda_ms(lambda: fp32_chain(x, kind, iters), 1)[1]
             for _ in range(repeats)]
    clock = card()
    rates = [ops(rows, iters) / (t * 1e-3) for t in times]
    med = statistics.median(rates)
    return dict(kind=kind, rows=rows, iters=iters, ms=statistics.median(times),
                ms_all=times, ops_per_s=med, ops_per_s_best=max(rates),
                share_of_peak=med / peak(kind), sm_clock=clock["clocks.sm"],
                power_draw=clock["power.draw"])


def measure_peaks(rows: int = ROWS, iters: int = 200_000) -> dict:
    """Both kinds, the fusion ratio and each kind's share of its peak."""
    from bendy_tpu_torch.tools import card

    fma = measure("fma", rows, iters)
    add = measure("nofma", rows, iters)
    c = card()
    return {
        "card": c["name"], "power_limit": c["power.limit"],
        "rows": rows, "fma": fma, "nofma": add,
        "fma_ops_per_sec": f"{fma['ops_per_s']:.4e}",
        "nofma_ops_per_sec": f"{add['ops_per_s']:.4e}",
        "fusion_ratio": fma["ops_per_s"] / add["ops_per_s"],
        "peak_f32": PEAK_F32_S,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rows = int(argv[argv.index("--rows") + 1]) if "--rows" in argv else ROWS
    iters = int(argv[argv.index("--iters") + 1]) if "--iters" in argv else 200_000
    print(json.dumps(measure_peaks(rows, iters)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
