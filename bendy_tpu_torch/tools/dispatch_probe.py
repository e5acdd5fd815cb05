"""The cost of launching render passes one by one, against one CUDA graph.

Counterpart of the reference's ``tools/dispatch_probe.py``, which ran N
passes as N separate dispatches and as one device program (a fori_loop
over the pass index). The port's counterpart of one program is a CUDA
graph of the same N passes:

  chain  the render pass (``ops/trace_kernel.make_render_pass``) called N
         times into one film, then one synchronize: the Renderer's pattern
  graph  the same N passes, at the same key and pass ids, captured once
         into a ``torch.cuda.CUDAGraph`` and replayed

Before any timing the two are held to each other, as the reference held
its two accumulations: the films bit-equal and the ray counts equal.
Then ``repeats`` rounds of one chain and one replay, each timed on the
host's clock to its synchronize, give the medians and the dispatch cost
per pass, (chain − graph) / N. Nothing on the render path changes for
this: where CUDA refuses a call inside the capture (a host sync, a host
read), the row says which call stopped it (``capture_error``,
``stopped_at``) and times the chain alone; any other fault raises.

    python3 -m bendy_tpu_torch.tools.dispatch_probe [--scene cornell ...]
        [--passes 4] [--repeats 5] [--out docs/dispatch_probe_torch.json]

Each scene of SCENES renders its main path's pass (``chip_smoke.py``
phases 4 and 12): RES², its subpixels and samples, in the reference's
configuration (``tools/perf_report.SCENE_CONFIG_KW``) with the bounce cap
given there. The rows go to ``--out`` with the card's name and power
limit. It raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback

PASSES = 4
REPEATS = 5
OUT_JSON = "docs/dispatch_probe_torch.json"
RES = 256
# each scene's pass: (samples, subsample, the bounce cap where the main path
# replaces its Config's)
SCENES = {"cornell": (64, 2, None), "light_field_200": (16, 1, 3)}


def capture_stopped(exc: RuntimeError) -> bool:
    """Whether ``exc`` is CUDA's refusal of a call inside a stream capture
    (the cudaErrorStreamCapture* family, each of whose messages names the
    capture), not another fault."""
    return "captur" in str(exc)


def stopped_at(exc: BaseException) -> str:
    """The innermost frame of this package in ``exc``'s traceback: the call
    that stopped a capture."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "bendy_tpu_torch" in f.filename and not f.filename.endswith("dispatch_probe.py")]
    if not frames:
        return "outside bendy_tpu_torch"
    f = frames[-1]
    return f"{f.filename[f.filename.rfind('bendy_tpu_torch'):]}:{f.lineno} {f.name}: {f.line}"


def measure(name: str, passes: int = PASSES, repeats: int = REPEATS) -> dict:
    """One scene's row on the card (the module docstring's protocol)."""
    from dataclasses import replace

    import torch

    from bendy_tpu_torch.ops.trace_kernel import make_render_pass
    from bendy_tpu_torch.tools.perf_report import scene_config, scene_renderer

    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r}: one of {sorted(SCENES)}")
    W = H = RES
    spp, subsample, max_bounces = SCENES[name]
    config = scene_config(name)
    if max_bounces is not None:
        config = replace(config, max_bounces=max_bounces)
    r, cam_ref = scene_renderer(name, config, W, H, "cuda")
    cfg = r.trace_config(r.config, cam_ref)
    fn = make_render_pass(r.arrays, W, H, H, spp, subsample, cfg, "full")
    seed = int.from_bytes(os.urandom(4), "little") & 0x3FFFFFFF

    def chain(film, rays):
        for p in range(passes):
            fn(r._cam_packed, seed, p, 0, film, add=True, rays=rays)

    def zeros():
        return (torch.zeros((H, W, 3), dtype=torch.float32, device=r.device),
                torch.zeros(1, dtype=torch.int64, device=r.device))

    film_c, rays_c = zeros()
    chain(film_c, rays_c)  # the first passes build the lanes and upload the tables
    torch.cuda.synchronize()
    row = {"scene": name, "width": W, "height": H, "spp": spp, "subsample": subsample,
           "max_bounces": cfg.max_bounces, "passes": passes, "repeats": repeats,
           "rays_per_chain": int(rays_c)}
    film_g, rays_g = zeros()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            chain(film_g, rays_g)
    except RuntimeError as exc:
        if not capture_stopped(exc):
            raise
        torch.cuda.synchronize()
        row.update(captured=False, capture_error=str(exc).splitlines()[0],
                   stopped_at=stopped_at(exc))
        graph = None
    if graph is not None:
        graph.replay()  # nothing ran while capturing
        torch.cuda.synchronize()
        row.update(captured=True, films_bit_equal=bool(torch.equal(film_c, film_g)),
                   rays_equal=int(rays_c) == int(rays_g))
    chain_t, graph_t = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        chain(film_c, rays_c)
        torch.cuda.synchronize()
        chain_t.append(time.perf_counter() - t0)
        if graph is not None:
            t0 = time.perf_counter()
            graph.replay()
            torch.cuda.synchronize()
            graph_t.append(time.perf_counter() - t0)
    ct = statistics.median(chain_t)
    row.update(chain_s_median=ct, chain_s_all=chain_t,
               chain_mrays=row["rays_per_chain"] / ct / 1e6)
    if graph is not None:
        gt = statistics.median(graph_t)
        row.update(graph_s_median=gt, graph_s_all=graph_t,
                   graph_mrays=row["rays_per_chain"] / gt / 1e6,
                   dispatch_ms_per_pass=(ct - gt) / passes * 1e3)
    return row


def main(argv=None) -> int:
    from bendy_tpu_torch.tools import write_json
    from bendy_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", nargs="+", choices=sorted(SCENES), default=["cornell"])
    ap.add_argument("--passes", type=int, default=PASSES)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--out", default=OUT_JSON)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # raises without a card
    t0 = time.time()
    rows = []
    for name in args.scene:
        rows.append(measure(name, args.passes, args.repeats))
        print(json.dumps(rows[-1]), flush=True)
    write_json(args.out, {"rows": rows}, dev, seconds=time.time() - t0,
               argv=sys.argv[1:] if argv is None else argv)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
