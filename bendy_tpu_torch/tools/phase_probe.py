"""The tracer's time split by phase on the card.

Counterpart of the reference's ``tools/phase_probe.py``. Each phase of the
loop is replaced by a cheap stand-in computed from live lane values (a
constant would let the compiler fold the phase's consumers too), the
tracer runs again, and the time it saves per warp-iteration is the phase's
share. The stand-ins are the reference's (``tools/phase_probe.py::_stubs``,
copied here, not imported):

  full       the production loop
  light      sample_light_point and light_pdf (the diffuse next-event
             machinery inside the shade)
  shade      the whole surface shade
  sweep      the nearest hit: the primitive sweep, or the BVH walk
  rng        the integrator's uniforms (pcg4d); the camera's own draws
             belong to ``camera``
  camera     the camera ray's generation, with its draws
  volume     a volume event's scatter decision and its density lookup
             (the port has no brick table, so the reference's
             density_fetch_begin stub has no counterpart)
  marchspec  shade + light: what a march-specialised iteration would drop
  floor      shade + sweep + rng + camera: the loop's residual glue

Two halves of one stub. :func:`stubs` patches the plain modules the loop
calls (``ops/wavefront.py``, ``ops/materials.py``), for the plain trace and
perf_report's CPU op count; on the card the stub build of
``csrc/trace_surface.cu`` (``-DBENDY_PHASE_STUBS``) computes the same
stand-ins in ``if constexpr`` blocks, one instantiation per mask
(:func:`stubbed` selects both). The stub build has the surface, BVH and
volume item instantiations in FULL output with the table in shared memory,
so geodesic scenes and AOV outputs are refused.

Timing (:func:`probe`): each variant's tracer call (``make_tracer(...)
.words`` on the Renderer's lanes: its launch and, per item, its fold) is
the median of ``repeats`` calls with fresh seeds (``tools.cuda_ms_median``)
at perf_report's geometry (256², 64 spp, 2×2, the reference's Config per
class). Stubs shorten paths, so each variant's time is divided by its own
warp-iterations: the sum over warps of the slowest thread's loop length
(``perf_report.issued`` / 32), the counterpart of the reference's
block-iterations. The reference's slope over chains of 2 and 10 passes
cancelled its tunnel's sync cost and is not ported. Per variant:
``us_per_warp_iter``, ``ops_per_lane_iter`` (perf_report's CPU count under
the plain stubs) and, for each stub, ``phase_us = full − stub`` and
``phase_frac = phase_us / full``; the floor's ``us_per_warp_iter`` over the
full one is the residual (``floor_residual_frac``).

:func:`march_share` is the share of traced iterations that were volume
events, read from the kernel's own per-thread counters (volume events over
rays) at MARCH_GEOMETRY, one lane a pixel; the reference toggled a counter
knob of its loop instead.

    python3 -m bendy_tpu_torch.tools.phase_probe [--scene cornell ...]
        [--phases light,shade] [--repeats 5] [--march-share] [--write]
        [--out docs/phase_probe_torch.json]

Without ``--phases`` a scene runs every phase that has something to stub
(``volume`` and ``marchspec`` only with media). ``--write`` writes the
split and, for each scene with media, its march share, with the card's
name and power limit. It raises without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

PHASES = ("light", "shade", "sweep", "rng", "camera", "volume", "marchspec", "floor")
# march_share's film and samples
MARCH_GEOMETRY = {"width": 64, "height": 64, "spp": 4}
# each phase's stand-ins, and their bits in the kernel's stub mask
# (csrc/trace_surface.cu STUB_*)
PHASE_PARTS = {"light": ("light",), "shade": ("shade",), "sweep": ("sweep",), "rng": ("rng",),
               "camera": ("camera",), "volume": ("volume",), "marchspec": ("shade", "light"),
               "floor": ("shade", "sweep", "rng", "camera")}
STUB_BITS = {"light": 1, "shade": 2, "sweep": 4, "rng": 8, "camera": 16, "volume": 32}
MEDIA_PHASES = ("volume", "marchspec")
OUT_JSON = "docs/phase_probe_torch.json"


def check_phases(phases) -> list[str]:
    """The phase names, in :data:`PHASES` order; raises on an unknown one."""
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        raise ValueError(f"unknown phase(s) {unknown}; the phases are {list(PHASES)}")
    return [p for p in PHASES if p in phases]


def stub_mask(phase: str | None) -> int:
    """The kernel's stub mask of ``phase`` (None: the full loop, 0)."""
    if phase is None:
        return 0
    check_phases([phase])
    return sum(STUB_BITS[part] for part in PHASE_PARTS[phase])


# --- the stand-ins (the reference's, on the port's types) ------------------

def stub_light_point(scn, light_idx, u_a, u_b, u_face):
    """Live through u_a; one multiply-add a component."""
    from bendy_tpu_torch.utils.v3 import V3

    return V3(u_a * 0.5 + 1.0, u_a * 0.5 + 2.0, u_a * 0.5 + 0.5)


def stub_light_pdf(pos, d, cmin, cmax, scn, light_idx):
    return pos.x * 0.0 + d.x * 0.1 + 0.3  # live through d


def stub_shade(dir_in, hit, scn, u, clip_min, clip_max, **kw):
    """Emits 0.1, scatters where u1 < 0.5 (a live mixed mask), straight on
    with weight 0.5."""
    from bendy_tpu_torch.ops.materials import Shade
    from bendy_tpu_torch.utils.v3 import V3

    zv = V3.zeros(dir_in.x.shape, dir_in.x.device)
    return Shade(emitted=zv + 0.1, scatter=u[1] < 0.5, direction=dir_in, weight=zv + 0.5,
                 aov_albedo=zv + 0.5, aov_normal=hit.normal, aov_depth=hit.t)


def stub_hit(org, dirv, cmin, cmax, scn, **kw):
    """t = 1 at org + dir, a hit where dir.x > 0 (a mixed mask), normal
    -dir (unit and live: it feeds the shading frame), a diffuse surface of
    albedo 0.6 that also emits 0.1."""
    from bendy_tpu_torch.ops.intersect import FACE_BACK, FACE_FRONT, Hit
    from bendy_tpu_torch.scene.compiler import MAT_DIFFUSE, MAT_EMISSIVE
    from bendy_tpu_torch.utils.v3 import V3

    mixed = dirv.x > 0.0
    zf = org.x * 0.0
    one = V3(zf + 1.0, zf + 1.0, zf + 1.0)
    return Hit(
        t=zf + 1.0,
        valid=mixed,
        position=org + dirv,
        normal=-dirv,
        face=torch.where(mixed, FACE_FRONT, FACE_BACK).to(torch.int32),
        mtype=torch.where(mixed, MAT_DIFFUSE, MAT_EMISSIVE).to(torch.int32),
        albedo=V3(zf + 0.6, zf + 0.6, zf + 0.6),
        rough=zf,
        ior=zf + 1.4,
        emitted=V3(zf + 0.1, zf + 0.1, zf + 0.1),
        vol_grid=(zf - 1.0).to(torch.int32),
        vol_size=one,
        sphere_row=(zf - 1.0).to(torch.int32),
        bbox_min=org,
        bbox_size=one,
    )


def stub_hit_bvh(org, dirv, cmin, cmax, scn, bvh, **kw):
    """:func:`stub_hit` in place of the plain BVH walk, which then tests no
    node and no primitive."""
    from bendy_tpu_torch.ops.bvh import BvhHit

    zero = torch.zeros(org.x.shape, dtype=torch.int64, device=org.x.device)
    return BvhHit(stub_hit(org, dirv, cmin, cmax, scn), zero - 1, zero, zero)


def stub_uniforms(key, lane, tag, n):
    """Distinct live slots of mixed value, ~3 operations each against a
    pcg4d block: slot i is ((lane >> i) & 1)·0.25 + 0.27."""
    li = lane.to(torch.int32)
    return [((li >> i) & 1).to(torch.float32) * 0.25 + 0.27 for i in range(n)]


def stub_camera(cam, width, height, subsample, key, sample_id, uv_base, poly_trig=False,
                has_dof=True):
    """One ray from (0, 0, 14) down -z, live through the stream id."""
    from bendy_tpu_torch.utils.v3 import V3

    zf = sample_id.to(torch.int32).to(torch.float32) * 0.0
    return V3(zf, zf, zf + 14.0), V3(zf, zf, zf - 1.0)


def stub_volume_shade(dir_in, hit, scn, u, step, nearest=False):
    """A scatter where u2 < 0.3 (a live mixed mask), in place and straight
    on, weight 0.8; no density lookup."""
    from bendy_tpu_torch.ops.volume import VolumeShade

    return VolumeShade(scattered=u[2] < 0.3, origin=hit.position, direction=dir_in,
                       weight=hit.t * 0.0 + 0.8)


def stubs() -> dict:
    """{phase: [(module, attr, replacement)]}: the names the plain loop
    binds (``ops/wavefront.py``; ``ops/materials.py`` for the light
    functions, which its shade calls) and their stand-ins."""
    import bendy_tpu_torch.ops.materials as materials
    import bendy_tpu_torch.ops.wavefront as wavefront

    parts = {
        "light": [(materials, "sample_light_point", stub_light_point),
                  (materials, "light_pdf", stub_light_pdf)],
        "shade": [(wavefront, "shade_surface", stub_shade)],
        "sweep": [(wavefront, "nearest_hit", stub_hit),
                  (wavefront, "nearest_hit_bvh_plain", stub_hit_bvh)],
        "rng": [(wavefront, "lane_uniforms", stub_uniforms)],
        "camera": [(wavefront, "camera_ray", stub_camera)],
        "volume": [(wavefront, "volume_shade", stub_volume_shade)],
    }
    return {phase: [p for part in PHASE_PARTS[phase] for p in parts[part]] for phase in PHASES}


@contextlib.contextmanager
def stubbed(phase: str | None):
    """One block of code with ``phase`` stubbed (None: the full loop): the
    plain modules patched with its stand-ins, and the tracer's launches on
    the stub build's instantiation of its mask (``_build.phase_stubs``)."""
    from bendy_tpu_torch import _build

    patches = [] if phase is None else stubs()[check_phases([phase])[0]]
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    try:
        for m, a, repl in patches:
            setattr(m, a, repl)
        with _build.phase_stubs(stub_mask(phase)):
            yield
    finally:
        for m, a, orig in saved:
            setattr(m, a, orig)


def default_phases(scene_name: str) -> list[str]:
    """Every phase with something to stub in ``scene_name``: ``volume`` and
    ``marchspec`` only with media."""
    from bendy_tpu_torch.tools.perf_report import scene_renderer

    r, _ = scene_renderer(scene_name, None, 8, 8, "cpu")
    return [p for p in PHASES if r.has_volumes or p not in MEDIA_PHASES]


# --- the card --------------------------------------------------------------

def time_variant(info: dict, repeats: int = 5) -> dict:
    """The tracer call of the scene of ``info`` (perf_report.loop_body_ops)
    on the card in the phase ``stubbed`` holds: the median, min and max ms
    of ``repeats`` calls with fresh seeds, the mean warp-iterations and rays
    of the timed seeds (each seed again with its per-thread counts; the
    kernel is deterministic per key), ``us_per_warp_iter`` and the rays
    per warp issue slot (a stub changes how many threads of a warp-iteration
    trace, which the division does not undo)."""
    from bendy_tpu_torch.bench import renderer_lanes
    from bendy_tpu_torch.ops.trace_kernel import make_tracer
    from bendy_tpu_torch.tools import cuda_ms_median
    from bendy_tpu_torch.tools.perf_report import issued, scene_renderer, thread_counts

    W, H, spp, n = info["width"], info["height"], info["spp"], info["subsample"]
    r, cam_ref = scene_renderer(info["scene"], info["config"], W, H, "cuda")
    cfg = r.trace_config(r.config, cam_ref)
    if cfg.geodesic or cfg.want_aovs:
        raise ValueError(f"{info['scene']}: the stub build has no geodesic or AOV "
                         "instantiation")
    tracer = make_tracer(r.arrays, W, H, spp, n, cfg)
    pix, sub = renderer_lanes(r, cfg, W, H, spp, n)
    base = int.from_bytes(os.urandom(4), "little") & 0x3FFFFFFF
    _, ms, lo, hi = cuda_ms_median(lambda i: tracer.words(r._cam_packed, base + i, 0, pix, sub),
                                   repeats)
    warp_iters = rays = 0
    for i in range(1, repeats + 1):
        res = tracer(r._cam_packed, base + i, 0, pix, sub, count_items=True)
        t_rays, t_iters = thread_counts(res, pix.numel(), spp, cfg)
        warp_iters += issued(t_iters) // 32
        rays += int(t_rays.sum(dtype=torch.int64))
    warp_iters /= repeats
    rays /= repeats
    return {"kernel_ms": ms, "kernel_ms_min": lo, "kernel_ms_max": hi,
            "warp_iters": warp_iters, "rays": rays, "us_per_warp_iter": ms * 1e3 / warp_iters,
            "rays_per_warp_slot": rays / (32 * warp_iters)}


def phase_split(rows: dict) -> dict:
    """``rows`` ({variant: {"us_per_warp_iter": ...}}, "full" among them)
    with each stub's ``phase_us`` (full − stub) and ``phase_frac``
    (phase_us / full), and the floor's ``floor_residual_frac`` (floor /
    full)."""
    full = rows["full"]["us_per_warp_iter"]
    out = {tag: dict(row) for tag, row in rows.items()}
    for tag, row in out.items():
        if tag == "full":
            continue
        row["phase_us"] = full - row["us_per_warp_iter"]
        row["phase_frac"] = row["phase_us"] / full
        if tag == "floor":
            row["floor_residual_frac"] = row["us_per_warp_iter"] / full
    return out


def probe(scene_name: str, phases=None, repeats: int = 5) -> dict:
    """The full loop and each phase of ``phases`` (default
    :func:`default_phases`) of ``scene_name`` stubbed: each variant's
    :func:`time_variant` and perf_report's CPU count ``ops_per_lane_iter``
    under the same stubs; then :func:`phase_split`."""
    from bendy_tpu_torch import _build
    from bendy_tpu_torch.tools.perf_report import loop_body_ops

    phases = default_phases(scene_name) if phases is None else check_phases(phases)
    rows = {}
    for tag in ["full", *phases]:
        with stubbed(None if tag == "full" else tag):
            info = loop_body_ops(scene_name)
            rows[tag] = time_variant(info, repeats)
            rows[tag].update(stub_mask=_build.PHASE_STUBS,
                             ops_per_lane_iter=info["ops_per_lane_iter"])
        print(f"{scene_name} {tag}: {rows[tag]}", file=sys.stderr, flush=True)
    return phase_split(rows)


def march_share(scene_name: str, width: int = MARCH_GEOMETRY["width"],
                height: int = MARCH_GEOMETRY["height"], spp: int = MARCH_GEOMETRY["spp"],
                device="cuda") -> float:
    """Volume events over rays of one production tracer call (the
    kernel's per-thread counters on a card; the plain loop's on the CPU)
    at width × height, ``spp`` samples, one lane a pixel: the share of
    traced iterations a march-specialised loop would take. ``marchspec``'s
    phase_frac times it bounds what such a loop could win."""
    from bendy_tpu_torch.ops.trace_kernel import make_tracer
    from bendy_tpu_torch.tools.perf_report import scene_renderer

    r, cam_ref = scene_renderer(scene_name, None, width, height, device)
    cfg = r.trace_config(r.config, cam_ref)
    pix = torch.arange(width * height, dtype=torch.int32, device=r.device)
    sub = torch.zeros_like(pix)
    seed = int.from_bytes(os.urandom(4), "little") & 0x3FFFFFFF
    res = make_tracer(r.arrays, width, height, spp, 1, cfg)(r._cam_packed, seed, 0, pix, sub)
    return int(res.vol_events) / max(int(res.rays), 1)


def march_record(scene_name: str) -> dict:
    """:func:`march_share` of ``scene_name`` on the card with its geometry:
    the written entry."""
    return {"march_share": march_share(scene_name), **MARCH_GEOMETRY, "lanes": "one a pixel"}


def main(argv=None) -> int:
    from bendy_tpu_torch.tools import write_json
    from bendy_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", nargs="+", default=["cornell"])
    ap.add_argument("--phases", default=None, help="comma-separated, default: every applicable")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--march-share", action="store_true",
                    help="print each scene's march share and stop")
    ap.add_argument("--write", action="store_true", help=f"write {OUT_JSON}")
    ap.add_argument("--out", default=OUT_JSON)
    args = ap.parse_args(argv)
    phases = None if args.phases is None else check_phases(args.phases.split(","))
    dev = resolve_device("cuda")  # raises without a card
    t0 = time.time()
    if args.march_share:
        for name in args.scene:
            print(json.dumps({"scene": name, "march_share": march_share(name)}))
        return 0
    results = {}
    for name in args.scene:
        results[name] = probe(name, phases, args.repeats)
        print(json.dumps({"scene": name, "phases": results[name]}), flush=True)
    if args.write:
        shares = {name: march_record(name) for name in args.scene
                  if "volume" in default_phases(name)}
        write_json(args.out, {"scenes": results, "march_share": shares}, dev,
                   seconds=time.time() - t0)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
