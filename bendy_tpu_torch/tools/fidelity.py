"""MSE-vs-spp curves of the port's renders against the C++ oracle.

Counterpart of the reference's ``tools/fidelity.py``. For every bundled
scene it renders the port at several spp levels and compares against a
high-spp ground truth from the native oracle (``native/oracle.cpp``,
through :mod:`bendy_tpu_torch.native`; for geodesic scenes its independent
RK4 implementation). An unbiased estimator of the same integral shows
mse ~ 1/spp with bias -> 0; a systematic estimator difference shows up as
a bias floor.

The port renders one pass of ``spp`` samples at 1x1 subpixels through the
``Renderer``, with the reference's key ``render_key(5, 0)`` and its lane
order, so on flat scenes its image is the reference's lane for lane and
its entries equal ``docs/fidelity.json``'s. :func:`check_against` holds an
entry to that table. Renders run on the card unless ``--device cpu``; the
oracle always runs on the host's CPU cores.

    python3 -m bendy_tpu_torch.tools.fidelity [--res 24] [--ref-spp 8192] \\
        [--scenes cornell cloud] [--device cuda] [--out docs/fidelity_torch.json]

The output has the reference's format, one entry per scene, plus a
``"_meta"`` key: the card's name and power limit (nvidia-smi), the commit
and the run's seconds. Each point also records ``n_nonlight``, the pixels
its non-light statistics average over (the statistical band's n).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

# Every bundled scene, with the reference's options (tools/fidelity.py:32-56):
# flat, volumetric, dense-grid, geodesic, and the geodesic x media showcases.
FIDELITY_SCENES = {
    "cornell": {},
    "cornell2": {},
    "scene": {},
    "volume": {},
    "cloud": {},
    "dense_cloud": {},
    "cuboid_light": {},  # F>1 face-CDF light sampling
    "blackhole": {"geodesic": True},
    "binary_blackhole": {"geodesic": True},
    "blackhole_cloud": {"geodesic": True, "volume_step": 0.6},
    # 256 volume puffs: the oracle's O(prims) march steps cost ~30x cornell
    # per sample, so its reference and spot spp are reduced
    "cloud_field": {"ref_spp": 4096, "spot_ref_spp": 1024, "spp": [16, 64, 256]},
    # 64 looped masses, emissive only: paths are deterministic per (pixel,
    # sample), and the oracle recomputes h per RK4 stage as the looped sweep does
    "mass_cluster": {"geodesic": True, "ref_spp": 256},
}

OURS_SEED, REF_SEED, CEILING_SEED = 5, 11, 12
LIGHT_PIXEL = 3.0  # a reference pixel brighter than this (channel mean) sees a light

# Bands of check_against, fixed from a CPU run of the port before any card
# run (cornell at 24², seed 5, against the oracle at 8192 spp: equal to 7
# digits; cloud: 7 of 576 pixels differ at spp 16, by float order).
# Flat scenes (kernel 1a) render the reference's lanes: mse and mse_nonlight
# within FLAT_REL of the table, bias_nonlight within FLAT_BIAS_ABS +
# FLAT_REL x its magnitude, the spot corr within FLAT_CORR.
FLAT_SCENES = ("cornell", "cornell2", "scene", "cuboid_light")
FLAT_REL, FLAT_BIAS_ABS, FLAT_CORR = 0.01, 1e-5, 1e-3
# Media and geodesic scenes: a few lanes diverge by float order (a scatter
# decision, a grazing chord), so they are held statistically: mse_nonlight
# at most STAT_MSE_RATIO x the table's, bias_nonlight within STAT_SIGMAS
# standard errors of the mean difference, sqrt(table mse_nonlight /
# n_nonlight), of the table's, the spot corr at least the table's less
# STAT_CORR_DROP.
STAT_MSE_RATIO, STAT_SIGMAS, STAT_CORR_DROP = 1.5, 3.0, 0.01
# mass_cluster's bias is held one-sided, no further from 0 than the table's
# by STAT_SIGMAS standard errors. The table's -0.025 to -0.035 bias floor is
# not the estimator's: the reference's own tool, run on the CPU before any
# card run of this band, gives -0.0019 at spp 16 and -0.0049 at spp 64
# against the same oracle image (mse_nonlight 0.0425 and 0.0125 against the
# table's 0.0497 and 0.0224), and the port's CPU route -0.0009 and -0.0012
# (0.0410, 0.0129). Held to the table's floor, the port would fail for
# being closer to the oracle.
BIAS_NO_WORSE = ("mass_cluster",)


def prepare(name: str, max_bounces: int):
    """(scene, camera ref, oracle kwargs, max_bounces, volume_step) of one
    table scene, set up as the reference's tool sets it up: aspect 1, no
    focus, 2 bounces on geodesics with the Renderer's ``geo``."""
    from bendy_tpu_torch import Config, Renderer, load_scene

    opts = FIDELITY_SCENES[name]
    scene = load_scene(f"scenes/{name}.json.gz")
    cam_ref = scene.find_by_tag("camera")
    cam = scene.get_object(cam_ref).inner
    cam.aspect_ratio = 1.0
    cam.focus = None  # defocus noise would swamp low-spp MSE
    geodesic = opts.get("geodesic", False)
    vstep = opts.get("volume_step")
    mb = 2 if geodesic else max_bounces
    okw = {"max_bounces": mb}
    if vstep is not None:
        okw["volume_step"] = vstep
    if geodesic:  # the trace configuration's GeoParams: set-up only, no render
        cfg = Config(max_bounces=mb)
        okw["geo"] = Renderer(scene, cfg, device="cpu").trace_config(cfg, cam_ref).geo
    return scene, cam_ref, okw, mb, vstep


def render_ours(scene, cam_ref, width, height, spp, max_bounces, seed=OURS_SEED,
                volume_step=None, device="cuda") -> np.ndarray:
    """The port's linear mean image [H, W, 3]: one pass of ``spp`` samples
    at 1x1 subpixels through the Renderer on ``device`` (the tracer and the
    accumulate kernel on a card), keyed ``render_key(seed, 0)``."""
    from bendy_tpu_torch import Config, DeviceFilm, Renderer, RenderConfig

    kw = {"max_bounces": max_bounces}
    if volume_step is not None:
        kw["volume_step"] = volume_step
    r = Renderer(scene, Config(**kw), device=device)
    film = DeviceFilm(width, height, device=r.device)
    r.render(cam_ref, RenderConfig(samples=spp), film, seed=seed)
    return film.synchronize().mean()


def points(scene, cam_ref, okw, res: int, spps, ref_spp: int, spot: bool,
           device="cuda") -> dict:
    """The entry's points at one resolution: the oracle at ``ref_spp``
    (seed 11), then the port at each of ``spps``; a spot point also
    carries ``corr`` and the oracle's own ``corr_noise_ceiling`` (seed 12
    at the same spp)."""
    from bendy_tpu_torch.native import oracle_render_scene

    t0 = time.time()
    ref = oracle_render_scene(scene, res, res, ref_spp, seed=REF_SEED, **okw)
    print(f"@{res}: oracle {ref_spp} spp in {time.time() - t0:.1f}s", file=sys.stderr)
    nonlight = ref.mean(-1) < LIGHT_PIXEL  # exclude direct-light pixels
    out = {}
    for spp in spps:
        img = render_ours(scene, cam_ref, res, res, spp, okw["max_bounces"],
                          volume_step=okw.get("volume_step"), device=device)
        diff = img - ref
        key = f"spot{res}_{spp}" if spot else str(spp)
        out[key] = {
            "mse": float((diff**2).mean()),
            "mse_nonlight": float((diff**2).mean(-1)[nonlight].mean()),
            "bias_nonlight": float(diff.mean(-1)[nonlight].mean()),
            "n_nonlight": int(nonlight.sum()),
        }
        if spot:  # structural check: correlation of fine features
            out[key]["corr"] = float(np.corrcoef(img.mean(-1).ravel(),
                                                 ref.mean(-1).ravel())[0, 1])
            # corr is noise-limited for near-uniform images: the yardstick is
            # an oracle render at the same spp against the reference
            ceil = oracle_render_scene(scene, res, res, spp, seed=CEILING_SEED, **okw)
            out[key]["corr_noise_ceiling"] = float(np.corrcoef(
                ceil.mean(-1).ravel(), ref.mean(-1).ravel())[0, 1])
        print(f"@{res} spp={spp}: {out[key]}", file=sys.stderr)
    return out


def scene_entry(name: str, args, device="cuda") -> dict:
    """One scene's entry at the settings of ``args`` (see :func:`parser`):
    the curve at ``args.res`` and the spot check at ``args.spot_res``."""
    opts = FIDELITY_SCENES[name]
    scene, cam_ref, okw, _, _ = prepare(name, args.max_bounces)
    ref_spp = opts.get("ref_spp", args.ref_spp_geodesic if opts.get("geodesic")
                       else args.ref_spp)
    spot_ref = min(ref_spp, opts.get("spot_ref_spp", args.spot_ref_spp))
    entry = points(scene, cam_ref, okw, args.res, opts.get("spp", args.spp), ref_spp, False,
                   device)
    entry.update(points(scene, cam_ref, okw, args.spot_res, [args.spot_spp], spot_ref, True,
                        device))
    return entry


def check_against(entry: dict, ref_entry: dict, scene: str) -> dict:
    """Hold one scene's entry to the same scene's ``docs/fidelity.json``
    entry, point by point, with the band of its class (flat or
    statistical, mass_cluster's bias one-sided; see the module's
    constants). Returns ``{"ok", "worst",
    "checks"}``: each check is (point, metric, value, table's value,
    ratio), the ratio being the deviation over the band's width, so that a
    check passes at ratio <= 1 and ``worst`` is the largest. A point the
    table lacks fails."""
    flat = scene in FLAT_SCENES
    checks = []

    def add(point, metric, ratio):
        checks.append((point, metric, entry[point][metric], ref_entry[point][metric], ratio))

    for point, got in entry.items():
        if point not in ref_entry:
            checks.append((point, "present", None, None, math.inf))
            continue
        want = ref_entry[point]
        if flat:
            for metric in ("mse", "mse_nonlight"):
                add(point, metric, abs(got[metric] - want[metric])
                    / (FLAT_REL * abs(want[metric])))
            add(point, "bias_nonlight", abs(got["bias_nonlight"] - want["bias_nonlight"])
                / (FLAT_BIAS_ABS + FLAT_REL * abs(want["bias_nonlight"])))
            if "corr" in want:
                add(point, "corr", abs(got["corr"] - want["corr"]) / FLAT_CORR)
        else:
            add(point, "mse_nonlight", got["mse_nonlight"] / (STAT_MSE_RATIO * want["mse_nonlight"]))
            se = math.sqrt(want["mse_nonlight"] / got["n_nonlight"])
            if scene in BIAS_NO_WORSE:
                off = abs(got["bias_nonlight"]) - abs(want["bias_nonlight"])
            else:
                off = abs(got["bias_nonlight"] - want["bias_nonlight"])
            add(point, "bias_nonlight", off / (STAT_SIGMAS * se))
            if "corr" in want:
                add(point, "corr", (want["corr"] - got["corr"]) / STAT_CORR_DROP)
    worst = max((c[4] for c in checks), default=math.inf)
    return {"ok": bool(checks) and worst <= 1.0, "worst": worst, "checks": checks}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=24)
    ap.add_argument("--spot-res", type=int, default=48,
                    help="higher-res structural spot check (fine features "
                    "like caustics/lensing rings are invisible at 24²)")
    ap.add_argument("--spot-spp", type=int, default=512)
    ap.add_argument("--spot-ref-spp", type=int, default=2048,
                    help="oracle spp for the spot check")
    ap.add_argument("--ref-spp", type=int, default=8192)
    ap.add_argument("--ref-spp-geodesic", type=int, default=2048)
    ap.add_argument("--spp", type=int, nargs="*", default=[16, 64, 256, 1024])
    ap.add_argument("--max-bounces", type=int, default=4)
    ap.add_argument("--out", default="docs/fidelity_torch.json")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--device", default="cuda", help="the port's render device")
    return ap


def main(argv=None) -> int:
    """Regenerate the table (``--scenes`` merges into an existing one)."""
    import os

    from bendy_tpu_torch.tools import provenance
    from bendy_tpu_torch.utils.device import resolve_device

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    names = args.scenes or list(FIDELITY_SCENES)
    out = {}
    for name in names:
        print(f"{name}:", file=sys.stderr)
        out[name] = scene_entry(name, args, device)
    meta = {**provenance(device), "seconds": time.time() - t0,
            "scenes": names, "argv": sys.argv[1:] if argv is None else list(argv)}
    if args.scenes and os.path.exists(args.out):
        with open(args.out) as f:
            merged = json.load(f)
        merged.update(out)
        out = merged
    out["_meta"] = meta
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
