"""What decides ``correct``: the kept passes against the plain reference.

After the window has closed, a sample of the kept passes, drawn from the
seed and always holding the latest, is recomputed by the frozen reference
(``benchmark/reference``) at every pixel, or at a sample of pixels drawn
from the seed where the cell's check file says so. The reference compiles
the scene again from the configuration's own file and builds the camera
from it; it takes nothing the program made.

A pass adds its sums into the film, so the program's film after the pass
is compared with the film before it plus the reference's sums, rounded to
f32 as the film's add rounds (the film before pass 0 of the window is
zero). The numbers:

- ``film_off``: the share of checked film channels (pixel × RGB) whose gap
  exceeds the per-lane tolerance ``ATOL + RTOL·|expected|`` (a NaN counts);
- ``rays_off``: |program's rays - reference's rays| over the reference's,
  summed over verified passes that cover the whole image.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path

import torch

from .reference import integrate, scene_io
from .traffic import Plan, plan as make_plan

RTOL, ATOL = 5e-4, 1e-5  # the port's per-lane tolerance against its plain version


@dataclass
class RefPass:
    """The reference's output for one kept pass."""

    pixels: torch.Tensor  # [P] int64 global pixel ids (CPU)
    sums: torch.Tensor  # [P, 3] f32 (CPU)
    counts: dict  # rays, near_steps, vol_events over those pixels
    full: bool  # every pixel of the image


def chosen(kept: list, n: int, seed: int) -> list:
    """``n`` kept passes: the latest, and others drawn from the seed."""
    if not kept:
        return []
    rest = kept[:-1]
    rng = random.Random(int(seed) ^ 0x5EED)
    return sorted(rng.sample(rest, min(n - 1, len(rest))) + [kept[-1]], key=lambda k: k.index)


def pixel_sample(plan: Plan, pixels, seed: int, index: int) -> torch.Tensor:
    """All pixel ids, or ``pixels`` of them drawn from the seed, sorted."""
    total = plan.width * plan.height
    if pixels == "all" or int(pixels) >= total:
        return torch.arange(total)
    g = torch.Generator().manual_seed((int(seed) * 1_000_003 + index) % (1 << 62))
    return torch.randperm(total, generator=g)[: int(pixels)].sort().values


class Reference:
    """The plain reference of one configuration, on ``device``, in the
    default float dtype at construction."""

    def __init__(self, scene_path: str, config: dict, plan: Plan, device) -> None:
        self.device = torch.device(device)
        self.plan = plan
        self.scene = scene_io.load_scene(scene_path)
        self.camera = self.scene.find_by_tag("camera")
        self.scene.get_object(self.camera).inner.aspect_ratio = plan.width / plan.height
        self.arrays = integrate.scene_arrays(self.scene, self.device)
        self.knobs = {k: v for k, v in config.items() if k != "output"}

    def run(self, kept, pixels: torch.Tensor) -> RefPass:
        plan = self.plan
        cam = integrate.camera_params(self.scene, self.camera, self.device)
        cfg = integrate.trace_config(self.scene, self.arrays, self.camera, **self.knobs)
        # the film's pass counter before pass ``index`` of the window is ``index``
        sums, counts = integrate.pass_sums(
            self.arrays, cam, cfg, kept.seed, kept.index,
            pixels.to(self.device), plan.width, plan.height, plan.spp, plan.subsample)
        full = pixels.numel() == plan.width * plan.height
        return RefPass(pixels, sums.float().cpu(), counts, full)


def compare(plan: Plan, kept: list, refs: list) -> dict:
    """The compared numbers of the kept passes ``kept`` against ``refs``."""
    off = n = 0
    rays_gap = rays_ref = 0
    for k, r in zip(kept, refs):
        before = k.before.float().cpu().reshape(-1, 3)[r.pixels]
        after = k.after.float().cpu().reshape(-1, 3)[r.pixels]
        expected = before + r.sums
        gap = (after - expected).abs()
        bad = ~(gap <= ATOL + RTOL * expected.abs())
        off += int(bad.sum())
        n += bad.numel()
        if r.full:
            rays_gap += abs(int(k.rays) - int(r.counts["rays"]))
            rays_ref += int(r.counts["rays"])
    out = {"film_off": off / max(n, 1)}
    if rays_ref:
        out["rays_off"] = rays_gap / rays_ref
    return out


def control_readings(cell, seeds, device, dtype=torch.bfloat16) -> list:
    """The compared numbers of the control, one dict a seed: the reference
    computed in ``dtype`` put in the program's place for the first pass of
    the cell's window (a zero film before it), judged against the reference
    in float32 at the same pixels."""
    from .drive import Kept

    out = []
    for seed in seeds:
        p = make_plan(cell.mix, seed)
        ref = Reference(str(cell.scene_path()), cell.config["render"], p, device)
        zero = torch.zeros(p.height, p.width, 3)
        k = Kept(0, p.pass_seed(0), zero, zero, torch.zeros(1, dtype=torch.int64),
                 torch.zeros(1, dtype=torch.int64))
        pixels = pixel_sample(p, cell.check["pixels"], seed, 0)
        r = ref.run(k, pixels)
        with integrate.default_dtype(dtype):
            low = Reference(str(cell.scene_path()), cell.config["render"], p, device)
            c = low.run(k, pixels)
        after = torch.zeros(p.height * p.width, 3)
        after[pixels] = c.sums
        k.after = after.view(p.height, p.width, 3)
        k.rays_after = torch.tensor([int(c.counts["rays"])])
        out.append(compare(p, [k], [r]))
    return out


def load_check(path: Path) -> dict:
    spec = json.loads(Path(path).read_text())
    for k in ("verify", "pixels", "limits"):
        if k not in spec:
            raise ValueError(f"{path}: no {k!r}")
    return spec
