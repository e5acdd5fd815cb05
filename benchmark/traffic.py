"""The one traffic generator: a mix's parameters and a seed give a plan.

A mix is a JSON file under ``benchmark/traffic/`` with these keys:

- ``width``, ``height``, ``subsample`` (n for an n×n grid), ``spp`` (samples
  a pass): each pass renders W·H·n²·spp camera paths into one film;
- ``inflight``: the most passes queued on the device at once.

Passes are chained into one film and the window ends with a synchronize.
The loop is closed: one user, the next pass issued when the oldest of the
``inflight`` queued passes has finished. Pass ``p`` of the window renders
with the seed ``seed + p``. The passes whose output the check keeps are one
drawn from the seed in each stratum [2^j - 1, 2^(j+1) - 1) of pass indices,
so pass 0, and passes late in any window, are among them.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path

KEPT_STRATA = 40  # strata of kept passes: indices up to 2^40


@dataclass(frozen=True)
class Plan:
    width: int
    height: int
    subsample: int
    spp: int
    inflight: int
    seed: int
    kept: frozenset

    @property
    def paths_per_pass(self) -> int:
        """Camera paths of one pass: W·H·n²·spp."""
        return self.width * self.height * self.subsample ** 2 * self.spp

    def pass_seed(self, p: int) -> int:
        return self.seed + p


def load_mix(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    for k in ("width", "height", "subsample", "spp"):
        if not isinstance(mix.get(k), int) or mix[k] < 1:
            raise ValueError(f"{path}: {k} must be a positive integer")
    return mix


def plan(mix: dict, seed: int) -> Plan:
    rng = random.Random(int(seed))
    kept = frozenset(rng.randrange(2 ** j - 1, 2 ** (j + 1) - 1) for j in range(KEPT_STRATA))
    return Plan(width=mix["width"], height=mix["height"], subsample=mix["subsample"],
                spp=mix["spp"], inflight=int(mix.get("inflight", 2)), seed=int(seed),
                kept=kept)
