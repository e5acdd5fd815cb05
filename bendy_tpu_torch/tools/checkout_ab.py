"""Time chip_smoke.py's main paths, or a tool, in several checkouts on one card.

    python3 -m bendy_tpu_torch.tools.checkout_ab --phases 5,6,7,8 \\
        [--output normal] [--scene scene] [--set SPLIT_BUDGET_BYTES=1073741824] \\
        [--out smoke_out/ab] DIR [DIR ...]
    python3 -m bendy_tpu_torch.tools.checkout_ab \\
        --module bendy_tpu_torch.tools.mxu_shape_probe --args="--ns 1024,2048" DIR [DIR ...]

Each DIR is the root of a checkout that holds ``chip_smoke.py`` (the
parent unpacked with ``git archive`` into a git-ignored directory, this
tree as ``.``). All are built first, at once; then each DIR, in the order
given (a DIR named twice runs twice: parent, A, B, B, A, parent), runs in
a process of its own from its own root: chip_smoke's phase-2 ptxas lines,
then ``main_path`` (in FULL output only: its film check reads radiance),
three times the host ms and the wall of 4 chained ``Renderer.render``
calls (the host time before one synchronize, and the wall with it, over
4; through the Renderer API alone, so every checkout is timed by the same
code), the digest of that film and its rays (seeds 0-2, so that checkouts
compare bit for bit) and ``kernel_alone_and_passes`` of each phase asked
for (its kernel and plain passes at no more than 4 spp), with the scene's
``Output`` from ``--output``, the phase's scene replaced by ``--scene``
(scenes/NAME.json.gz at the phase's size and Config) and module settings
of ``ops/trace_kernel`` from ``--set``. With ``--module`` each run is ``python3 -m MODULE ARGS``
instead, and each entry of the JSON line it prints last that has an
``ms`` is printed (its ms, share of peak, SM clock and ``library_ms``).
Each run's output goes to ``OUT/<index>_<dir>.txt``; the kernel-alone
lines, the main-path lines, the host-time lines and the film digests are
printed. Needs one
card; a run that fails stops the rest.
"""

from __future__ import annotations

import argparse
import json
import shlex
import subprocess
import sys
import time
from pathlib import Path

RUN = """
import hashlib, os, sys, time, torch
import chip_smoke as c
from bendy_tpu_torch import Config, DeviceFilm, Output, RenderConfig, Subsample, _build
from bendy_tpu_torch.ops import trace_kernel
phases, output, settings, scene = {phases!r}, {output!r}, {settings!r}, {scene!r}
dev = torch.device("cuda", 0)
_build.build()
print("phase 2: ptxas: " + " | ".join(c.ptxas_report(_build.build_log())))
for k, v in settings.items():
    setattr(trace_kernel, k, v)
for (phase, name, kw, W, H, spp, n, wrapper, pass_spp, rows, _) in c.MAIN_PATHS:
    if phase in phases:
        name = scene or name
        launch = getattr(trace_kernel, wrapper)
        config = Config(**kw, output=Output(output))
        if output == "full":
            path = c.main_path(phase, name, config, W, H, spp, n, dev, launch)
            rc, film = RenderConfig(samples=spp, subsample=Subsample(n)), DeviceFilm(W, H, device=dev)
            rays0 = path["r"].rays_traced
            for rep in range(3):  # the Renderer API alone, so every checkout is timed alike
                path["r"].render(path["cam"], rc, film, seed=rep)
                film.synchronize()
                t0 = time.perf_counter()
                for _ in range(4):
                    path["r"].render(path["cam"], rc, film, seed=rep)
                host = time.perf_counter() - t0
                film.synchronize()
                wall = time.perf_counter() - t0
                print(f"phase {{phase}}: {{name}} host ms per pass {{host / 4 * 1e3:.3f}}, pass "
                      f"wall {{wall / 4 * 1e3:.3f}} ms (4 render calls, then one synchronize)")
            digest = hashlib.sha256(film.sum.cpu().numpy().tobytes()).hexdigest()[:16]
            rays = path["r"].rays_traced - rays0
            print(f"phase {{phase}}: {{name}} film digest {{digest}}, {{rays}} rays "
                  f"({{film.passes}} passes at seeds 0-2)")
        else:  # main_path's film check reads radiance: the kernel alone only
            r, cam = c.renderer(name, config, W, H, dev)
            r.camera_params(cam)
            path = dict(r=r, cam=cam, seed=int.from_bytes(os.urandom(4), "little"))
        c.kernel_alone_and_passes(phase, path, W, H, spp, n, min(pass_spp, 4), rows, launch, dev)
"""
BUILD = "from bendy_tpu_torch import _build; print(_build.build())"
TIMEOUT_S = 900


def setting(text: str) -> tuple[str, int]:
    key, _, value = text.partition("=")
    return key, int(value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--phases", type=lambda t: {int(p) for p in t.split(",")})
    what.add_argument("--module", help="run python3 -m MODULE ARGS in each DIR instead")
    ap.add_argument("--args", default="", help="the module's arguments, one string")
    ap.add_argument("--output", default="full")
    ap.add_argument("--scene", default=None)
    ap.add_argument("--set", dest="settings", action="append", type=setting, default=[])
    ap.add_argument("--out", type=Path, default=Path("smoke_out/ab"))
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    dirs = [d.resolve() for d in args.dirs]
    builds = {d: subprocess.Popen([sys.executable, "-c", BUILD], cwd=d, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for d in dict.fromkeys(dirs)}
    try:
        for d, proc in builds.items():
            log = proc.communicate(timeout=TIMEOUT_S)[0]
            print(f"built {d}: {log.strip().splitlines()[-1] if log.strip() else ''}", flush=True)
            if proc.returncode:
                print(log)
                return 1
    finally:
        for proc in builds.values():
            if proc.poll() is None:
                proc.kill()
    if args.module:
        cmd = [sys.executable, "-m", args.module, *shlex.split(args.args)]
    else:
        cmd = [sys.executable, "-c", RUN.format(phases=sorted(args.phases), output=args.output,
                                                settings=dict(args.settings), scene=args.scene)]
    for i, (d, name) in enumerate(zip(dirs, args.dirs), 1):
        t0 = time.perf_counter()
        label = name.name or "this"
        proc = subprocess.run(cmd, cwd=d, capture_output=True, text=True, timeout=TIMEOUT_S)
        text = proc.stdout + proc.stderr
        (args.out / f"{i}_{label}.txt").write_text(text)
        print(f"run {i} {label} ({time.perf_counter() - t0:.0f} s, exit {proc.returncode}):",
              flush=True)
        for ln in text.splitlines():
            if any(k in ln for k in ("alone median", "FAIL", "main path", "host ms per pass",
                                     "film digest")):
                print(f"  {ln}", flush=True)
        if args.module and proc.returncode == 0:
            for key, m in json.loads(proc.stdout.strip().splitlines()[-1]).items():
                if isinstance(m, dict) and "ms" in m:
                    print(f"  {key}: {m['ms']:.3f} ms at {m.get('iters')} iters, share "
                          f"{m.get('share_of_peak')}, SM clock {m.get('sm_clock')}, library "
                          f"{m.get('library_ms')} ms", flush=True)
        if proc.returncode:
            print(text[-4000:])
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
