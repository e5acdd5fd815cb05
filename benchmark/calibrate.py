"""Readings that the limits of ``correct`` are set from (card only).

    python3 -m benchmark.calibrate --workload <cell> --seeds <n ...> [--control-seeds <n ...>]
        [--seconds <s>]

For each seed it runs the cell as ``benchmark.run`` does, with a short
window at the cell's own load and every compared number unlimited, and
prints the numbers the program reads; then, for each control seed, the
numbers the control reads: the reference in bfloat16 put in the program's
place at the cell's own size (``check.control_readings``). One JSON line
each, in one process, so the kernels are built once. The limit of a number
goes between the largest the program reads and the smallest the control
reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from . import check, run, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    names = ("film_off", "rays_off")
    open_cell = dataclasses.replace(
        cell, check=dict(cell.check, limits={k: math.inf for k in names}))
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, lines = run.run_cell(open_cell, seed, args.seconds, False, "cuda:0", t0)
        print(json.dumps({"workload": cell.name, "side": "program", "seed": seed,
                          "numbers": {k: c["value"] for k, c in result["checks"].items()},
                          "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                          "passes": result["attempted"], "lines": lines}), flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        numbers = check.control_readings(cell, [seed], "cuda:0")[0]
        print(json.dumps({"workload": cell.name, "side": "control", "seed": seed,
                          "numbers": numbers, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
