"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
cells and metrics. Everything else is found by name:

- a configuration: its ``file`` (``benchmark/configs/<name>.json``), which
  names the scene file beside it;
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- a cell's check (which passes and pixels the reference recomputes, and
  the limit of each compared number): ``benchmark/checks/<cell>.json``;
- a metric: ``benchmark/metrics/<name>.py``, a reader with a function
  ``read(r)`` that returns the metric's value from a run's readings, or
  ``None`` where it finds nothing to read.

So a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits nothing here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    mix: dict
    check: dict
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1

    def scene_path(self) -> Path:
        return ROOT / self.config["scene"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list,
    else (a per-layer metric) every cell that reports what it moves, or (an
    end-to-end metric) every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    from .check import load_check
    from .traffic import load_mix

    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    e2e = [m for m in bench["end_to_end"] if applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], mix=load_mix(HERE / "traffic" / f"{w['traffic']}.json"),
                check=load_check(HERE / "checks" / f"{name}.json"), end_to_end=e2e, per_layer=per)


def reader(name: str):
    """The ``read`` function of metric ``name``'s reader file."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '_')}",
                                                  path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
