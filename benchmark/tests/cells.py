"""The cells the tests drive: those of BENCHMARK.json."""

from benchmark import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def cell(name):
    return spec.cell(name, BENCH)
