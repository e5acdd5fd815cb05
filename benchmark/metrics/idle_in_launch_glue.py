"""The share of the traced window, in %, spent in device idle gaps that
begin while the host is in the render pass's tracer or accumulate call
(the program's ``glue.*`` spans), placed pass by pass inside the
benchmark's ``bench.render`` ranges (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(r):
    split = program_spans.idle_split(r.trace, program_spans.recorded())
    return None if split is None else split["launch glue"]
