"""Host time in the render pass's tracer call and accumulate call (the
program's ``glue.trace`` and ``glue.accumulate`` spans: argument checks,
the ctypes launches and folds), the mean over the traced window's passes,
in ms, from the program's own spans (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(r):
    ms = program_spans.host_ms(program_spans.recorded())
    return None if ms is None else ms[1]
