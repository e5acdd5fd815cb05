"""Host time in each Renderer.render call less its launch glue (the
program's ``render`` span minus its ``glue.*`` children): the merged and
trace configs, the camera, the pass-cache key and lookup, the film's count.
The mean over the traced window's passes, in ms, from the program's own
spans (benchmark/program_spans.py); none where the program records none."""

from benchmark import program_spans


def read(r):
    ms = program_spans.host_ms(program_spans.recorded())
    return None if ms is None else ms[0]
