"""The program's kernel library load and pass builds over the process
(its ``kernel.library`` span: the CUDA sources' hash, an nvcc build where
none exists, the library's load and signatures; and every ``pass.build``:
the render pass, the tracer's table, a row chunk's lanes), in s: the part
of the warm-up that is not the two passes' own work."""

from benchmark import program_spans


def read(r):
    return program_spans.one_off_s(program_spans.recorded(), ("kernel.library", "pass.build"))
