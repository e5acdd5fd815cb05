"""From the benchmark's first line to the first timed pass: imports, the
CUDA context, the scene's load and compile, and the two warm-up passes,
which load or build the kernel library. The standard error's timing line
splits it into these parts."""


def read(r):
    return r.setup_s
