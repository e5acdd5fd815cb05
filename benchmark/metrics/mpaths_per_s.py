"""Camera paths completed in the window over the window's wall time, in
millions a second. A path is one (pixel, subpixel, sample); the count is the
traffic's (passes × W·H·n²·spp), never a counter of the program."""


def read(r):
    if r.window.seconds <= 0:
        return None
    return r.window.passes * r.plan.paths_per_pass / r.window.seconds / 1e6
