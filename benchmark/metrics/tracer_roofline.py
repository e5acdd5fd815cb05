"""The benchmark's frozen floor for one pass's work (benchmark/roofline.py,
with the reference's work counts) over the tracer and fold kernels' device
time per pass, in %. The floor is the larger of operations at the published
FP32 peak and bytes at the published HBM bandwidth of an H100 at 700 W."""

from benchmark import roofline

TRACER_KERNELS = ("trace", "fold")


def read(r):
    if r.trace is None or not r.window.passes or not r.refs:
        return None
    t = r.trace.kernel_s(TRACER_KERNELS) / r.window.passes
    if t <= 0:
        return None
    c = r.per_pass_counts()
    p = r.plan
    floor, _ = roofline.floor_s(r.scene, c["rays"], p.paths_per_pass,
                                p.width * p.height * p.subsample ** 2, c["near_steps"],
                                c["vol_events"])
    return 100.0 * floor / t
