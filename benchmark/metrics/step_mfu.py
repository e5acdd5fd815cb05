"""The whole window's share of the card's FP32 peak: the frozen count of
operations of every pass in the window (benchmark/roofline.py, with the
reference's work counts) over 67e12 FLOP/s times the traced window's
length, in %. A kernel taken off the path leaves its roofline silent; this
share still bounds what the whole step does."""

from benchmark import roofline


def read(r):
    if r.trace is None or not r.window.passes or not r.refs or r.trace.window_s <= 0:
        return None
    c = r.per_pass_counts()
    ops = roofline.pass_ops(r.scene, c["rays"], r.plan.paths_per_pass, c["near_steps"],
                            c["vol_events"])
    return 100.0 * ops * r.window.passes / (roofline.PEAK_F32_S * r.trace.window_s)
