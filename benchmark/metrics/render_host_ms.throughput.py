"""Host time inside each Renderer.render call of a chained window, the mean
over passes, in ms (the traced run)."""


def read(r):
    s = r.window.render_s
    if not s:
        return None
    return sum(s) / len(s) * 1e3
