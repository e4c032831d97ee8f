"""device_idle_pct: the share of the profiled part of the window in which no
device operation ran, from the union of their intervals (profile.py)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return tr.idle_pct
