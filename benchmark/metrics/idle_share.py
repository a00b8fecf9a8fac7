"""Share of the traced window in which no operation ran on the device:
1 - (union of the device events' intervals) / (the window's length)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window.seconds)
