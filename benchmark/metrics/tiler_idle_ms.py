"""Device-idle milliseconds per request spent in ``TiledSR``'s own work: the
idle gaps of the traced window whose middle falls in the self time of a
``sisr.tiler`` span (outside its ``sisr.tiler.model`` children), the rule
the breakdown labels gaps by.  None where the program has no such span or
no device event ran."""

from benchmark.harness.program_spans import idle_in_self


def read(ctx):
    if ctx.trace is None or not ctx.window.count or not ctx.trace.device:
        return None
    seconds, count = idle_in_self(ctx.trace, "sisr.tiler")
    if not count:
        return None
    return seconds / ctx.window.count * 1e3
