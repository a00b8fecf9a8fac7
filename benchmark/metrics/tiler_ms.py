"""Host milliseconds per request in ``TiledSR``'s own work: the self time of
the program's ``sisr.tiler`` spans (pad, tile plan, weight map and its copy
to the device, canvas, blend, crop), less their ``sisr.tiler.model``
children (the model's calls), from the traced window.  None where the
program has no such span."""

from benchmark.harness.program_spans import self_time


def read(ctx):
    if ctx.trace is None or not ctx.window.count:
        return None
    seconds, count = self_time(ctx.trace, "sisr.tiler")
    if not count:
        return None
    return seconds / ctx.window.count * 1e3
