"""Host milliseconds per step in the program's ``sisr.step.backward`` spans:
the generator loss's ``backward()`` call, through which the calling thread
waits for the autograd engine's whole run, from the traced window.  None
where the program has no such span."""

from benchmark.harness.program_spans import duration


def read(ctx):
    if ctx.trace is None or not ctx.window.steps:
        return None
    seconds, count = duration(ctx.trace, "sisr.step.backward")
    if not count:
        return None
    return seconds / ctx.window.steps * 1e3
