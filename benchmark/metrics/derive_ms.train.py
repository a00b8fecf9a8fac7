"""Host milliseconds per step making derived weights and weight packs anew:
the time in which a ``sisr.derive.*`` span is open (``_derived``'s
``make()`` under grad or on a miss, a kernel's weight pack on a miss),
from the traced window.  None where no such span ran."""

from benchmark.harness.program_spans import covered


def read(ctx):
    if ctx.trace is None or not ctx.window.steps:
        return None
    seconds, count = covered(ctx.trace, "sisr.derive.")
    if not count:
        return None
    return seconds / ctx.window.steps * 1e3
