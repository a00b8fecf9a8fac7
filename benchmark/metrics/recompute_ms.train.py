"""Host milliseconds per step in the kernels' backward through
``KernelFunction``: the time in which a ``sisr.vjp.*`` span is open (the
plain forward recomputed under autograd and differentiated, or a kernel's
own vjp), on the autograd engine's thread; a vjp nested in another's is
counted once.  From the traced window; None where no such span ran."""

from benchmark.harness.program_spans import covered


def read(ctx):
    if ctx.trace is None or not ctx.window.steps:
        return None
    seconds, count = covered(ctx.trace, "sisr.vjp.")
    if not count:
        return None
    return seconds / ctx.window.steps * 1e3
