"""Host milliseconds per step in the program's ``sisr.step.forward`` spans:
the generator's forward and its losses (in GAN mode with the VGG19 and
discriminator forwards of the generator's loss), up to ``backward()``,
from the traced window.  None where the program has no such span."""

from benchmark.harness.program_spans import duration


def read(ctx):
    if ctx.trace is None or not ctx.window.steps:
        return None
    seconds, count = duration(ctx.trace, "sisr.step.forward")
    if not count:
        return None
    return seconds / ctx.window.steps * 1e3
