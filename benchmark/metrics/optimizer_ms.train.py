"""Host milliseconds per step inside torch's own ``Optimizer.step#Adam.step``
ranges (both optimizers in GAN mode), from the traced window."""

PREFIX = "Optimizer.step#Adam.step"


def read(ctx):
    if ctx.trace is None or not ctx.window.steps:
        return None
    seconds, count = ctx.trace.host_seconds(PREFIX)
    if not count:
        return None
    return seconds / ctx.window.steps * 1e3
