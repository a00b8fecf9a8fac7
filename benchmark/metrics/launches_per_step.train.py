"""CUDA kernels that ran on the device in the traced window (copies and
sets not counted), per training step."""


def read(ctx):
    if ctx.trace is None or not ctx.window.steps:
        return None
    return ctx.trace.kernels() / ctx.window.steps
