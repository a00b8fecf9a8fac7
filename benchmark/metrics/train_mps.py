"""LR megapixels of every training step completed in the window (batch x
LR crop pixels a step), over the window's seconds (host clock)."""


def read(ctx):
    return ctx.window.lr_pixels / ctx.window.seconds / 1e6
