"""LR megapixels of every request completed in the window, over the
window's seconds (host clock)."""


def read(ctx):
    return ctx.window.lr_pixels / ctx.window.seconds / 1e6
