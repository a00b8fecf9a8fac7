"""Pixels of every model input (counted by the benchmark's pre-hook on the
model) over the pixels of the requests: the work the tiler adds by its
overlap and by padding small images up to a tile."""


def read(ctx):
    if ctx.trace is None or not ctx.window.lr_pixels:
        return None
    px = sum(b * h * w for b, h, w, stage in ctx.entry.spans.model_calls if stage != "head")
    return px / ctx.window.lr_pixels
