"""DAT's share of the chip's peak while serving frames: the operations of
one whole forward of each request's LR frame (counted from its shape by
``work/dat.py``; window padding is not work), over the traced window's
seconds and the peak of the cell's dtype."""

from benchmark.harness.peaks import PEAK_FLOPS
from benchmark.work.dat import forward_ops


def read(ctx):
    if ctx.trace is None:
        return None
    ops = sum(forward_ops(ctx.cell.config, h, w) for h, w in ctx.window.sizes)
    return 100.0 * ops / ctx.window.seconds / PEAK_FLOPS[ctx.cell.traffic["dtype"]]
