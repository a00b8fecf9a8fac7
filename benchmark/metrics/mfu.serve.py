"""The whole model's share of the chip's peak while serving: the
operations of one whole forward of each request's LR image (counted from
its shape by ``work/hitsir.py``; tile overlap and padding are not work),
over the traced window's seconds and the peak of the cell's dtype."""

from benchmark.harness.peaks import PEAK_FLOPS
from benchmark.work.hitsir import forward_ops


def read(ctx):
    if ctx.trace is None:
        return None
    ops = sum(forward_ops(ctx.cell.config, h, w) for h, w in ctx.window.sizes)
    return 100.0 * ops / ctx.window.seconds / PEAK_FLOPS[ctx.cell.traffic["dtype"]]
