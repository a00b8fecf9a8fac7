"""The whole step's share of the chip's peak while training: three times
the forward operations of every network forward the step backpropagates
through (the generator; in GAN mode the discriminator's three forwards and
VGG19 on the SR), plus VGG19 on the ground truth once, counted from shapes
(``work/``); the backward's recomputation is not counted.  Over the traced
window's seconds and the peak of the cell's dtype."""

from benchmark.harness.peaks import PEAK_FLOPS
from benchmark.work.hitsir import forward_ops
from benchmark.work.nets import discriminator_ops, vgg_ops


def step_ops(cfg, traffic) -> float:
    b, lr = traffic["batch"], traffic["lr_size"]
    hr = lr * cfg["upscale"]
    ops = 3.0 * b * forward_ops(cfg, lr, lr)
    if "gan" in cfg:
        ops += 3.0 * 3.0 * b * discriminator_ops(hr, hr, cfg["gan"]["ndf"])
        ops += (3.0 + 1.0) * b * vgg_ops(hr, hr)
    return ops


def read(ctx):
    if ctx.trace is None:
        return None
    ops = ctx.window.steps * step_ops(ctx.cell.config, ctx.cell.traffic)
    return 100.0 * ops / ctx.window.seconds / PEAK_FLOPS[ctx.cell.traffic["dtype"]]
