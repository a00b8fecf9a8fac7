"""Share of the traced window the runner spent waiting for its next train
batch: 100 x the summed ``sisr.loader.wait`` spans (the interval the
runner's ``train_wait_s`` times: the host loader's workers, the device
prefetch, an epoch's restart of the loader) over the window's seconds.
None where the program opens no such span."""

from benchmark.harness.program_spans import duration


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, count = duration(ctx.trace, "sisr.loader.wait")
    if not count:
        return None
    return 100.0 * seconds / ctx.window.seconds
