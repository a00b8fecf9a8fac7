"""Mean milliseconds of one checkpoint written by the runner: the
``sisr.ckpt.save`` spans (``save_model_weights``: the model's and the
optimizer's state serialised to ``new_epoch_model.pth``) in the traced
window, summed over their count.  None where no such span ran."""

from benchmark.harness.program_spans import duration


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, count = duration(ctx.trace, "sisr.ckpt.save")
    if not count:
        return None
    return 1e3 * seconds / count
