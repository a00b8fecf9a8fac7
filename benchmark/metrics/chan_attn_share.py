"""The channel attention's sums' share of the device's busy time: the
device seconds of the kernels whose name holds ``PATTERN`` over the union
of the device events in the traced window.  None when no such kernel ran."""

PATTERN = "::chan_attn_"


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.device_seconds(PATTERN)
    busy = ctx.trace.busy_s()
    if device_s <= 0.0 or busy <= 0.0:
        return None
    return 100.0 * device_s / busy
