"""Mean host microseconds of a hand-written kernel's Python wrapper (checks,
casts, buffers, the launch): the self time of the program's
``sisr.kernel.*`` spans (less any kernel wrapper nested in them: the Fusion
gate's calls the pools'), over their count, from the traced window.  None
where no such span ran."""

from benchmark.harness.program_spans import self_time


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, count = self_time(ctx.trace, "sisr.kernel.")
    if not count:
        return None
    return seconds / count * 1e6
