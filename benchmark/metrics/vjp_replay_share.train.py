"""Share of the kernels' plain recomputes in the traced window that ran as
a replayed CUDA graph: 100 x the ``sisr.replay.*`` spans over those and the
``sisr.recompute.*`` spans (an eager recompute: a signature's first
sighting, its capture or a fallback), each opened inside a
``sisr.vjp.<kernel>`` span.  None where neither span ran (a program
without them)."""

from benchmark.harness.program_spans import duration


def read(ctx):
    if ctx.trace is None:
        return None
    _, replays = duration(ctx.trace, "sisr.replay.")
    _, eager = duration(ctx.trace, "sisr.recompute.")
    if not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
