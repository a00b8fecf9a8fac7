"""Share of the model forwards run under the tiler's switch in the traced
window that ran as a replayed CUDA graph: 100 x the ``sisr.forward.replay``
spans over those and the ``sisr.forward.eager`` spans (a signature's first
sighting, its capture or a fallback), each opened inside
``sisr.tiler.model``.  None where neither span ran (a program without
them)."""

from benchmark.harness.program_spans import duration


def read(ctx):
    if ctx.trace is None:
        return None
    _, replays = duration(ctx.trace, "sisr.forward.replay")
    _, eager = duration(ctx.trace, "sisr.forward.eager")
    if not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
