"""``forward_replay_share.photos``: the share of the tiles' model forwards
that ran as a replayed CUDA graph (``sisr.forward.replay`` spans) against
those run eager (``sisr.forward.eager``), on hand-built traces."""

import pytest

from benchmark.harness.spec import load_module
from benchmark.harness.trace import Trace

MS = 1_000_000     # ns
DEVICE = [("k", 0, 4 * MS, True)]
NAME = "forward_replay_share.photos"


class _Ctx:
    def __init__(self, trace):
        self.trace = trace


def _trace(*inner):
    """One request whose tiles each hold one forward span."""
    host = [("sisr.tiler", 0, 100 * MS, 1)]
    for k, name in enumerate(inner):
        s = 10 * MS + 20 * MS * k
        host += [("sisr.tiler.model", s, s + 15 * MS, 1), (name, s + MS, s + 14 * MS, 1)]
    return Trace(DEVICE, host)


@pytest.mark.parametrize("inner,want", [
    (("sisr.forward.replay",) * 4, 100.0),
    (("sisr.forward.eager", "sisr.forward.eager", "sisr.forward.replay",
      "sisr.forward.replay"), 50.0),
    (("sisr.forward.eager",), 0.0),
    ((), None),
])
def test_share_of_replays(inner, want):
    got = load_module("metrics", NAME).read(_Ctx(_trace(*inner)))
    assert got == (None if want is None else pytest.approx(want))


def test_no_trace_reads_none():
    assert load_module("metrics", NAME).read(_Ctx(None)) is None
