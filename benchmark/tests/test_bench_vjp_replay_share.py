"""``vjp_replay_share.train``: the share of the kernels' plain recomputes
that ran as a replayed CUDA graph (``sisr.replay.*`` spans) against those
run eager (``sisr.recompute.*``), on hand-built traces."""

import pytest

from benchmark.harness.spec import load_module
from benchmark.harness.trace import Trace

MS = 1_000_000     # ns
DEVICE = [("k", 0, 4 * MS, True)]


class _Window:
    seconds, count, steps = 1.0, 2, 2


class _Ctx:
    def __init__(self, trace):
        self.trace, self.window = trace, _Window()


def _trace(*inner):
    """Two vjp spans on the engine's thread, each holding one inner span."""
    host = [("bench.step", 0, 100 * MS, 1)]
    for k, name in enumerate(inner):
        s = 10 * MS + 40 * MS * k
        host += [("sisr.vjp.scc_block", s, s + 30 * MS, 2), (name, s + MS, s + 29 * MS, 2)]
    return Trace(DEVICE, host)


@pytest.mark.parametrize("name", ["vjp_replay_share.train.psnr", "vjp_replay_share.train.gan"])
@pytest.mark.parametrize("inner,want", [
    (("sisr.replay.scc_block", "sisr.replay.htb_tail"), 100.0),
    (("sisr.replay.scc_block", "sisr.recompute.htb_tail"), 50.0),
    (("sisr.recompute.scc_block", "sisr.recompute.htb_tail"), 0.0),
    ((), None),
])
def test_share_of_replays(name, inner, want):
    got = load_module("metrics", name).read(_Ctx(_trace(*inner)))
    assert got == (None if want is None else pytest.approx(want))


def test_no_trace_reads_none():
    assert load_module("metrics", "vjp_replay_share.train.psnr").read(_Ctx(None)) is None
