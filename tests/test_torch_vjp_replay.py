"""The kernels' recomputed backward replayed as CUDA graphs, one per input
signature (``ops/kernels/autograd.py``), on the CPU.

- CPU tensors never reach a graph: the gradients are ``_plain_vjp``'s and
  no signature is remembered.
- The signature tells apart shapes, strides, dtypes, ``need`` masks,
  cotangent presence, non-tensor arguments and the TF32 and determinism
  settings, and is equal for equal calls.
- The dispatch, with a stand-in for the graph: a signature's first
  sighting runs eager, its second captures (its gradients the warm-up's),
  later ones replay, traced as ``sisr.recompute.<name>`` and
  ``sisr.replay.<name>``; a capture that raises leaves the signature eager
  for good with one warning; the least recently used signature is dropped
  first; ``drop_graphs`` forgets them all.

``tests/test_torch_vjp_graphs.py`` holds the real graphs to the eager
gradients on a card.
"""

import warnings
from collections import OrderedDict

import pytest
import torch

from sisr_tpu_torch.ops.kernels import autograd as ag
from sisr_tpu_torch.ops.kernels.autograd import KernelFunction
from sisr_tpu_torch.utils.precision import exact_mode

torch.set_num_threads(1)


def _plain(x, pair, w, act, scale):
    a, b = pair
    y = torch.tanh(x @ w) if act == "tanh" else torch.sin(x @ w)
    return y * scale + a * b, (x * a).sum(dim=-1)


PROBE = KernelFunction("probe", _plain, _plain)


def _args(seed=0, shape=(3, 4)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, requires_grad=True)
    a = torch.randn(shape, generator=g, requires_grad=True)
    b = torch.randn(shape, generator=g)
    w = torch.randn((shape[-1], shape[-1]), generator=g, requires_grad=True)
    return x, (a, b), w, "tanh", 0.5


def _grads(fn, args):
    out, red = fn(*args)
    x, (a, _), w = args[0], args[1], args[2]
    return torch.autograd.grad((out.square().sum() + red.sum()), (x, a, w))


@pytest.fixture
def fresh(monkeypatch):
    """Empty bookkeeping, restored afterwards."""
    monkeypatch.setattr(ag, "_signatures", OrderedDict())
    monkeypatch.setattr(ag, "_failed", set())


def test_cpu_tensors_attempt_no_graph(monkeypatch, fresh):
    class NoGraph:
        def __init__(self, *a):
            raise AssertionError("a graph was attempted for CPU tensors")

    monkeypatch.setattr(ag, "_VjpGraph", NoGraph)
    args = _args()
    want = _grads(_plain, args)
    for _ in range(3):
        got = _grads(PROBE, args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert not ag._signatures and not ag._failed
    leaves = []
    spec = ag._flatten(args, leaves)
    grads = (torch.ones(3, 4), torch.ones(3))
    assert ag._signature(PROBE, spec, leaves, (True,) * 4, grads) is None
    # what the backward returns equals _plain_vjp's on the same leaves
    need = (True, True, False, True)
    direct = ag._plain_vjp(_plain, spec, leaves, need, grads)
    via = ag._recompute(PROBE, spec, leaves, need, grads)
    assert [d is None for d in direct] == [v is None for v in via] == [False, False, True, False]
    assert all(torch.equal(d, v) for d, v in zip(direct, via) if d is not None)


def _key(args, need=(True, True, False, True), grads=None, fn=PROBE):
    leaves = []
    spec = ag._flatten(args, leaves)
    if grads is None:
        grads = (torch.ones(3, 4), torch.ones(3))
    return ag._key(fn, spec, leaves, need, grads)


def test_signature_separates_what_changes_the_recompute(monkeypatch):
    x, pair, w, act, scale = _args()
    base = _key((x, pair, w, act, scale))
    assert base is not None and hash(base) == hash(_key(_args(seed=1)))
    assert base == _key(_args(seed=1))                  # values do not count
    variants = {
        "shape": _key(_args(shape=(5, 4)), grads=(torch.ones(5, 4), torch.ones(5))),
        "stride": _key((x.t().contiguous().t(), pair, w, act, scale)),
        "dtype": _key((x.double(), pair, w, act, scale)),
        "need": _key((x, pair, w, act, scale), need=(True, False, False, True)),
        "cotangent": _key((x, pair, w, act, scale), grads=(torch.ones(3, 4), None)),
        "cotangent dtype": _key((x, pair, w, act, scale),
                                grads=(torch.ones(3, 4), torch.ones(3, dtype=torch.float64))),
        "activation": _key((x, pair, w, "sin", scale)),
        "scale": _key((x, pair, w, act, 0.25)),
        "None": _key((x, (pair[0], None), w, act, scale)),
        "nesting": _key((x, list(pair), w, act, scale)),
        "kernel": _key((x, pair, w, act, scale), fn=KernelFunction("other", _plain, _plain)),
    }
    with exact_mode():                  # TF32 off: other cuBLAS and cuDNN kernels
        variants["precision"] = _key((x, pair, w, act, scale))
    with monkeypatch.context() as m:
        m.setattr(torch.backends.cudnn, "deterministic", not torch.backends.cudnn.deterministic)
        variants["cudnn deterministic"] = _key((x, pair, w, act, scale))
    assert all(v is not None for v in variants.values())
    assert len(set(variants.values()) | {base}) == len(variants) + 1
    # a tensor's place counts, not what it holds: a leaf's stride is its own
    assert _key((x, pair, w, act, scale)) == base
    assert _key((x, pair, w, act, [1, 2])) is not None
    assert _key((x, pair, w, act, {"unhashable": 1})) is None


class FakeGraph:
    """Stands in for ``_VjpGraph``: records its captures, replays eagerly;
    ``first`` is the capturing call's gradients, as the warm-up's are."""
    made = []

    def __init__(self, plain, spec, leaves, need, grads):
        self.plain, self.spec, self.need = plain, spec, need
        FakeGraph.made.append(tuple(t.shape for t in leaves))
        self.first = ag._plain_vjp(plain, spec, leaves, need, grads)

    def replay(self, leaves, grads):
        return ag._plain_vjp(self.plain, self.spec, leaves, self.need, grads)


def _counts(prof):
    return {e.key: e.count for e in prof.key_averages() if e.key.startswith("sisr.")}


def test_dispatch_eager_then_capture_then_replay(monkeypatch, fresh):
    monkeypatch.setattr(ag, "_signature", ag._key)
    monkeypatch.setattr(ag, "_VjpGraph", FakeGraph)
    FakeGraph.made = []
    args = _args()
    want = _grads(_plain, args)
    seen = []
    for _ in range(4):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = _grads(PROBE, args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        c = _counts(prof)
        seen.append((c.get("sisr.recompute.probe", 0), c.get("sisr.replay.probe", 0)))
        assert c["sisr.vjp.probe"] == 1
    # first sighting eager, second captured (inside the recompute span)
    assert seen == [(1, 0), (1, 0), (0, 1), (0, 1)]
    assert FakeGraph.made == [((3, 4), (3, 4), (3, 4), (4, 4))]
    # another shape captures anew, on its own second sighting
    other = _args(shape=(2, 4))
    for _ in range(2):
        _grads(PROBE, other)
    assert len(FakeGraph.made) == 2 and len(ag._signatures) == 2


def test_failed_capture_stays_eager_and_warns_once(monkeypatch, fresh):
    class Refused:
        def __init__(self, *a):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(ag, "_signature", ag._key)
    monkeypatch.setattr(ag, "_VjpGraph", Refused)
    args = _args()
    want = _grads(_plain, args)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(5):
            got = _grads(PROBE, args)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    said = [str(w.message) for w in caught if "CUDA graph" in str(w.message)]
    assert len(said) == 1 and "probe" in said[0] and "not permitted" in said[0]
    assert len(ag._failed) == 1 and not ag._signatures


def test_least_recently_used_signature_is_dropped_first(monkeypatch, fresh):
    monkeypatch.setattr(ag, "MAX_SIGNATURES", 3)
    assert ag._sighting("a") is None and ag._sighting("b") is None
    assert ag._sighting("a") is ag._SEEN        # a is now the most recent
    assert ag._sighting("c") is None and ag._sighting("d") is None
    assert list(ag._signatures) == ["a", "c", "d"]
    ag._signatures["a"] = graph = object()
    assert ag._sighting("a") is graph
    ag._failed.add("e")
    assert ag._sighting("e") is None and "e" not in ag._signatures


def test_drop_graphs_forgets_every_signature(monkeypatch, fresh):
    real = ag._VjpGraph
    monkeypatch.setattr(ag, "_signature", ag._key)
    monkeypatch.setattr(ag, "_VjpGraph", FakeGraph)
    FakeGraph.made = []
    args = _args()
    for _ in range(3):
        _grads(PROBE, args)
    ag._failed.add("refused")
    assert len(FakeGraph.made) == 1 and ag._signatures
    monkeypatch.setattr(ag, "_VjpGraph", real)     # no card to wait for
    ag.drop_graphs()
    monkeypatch.setattr(ag, "_VjpGraph", FakeGraph)
    assert not ag._signatures and not ag._failed
    for _ in range(2):       # seen anew: eager, then captured again
        _grads(PROBE, args)
    assert len(FakeGraph.made) == 2
