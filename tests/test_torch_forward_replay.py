"""A model's forward replayed as a CUDA graph per input signature
(``ops/kernels/autograd.py::replayed_forward``), on the CPU.

- The switch ``replayed_forwards()`` is on exactly inside ``TiledSR``'s
  model calls (and its ``sharded_call``'s), and off in ``BandedHeadSR``, a
  whole-image call and a training step (a probe model records it).
- On the CPU a forward under the switch runs eager, remembers no
  signature, is traced as ``sisr.forward.eager``, and ``TiledSR``'s answer
  equals the answer with the switch off, bit for bit (HiTSIR and HAT).
- The signature tells apart the input's shape and dtype, the model's
  dtype, ``stage``, ``head_packed``, an in-place write to one parameter, a
  ``load_state_dict``, the plain versions' switch and the library settings;
  a shallow copy of the model has signatures of its own; identical calls
  have equal signatures; training (``deterministic=False``), grad mode and
  parameters made under inference_mode give none.
- The dispatch, with a stand-in for the graph (the forwards treated as if
  on a card): a signature's first sighting runs eager, its second
  captures, later ones replay, traced as ``sisr.forward.eager`` and
  ``sisr.forward.replay``; the model's forward pre-hook fires on every
  tile; a capture that raises leaves the signature eager for good with one
  warning; the least recently used signature is dropped first.

``tests/test_torch_forward_graphs.py`` holds the real graphs to the eager
forward on a card.
"""

import copy
import warnings
from collections import OrderedDict
from contextlib import nullcontext

import pytest
import torch
from torch import nn

from sisr_tpu_torch.ops.kernels import autograd as ag
from sisr_tpu_torch.ops.kernels.autograd import in_replayed_forwards, plain_versions
from sisr_tpu_torch.parallel import tiling
from sisr_tpu_torch.parallel.tiling import BandedHeadSR, TiledSR
from sisr_tpu_torch.utils.precision import exact_mode

torch.set_num_threads(1)

TINY = dict(is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
            is_fusion=True, embed_dim=24, depths=(2,), num_heads=(2,),
            base_win_size=(8, 8), mlp_ratio=2.0, upsampler="nearest+conv", upscale=4,
            hier_win_ratios=(0.5, 1))
HAT_TINY = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=4,
                squeeze_factor=6)


@pytest.fixture
def fresh(monkeypatch):
    """Empty bookkeeping, restored afterwards."""
    monkeypatch.setattr(ag, "_signatures", OrderedDict())
    monkeypatch.setattr(ag, "_failed", set())


def _hitsir(seed=0, **kw):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    torch.manual_seed(seed)
    return HiTSIR(**{**TINY, **kw}).eval()


def _hat(seed=3):
    from sisr_tpu_torch.infer import synth_weights
    from sisr_tpu_torch.models.hat import HAT

    model = HAT(**HAT_TINY)
    synth_weights(model, seed)
    return model.eval()


def _image(h, w, seed=1):
    return torch.rand((h, w, 3), generator=torch.Generator().manual_seed(seed))


class Probe(nn.Module):
    """Records whether each call ran inside ``replayed_forwards()``; a
    nearest x4 upsample with ``stage`` 'features' (the input) and 'head'."""

    upscale, head_packed = 4, False

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(()))
        self.seen = []

    def forward(self, x, stage="full", deterministic=True, generator=None):
        self.seen.append((stage, in_replayed_forwards()))
        if stage == "features":
            return x * self.w
        return (x * self.w).repeat_interleave(4, 1).repeat_interleave(4, 2)[..., :3]


def test_the_switch_is_on_only_inside_the_tilers_model_calls():
    from sisr_tpu_torch.parallel.mesh import Mesh
    from sisr_tpu_torch.train.train_state import make_train_step

    probe = Probe()
    img = _image(40, 52)
    assert not in_replayed_forwards()
    TiledSR(probe, 4, tile=32, overlap=8)(img)
    TiledSR(probe, 4, tile=32, overlap=8, chunk=3)(img)
    TiledSR(probe, 4, tile=32, overlap=8).sharded_call(
        img, Mesh(axis_name="tile", size=1, rank=0, device=torch.device("cpu")))
    assert len(probe.seen) == 4 + 2 + 4 and all(on for _, on in probe.seen)
    assert not in_replayed_forwards()
    probe.seen.clear()
    BandedHeadSR(probe, band_rows=8)(img)
    probe(img[None])
    step = make_train_step(probe, lambda sr, hr: (sr - hr).abs().mean(),
                           torch.optim.SGD(probe.parameters(), 0.1))
    step(img[None, :8, :8], torch.rand((1, 32, 32, 3)))
    stages = [s for s, _ in probe.seen]
    assert stages.count("features") == 1 and stages.count("head") > 1
    assert stages[-2:] == ["full", "full"]
    assert not any(on for _, on in probe.seen)


def _spans(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("sisr.forward")}
    return out, counts


@pytest.mark.parametrize("arch", ["hitsir", "hat"])
def test_on_the_cpu_the_tiles_run_eager_and_match_the_switch_off(arch, fresh, monkeypatch):
    model = _hitsir() if arch == "hitsir" else _hat()
    img = _image(36, 44)
    runner = TiledSR(model, 4, tile=24, overlap=4)
    with torch.inference_mode():
        got, counts = _spans(lambda: runner(img))
    assert counts == {"sisr.forward.eager": 4}
    assert not ag._signatures and not ag._failed
    monkeypatch.setattr(tiling, "replayed_forwards", nullcontext)
    with torch.inference_mode():
        want, counts = _spans(lambda: runner(img))
    assert counts == {}
    assert torch.equal(got, want)


def _signature_of(model, x, monkeypatch, **kw):
    """The signature ``model(x, **kw)`` computes under the switch, with the
    CPU counted as a card (the forward then runs eager)."""
    got = []
    real = ag._forward_signature

    def record(module, x, attrs, deterministic):
        got.append(real(module, x, attrs, deterministic))
        return None

    with monkeypatch.context() as m:
        m.setattr(ag, "GRAPH_DEVICES", ("cpu", "cuda"))
        m.setattr(ag, "_forward_signature", record)
        with ag.replayed_forwards(), torch.no_grad():
            model(x, **kw)
    return got[0]


def test_signature_separates_what_changes_the_forward(monkeypatch):
    model = _hitsir()
    x = torch.rand((1, 16, 16, 3))
    sig = lambda m=model, t=x, **kw: _signature_of(m, t, monkeypatch, **kw)
    base = sig()
    assert base is not None and base == sig() and hash(base) == hash(sig())
    assert sig(t=torch.rand((1, 16, 16, 3))) == base       # values do not count
    variants = {
        "shape": sig(t=torch.rand((1, 24, 16, 3))),
        "batch": sig(t=torch.rand((2, 16, 16, 3))),
        "input dtype": sig(t=x.double()),
        "stride": sig(t=x.transpose(1, 2).contiguous().transpose(1, 2)),
        "stage": sig(stage="features"),
        "head_packed": _set(model, "head_packed", True, sig),
        "model dtype": _set(model, "dtype", torch.bfloat16, sig),
    }
    with plain_versions():
        variants["plain versions"] = sig()
    with exact_mode():
        variants["precision"] = sig()
    assert all(v is not None for v in variants.values())
    assert len(set(variants.values()) | {base}) == len(variants) + 1
    assert sig(m=copy.copy(model)) not in (base, None)     # a shallow copy is not the model
    # a write into one parameter, then a load of the same values
    with torch.no_grad():
        p = model.conv_after_body.weight
        p.copy_(p * 1.0)
    written = sig()
    assert written not in (base, None)
    model.load_state_dict(model.state_dict())
    assert sig() not in (base, written, None)
    assert sig(deterministic=False) is None
    # grad on, the switch off, the CPU not counted as a card
    real = ag._forward_signature
    with ag.replayed_forwards(), monkeypatch.context() as m:
        m.setattr(ag, "GRAPH_DEVICES", ("cpu", "cuda"))
        assert real(model, x, (model.dtype, False, "full"), True) is None     # grad on
        with torch.no_grad():
            assert real(model, x, (model.dtype, False, "full"), True) is not None
    with torch.no_grad():
        assert real(model, x, (model.dtype, False, "full"), True) is None     # off
        with ag.replayed_forwards():
            assert real(model, x, (model.dtype, False, "full"), True) is None  # cpu
    with torch.inference_mode():
        made_there = _hitsir()
    assert sig(m=made_there) is None


def _set(model, name, value, sig):
    """``sig()`` with ``model.<name>`` set to ``value`` for the call."""
    before = getattr(model, name)
    setattr(model, name, value)
    try:
        return sig()
    finally:
        setattr(model, name, before)


class FakeGraph:
    """Stands in for ``_ForwardGraph``: records its captures and replays
    eagerly; ``first`` is the capturing call's answer."""
    made = []

    def __init__(self, run, x):
        self.run = run
        FakeGraph.made.append(tuple(x.shape))
        self.first = run(x)

    def replay(self, x):
        return self.run(x)


@pytest.fixture
def as_if_on_a_card(monkeypatch, fresh):
    monkeypatch.setattr(ag, "GRAPH_DEVICES", ("cpu", "cuda"))
    monkeypatch.setattr(ag, "_ForwardGraph", FakeGraph)
    FakeGraph.made = []


def test_dispatch_eager_then_capture_then_replay(as_if_on_a_card):
    model = _hitsir()
    calls = []
    model.register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape))
    img = _image(36, 44)
    runner = TiledSR(model, 4, tile=24, overlap=4)          # 4 tiles a request
    with torch.inference_mode():
        want = runner(img)
        assert FakeGraph.made == [(1, 24, 24, 3)]
        got, counts = _spans(lambda: runner(img))
    assert counts == {"sisr.forward.replay": 4}
    assert torch.equal(got, want) and len(calls) == 8
    with torch.inference_mode():
        _, counts = _spans(lambda: TiledSR(model, 4, tile=28, overlap=4)(img))
    assert counts == {"sisr.forward.eager": 2, "sisr.forward.replay": 2}
    assert FakeGraph.made == [(1, 24, 24, 3), (1, 28, 28, 3)] and len(ag._signatures) == 2
    with torch.inference_mode():      # the whole-image call is not under the switch
        _, counts = _spans(lambda: model(img[None]))
    assert counts == {}


def test_failed_capture_stays_eager_and_warns_once(as_if_on_a_card, monkeypatch):
    class Refused:
        def __init__(self, run, x):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(ag, "_ForwardGraph", Refused)
    model = _hat()
    img = _image(20, 24)
    with monkeypatch.context() as m, torch.inference_mode():
        m.setattr(tiling, "replayed_forwards", nullcontext)
        want = TiledSR(model, 4, tile=12, overlap=4)(img)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.inference_mode():
            got, counts = _spans(lambda: TiledSR(model, 4, tile=12, overlap=4)(img))
    said = [str(w.message) for w in caught if "CUDA graph" in str(w.message)]
    assert len(said) == 1 and "HAT" in said[0] and "not permitted" in said[0]
    assert counts == {"sisr.forward.eager": 6}
    assert torch.equal(got, want)
    assert len(ag._failed) == 1 and not ag._signatures


def test_least_recently_used_forward_signature_is_dropped_first(as_if_on_a_card,
                                                                  monkeypatch):
    monkeypatch.setattr(ag, "MAX_SIGNATURES", 2)
    model = _hitsir()
    run = lambda side: TiledSR(model, 4, tile=side, overlap=4)(_image(side, side))
    with torch.inference_mode():
        for side in (16, 24, 16, 32):
            run(side)
    # 24 was the least recent when 32 came: 16 and 32 are kept
    assert [k[3][1] for k in ag._signatures] == [16, 32]
    with torch.inference_mode():
        _, counts = _spans(lambda: run(24))
    assert counts == {"sisr.forward.eager": 1}
    assert [k[3][1] for k in ag._signatures] == [32, 24]
