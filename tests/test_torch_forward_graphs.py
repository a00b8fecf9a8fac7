"""A model's forward replayed as a CUDA graph per input signature
(``ops/kernels/autograd.py::replayed_forward``) against the eager forward,
on a card: the flagship HiT-SIR-Pro in bfloat16 and float32 and HAT x4 in
bfloat16, at their published widths, on 192x192 tiles with seeded weights.

- The forwards under ``replayed_forwards()`` (the first eager, the second
  captured, the rest replayed) equal the eager forwards with the switch
  off, bit for bit; the replays' answers share no memory with each other
  or with the graph's static buffers; a replay counts the same
  ``build.launches`` as an eager forward.
- Weights loaded with ``load_state_dict`` after a capture reach the next
  forwards: they give the new weights' answer.
- Photos from the benchmark's mix through ``infer.upscale``: the same
  answer as with the switch off, the first tile eager, the second eager
  while it captures, every later tile (and every tile of the next photo)
  replayed.

Every test here needs a CUDA card and skips without one; like
``test_torch_kernels.py`` the file imports no JAX:

    python -m pytest --noconftest tests/test_torch_forward_graphs.py -m cuda -q
"""

from collections import OrderedDict
from contextlib import nullcontext

import pytest
import torch

from sisr_tpu_torch.ops.kernels import autograd as ag
from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.parallel import tiling
from sisr_tpu_torch.utils import profiling

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

TILE = 192
CASES = [("hitsir", "bfloat16"), ("hitsir", "float32"), ("hat", "bfloat16")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def fresh(monkeypatch):
    """Empty bookkeeping, restored afterwards; the graphs made here are
    waited for before they are dropped."""
    monkeypatch.setattr(ag, "_signatures", OrderedDict())
    monkeypatch.setattr(ag, "_failed", set())
    yield
    torch.cuda.synchronize()


def _model(arch, dtype, dev, seed=0):
    from sisr_tpu_torch import infer

    model = (infer.create_hat if arch == "hat" else infer.create_model)(dtype, str(dev))
    infer.synth_weights(model, seed)
    return model


def _tile(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((1, TILE, TILE, 3), generator=g, device=dev)


def _switched(model, x):
    with torch.inference_mode(), ag.replayed_forwards():
        return model(x)


def _eager(model, x):
    with torch.inference_mode():
        return model(x)


def _graph():
    (graph,) = [v for v in ag._signatures.values() if isinstance(v, ag._ForwardGraph)]
    return graph


@pytest.mark.parametrize("arch,dtype", CASES)
def test_replayed_forward_equals_eager_and_counts_its_launches(arch, dtype, cuda_device,
                                                              fresh):
    model = _model(arch, dtype, cuda_device)
    tiles = [_tile(cuda_device, s) for s in range(4)]
    want = [_eager(model, t) for t in tiles]
    build.reset_launches()
    _eager(model, tiles[0])
    eager_launches = dict(build.launches)
    assert sum(eager_launches.values()) > 0
    got = [_switched(model, t) for t in tiles]      # eager, capture, replay, replay
    graph = _graph()
    build.reset_launches()
    again = _switched(model, tiles[0])
    assert dict(build.launches) == eager_launches
    torch.cuda.synchronize()
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if not torch.equal(g, w)]
    assert not bad, f"tiles {bad} differ from the eager forward"
    assert torch.equal(again, want[0])
    ptrs = [t.untyped_storage().data_ptr() for t in got + [again]]
    assert len(set(ptrs)) == len(ptrs)
    statics = {t.untyped_storage().data_ptr() for t in list(graph.outs) + graph.static}
    assert not statics & set(ptrs)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_weights_loaded_after_a_capture_reach_the_replay(arch, dtype, cuda_device, fresh):
    model = _model(arch, dtype, cuda_device)
    x = _tile(cuda_device, 7)
    before = [_switched(model, x) for _ in range(3)]       # eager, capture, replay
    other = _model(arch, dtype, cuda_device, seed=1)
    want = _eager(other, x)
    assert not torch.equal(before[-1], want)
    model.load_state_dict(other.state_dict())
    del other
    got = [_switched(model, x) for _ in range(3)]          # a new signature
    assert len([v for v in ag._signatures.values() if isinstance(v, ag._ForwardGraph)]) == 2
    assert all(torch.equal(g, want) for g in got)


def test_photos_through_infer_replay_from_the_third_tile(cuda_device, fresh, monkeypatch):
    from sisr_tpu_torch import infer

    model = _model("hitsir", "bfloat16", cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    photos = [torch.rand((480, 640, 3), generator=g, device=cuda_device),   # 12 tiles
              torch.rand((270, 480, 3), generator=g, device=cuda_device)]   # 6 tiles
    with monkeypatch.context() as m:
        m.setattr(tiling, "replayed_forwards", nullcontext)
        want = [infer.upscale(model, p) for p in photos]
    names = []
    monkeypatch.setattr(ag, "span", lambda name: names.append(name) or profiling.span(name))
    got = [infer.upscale(model, p) for p in photos]
    assert names == ["forward.eager"] * 2 + ["forward.replay"] * 16
    assert all(torch.equal(a, b) for a, b in zip(got, want))
