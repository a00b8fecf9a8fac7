"""The kernels' recomputed backward replayed as CUDA graphs
(``ops/kernels/autograd.py``) against the eager recompute, on a card.

- Every ``KernelFunction`` with a plain vjp, at the training cells' shapes
  (the flagship in float32, batch 2, LR 64x64: ``scc_block`` at each of its
  six windows, ``htb_tail``, the convs, the shuffled conv and tail, the
  Fusion gate; ``fusion_pools`` and the packed tail called alone): the
  replayed gradients equal the eager ones bit for bit where the static
  buffers keep the leaves' strides, else within 1e-6 relative.
- Calls of one signature in one backward return gradients that share no
  memory; weights changed between steps reach the replay; a new shape
  captures anew; a capture that cannot run stays eager; a graph captured
  with TF32 on is not replayed under ``exact_mode``; a replay keeps the
  code it captured until ``drop_graphs``.
- A whole PSNR step's gradients, and its kernel launches, are those of the
  step with the replay switched off (``_signature`` patched to None).

Every test here needs a CUDA card and skips without one; like
``test_torch_kernels.py`` the file imports no JAX:

    python -m pytest --noconftest tests/test_torch_vjp_graphs.py -m cuda -q
"""

import warnings
from collections import OrderedDict

import pytest
import torch

from sisr_tpu_torch.ops.kernels import autograd as ag
from sisr_tpu_torch.ops.kernels import build

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

BATCH, LR = 2, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def fresh(monkeypatch):
    """Empty bookkeeping, restored afterwards."""
    monkeypatch.setattr(ag, "_signatures", OrderedDict())
    monkeypatch.setattr(ag, "_failed", set())


def _flagship(dev):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config

    torch.manual_seed(0)
    return HiTSIR(**flagship_config()).to(dev)


def _batch(dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand((BATCH, LR, LR, 3), generator=g, device=dev),
            torch.rand((BATCH, 4 * LR, 4 * LR, 3), generator=g, device=dev))


def _forward(model, lr):
    return model(lr, deterministic=False)


def _training_calls(dev, monkeypatch):
    """(fn, spec, leaves, need, cotangents) of every ``KernelFunction`` call
    of one flagship training forward, one per signature, with seeded
    cotangents."""
    calls = OrderedDict()
    real = ag._Apply
    g = torch.Generator(device=dev).manual_seed(7)

    class Recording:
        @staticmethod
        def apply(fn, spec, *leaves):
            out = real.apply(fn, spec, *leaves)
            need = tuple(t.requires_grad for t in leaves)
            cots = tuple(torch.randn(o.shape, generator=g, device=dev, dtype=o.dtype)
                         for o in ag._tensors(out))
            key = ag._key(fn, spec, leaves, need, cots)
            if key not in calls:
                calls[key] = (fn, spec, [t.detach() for t in leaves], need, cots)
            return out

    model = _flagship(dev)
    monkeypatch.setattr(ag, "_Apply", Recording)
    _forward(model, _batch(dev)[0])
    monkeypatch.setattr(ag, "_Apply", real)
    return list(calls.values())


def _alone_calls(dev, tail):
    """``fusion_pools`` at the Fusion gate's shape and the packed tail on the
    training tail's inputs: no training forward calls them through their
    ``KernelFunction``."""
    from sisr_tpu_torch.ops.kernels import conv3x3 as cv
    from sisr_tpu_torch.ops.kernels import fusion_ops as fo

    g = torch.Generator(device=dev).manual_seed(3)
    a, b = (torch.randn((BATCH, LR, LR, 180), generator=g, device=dev) for _ in range(2))
    leaves = [a, b]
    spec = ag._flatten((a, b), [])
    outs = fo.fusion_pools_reference(a, b)
    cots = tuple(torch.randn(o.shape, generator=g, device=dev) for o in ag._tensors(outs))
    pools = (fo.FUSION_POOLS, spec, leaves, (True, True), cots)
    fn, spec, leaves, need, _ = tail
    out = cv.conv3x3_shuffled_tail_packed_reference(*ag._rebuild(spec, leaves))
    packed = (cv.SHUFFLED_TAIL_PACKED, spec, leaves, need,
              (torch.randn(out.shape, generator=g, device=dev),))
    return [pools, packed]


def _label(fn, spec, leaves):
    if fn.name == "scc_block":
        return f"scc_block window {ag._rebuild(spec, leaves)[-1]}"
    return f"{fn.name} {tuple(leaves[0].shape)}"


def _compare(got, want, bitwise, what):
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None):
            bad.append(f"{what}: gradient {i} is None on one side only")
        elif g is None:
            continue
        elif bitwise and not torch.equal(g, w):
            bad.append(f"{what}: gradient {i} differs, max {float((g - w).abs().max())}")
        elif not bitwise:
            err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            if err > 1e-6:
                bad.append(f"{what}: gradient {i} relative error {err}")
    return bad


def test_replay_equals_eager_at_the_training_shapes(cuda_device, fresh, monkeypatch):
    calls = _training_calls(cuda_device, monkeypatch)
    names = [c[0].name for c in calls]
    windows = sorted(ag._rebuild(c[1], c[2])[-1] for c in calls if c[0].name == "scc_block")
    assert [w if isinstance(w, int) else w[0] for w in windows] == [4, 8, 16, 32, 48, 64]
    assert {"htb_tail", "conv3x3", "conv3x3_shuffled", "conv3x3_shuffled_tail",
            "fused_fusion"} <= set(names)
    tail = calls[names.index("conv3x3_shuffled_tail")]
    bad = []
    for fn, spec, leaves, need, cots in calls + _alone_calls(cuda_device, tail):
        what = _label(fn, spec, leaves)
        eager = ag._plain_vjp(fn.plain, spec, leaves, need, cots)
        graph = ag._VjpGraph(fn.plain, spec, leaves, need, cots)
        kept = all(s.stride() == t.stride() for s, t in zip(graph.ins, leaves))
        bad += _compare(graph.first, eager, kept, what + " (its capture's call)")
        for _ in range(2):
            bad += _compare(graph.replay(leaves, cots), eager, kept, what)
        # on the static buffers themselves: the same memory, the same ops
        bad += _compare(graph.replay(leaves, cots),
                        ag._plain_vjp(fn.plain, spec, graph.ins, need, graph.cots), True,
                        what + " on its buffers")
        del graph
    assert not bad, "\n".join(bad)


def _probe_fn():
    def plain(x, w, act):
        y = torch.tanh(x @ w) if act == "tanh" else x @ w
        return y * x

    return ag.KernelFunction("probe", plain, plain)


def test_calls_of_one_signature_in_one_backward_share_no_memory(cuda_device, fresh,
                                                               monkeypatch):
    fn = _probe_fn()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((64, 32), generator=g, device=cuda_device, requires_grad=True)
    ws = [(torch.randn((32, 32), generator=g, device=cuda_device) * 0.1).requires_grad_()
          for _ in range(6)]

    def run():
        y = x
        for w in ws:
            y = fn(y, w, "tanh")
        return torch.autograd.grad(y.square().sum(), [x] + ws)

    signature, recompute, returned = ag._signature, ag._recompute, []
    monkeypatch.setattr(ag, "_signature", lambda *a: None)
    want = run()
    monkeypatch.setattr(ag, "_signature", signature)
    monkeypatch.setattr(ag, "_recompute", lambda *a: returned.append(recompute(*a)) or
                        returned[-1])
    got = run()             # six calls of one signature: eager, capture, four replays
    assert len(returned) == 6
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ptrs = [t.untyped_storage().data_ptr() for r in returned for t in r if t is not None]
    assert len(ptrs) == len(set(ptrs))
    (graph,) = [v for v in ag._signatures.values() if isinstance(v, ag._VjpGraph)]
    statics = {t.untyped_storage().data_ptr() for t in list(graph.outs) + graph.ins
               if t is not None}
    assert not statics & set(ptrs)


def test_changed_weights_reach_the_replay_and_a_new_shape_captures_anew(cuda_device, fresh):
    fn = _probe_fn()
    g = torch.Generator(device=cuda_device).manual_seed(1)
    w = torch.randn((32, 32), generator=g, device=cuda_device, requires_grad=True)

    def grads(x):
        x = x.detach().requires_grad_()
        return torch.autograd.grad(fn(x, w, "tanh").sum(), [x, w])

    def eager(x):
        x = x.detach().requires_grad_()
        out = ag._plain_vjp(fn.plain, ag._flatten((x, w, "tanh"), []), [x, w],
                            (True, True), (torch.ones(x.shape[0], 32, device=cuda_device),))
        return out

    x = torch.randn((16, 32), generator=g, device=cuda_device)
    for _ in range(3):
        got = grads(x)
    assert sum(isinstance(v, ag._VjpGraph) for v in ag._signatures.values()) == 1
    with torch.no_grad():
        w.mul_(-0.5).add_(0.25)                  # an optimizer step in place
    x2 = torch.randn((16, 32), generator=g, device=cuda_device)
    got = grads(x2)
    want = eager(x2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    wide = torch.randn((48, 32), generator=g, device=cuda_device)
    for k in range(3):
        got = grads(wide)
        graphs = sum(isinstance(v, ag._VjpGraph) for v in ag._signatures.values())
        assert graphs == (1 if k == 0 else 2)
        assert all(torch.equal(a, b) for a, b in zip(got, eager(wide)))


def test_capture_that_cannot_run_stays_eager(cuda_device, fresh):
    def plain(x):
        # a copy from pageable host memory: refused inside a capture
        return x * torch.tensor([2.0], device=x.device)

    fn = ag.KernelFunction("probe_refused", plain, plain)
    x = torch.randn((8,), device=cuda_device, requires_grad=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(4):
            (gx,) = torch.autograd.grad(fn(x).sum(), [x])
            assert torch.equal(gx, torch.full_like(x, 2.0))
    assert len([w for w in caught if "CUDA graph" in str(w.message)]) == 1
    assert len(ag._failed) == 1
    assert torch.cuda.current_stream() == torch.cuda.default_stream()


def test_a_graph_captured_with_tf32_is_not_replayed_in_exact_mode(cuda_device, fresh):
    from sisr_tpu_torch.utils.precision import exact_mode

    def plain(x, w):
        return x @ w

    fn = ag.KernelFunction("probe_matmul", plain, plain)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((256, 512), generator=g, device=cuda_device, requires_grad=True)
    w = torch.randn((512, 256), generator=g, device=cuda_device, requires_grad=True)
    grads = lambda: torch.autograd.grad(fn(x, w).square().sum(), [x, w])
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")      # TF32 products
    try:
        for _ in range(3):
            tf32 = grads()                           # captured with TF32
    finally:
        torch.set_float32_matmul_precision(old)
    with exact_mode():
        exact = torch.autograd.grad(plain(x, w).square().sum(), [x, w])
        for _ in range(3):
            got = grads()
    # TF32 moves these gradients by ~1e-3, which a replay of its graph would show
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    assert max(rel(a, b) for a, b in zip(tf32, exact)) > 1e-4
    assert max(rel(a, b) for a, b in zip(got, exact)) < 1e-6
    assert sum(isinstance(v, ag._VjpGraph) for v in ag._signatures.values()) == 2


def test_dropped_graphs_capture_swapped_code_anew(cuda_device, fresh):
    factor = [2.0]

    def plain(x):
        return x * factor[0]         # the number is fixed in the graph at capture

    fn = ag.KernelFunction("probe_swapped", plain, plain)
    x = torch.randn((8,), device=cuda_device, requires_grad=True)
    grad = lambda: torch.autograd.grad(fn(x).sum(), [x])[0]
    for _ in range(3):
        assert torch.equal(grad(), torch.full_like(x, 2.0))
    factor[0] = 3.0
    assert torch.equal(grad(), torch.full_like(x, 2.0))      # the replay keeps its code
    ag.drop_graphs()
    for _ in range(3):
        assert torch.equal(grad(), torch.full_like(x, 3.0))


def test_psnr_step_gradients_and_launches_match_the_eager_step(cuda_device, fresh,
                                                               monkeypatch):
    from sisr_tpu_torch.configs.model_config import get_loss_function

    loss_fn = get_loss_function("l1")
    model = _flagship(cuda_device)
    lr, hr = _batch(cuda_device)

    def grads():
        model.zero_grad(set_to_none=True)
        before = dict(build.launches)
        loss_fn(_forward(model, lr), hr).backward()
        launched = {k: build.launches[k] - before[k] for k in build.launches}
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}, launched

    signature = ag._signature
    monkeypatch.setattr(ag, "_signature", lambda *a: None)
    want, want_launched = grads()
    assert not ag._signatures
    monkeypatch.setattr(ag, "_signature", signature)
    for step in range(4):        # eager, capture, then replays
        got, launched = grads()
        assert launched == want_launched, step
        assert got.keys() == want.keys()
        bad = _compare([got[n] for n in want], [want[n] for n in want], True, f"step {step}")
        assert not bad, "\n".join(bad[:10])
    assert want_launched["dwconv5x5"] == 72
    graphs = [v for v in ag._signatures.values() if isinstance(v, ag._VjpGraph)]
    assert len(graphs) >= 12 and not ag._failed
