"""The port's ``sisr.*`` spans (``utils/profiling.py::span``), on the CPU.

- With the profiler off no span builds a ``record_function``, on any path:
  the tiler, a training step with its kernels' backward, the kernel
  wrappers' decorator, the derived weights and packs.
- Under ``profiling.trace`` a tiny HiTSIR PSNR step records its forward,
  backward, each kernel's recomputed vjp under the kernel's name, and the
  derived weights made anew; each plain recompute (CPU tensors: eager) as
  ``sisr.recompute.<name>`` inside its ``sisr.vjp.<name>`` on the same
  thread; ``TiledSR`` records one ``sisr.tiler`` per
  request and one ``sisr.tiler.model`` per chunk of tiles.
- ``build.launched`` counts ``build.launches`` as the hand-written counters
  did: one per returning call, none for a call that raises.
- On a card, a kernel's vjp span runs on the autograd engine's thread.

The plain versions stand in for the kernels (``KernelFunction.with_kernel``),
routed in where the model calls the public kernel functions.
"""

import numpy as np
import pytest
import torch

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.utils import profiling

torch.set_num_threads(1)

TINY = dict(is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
            is_fusion=True, embed_dim=24, depths=(2,), num_heads=(2,),
            base_win_size=(8, 8), mlp_ratio=2.0, upsampler="nearest+conv", upscale=4,
            hier_win_ratios=(0.5, 1))
KERNEL_NAMES = {"conv3x3", "conv3x3_shuffled", "conv3x3_shuffled_tail", "htb_tail",
                "scc_block", "fused_fusion", "dwconv5x5"}


def _route_kernels(monkeypatch):
    """The model's public kernel functions (and the HTB tail's dwconv in its
    backward) through their ``KernelFunction``s, the plain versions
    standing in for the kernels; the trailing ``reference`` is dropped."""
    from sisr_tpu_torch.models import hit_sir_pro as hsp
    from sisr_tpu_torch.ops.kernels import conv3x3 as cv, dwconv, ffn
    from sisr_tpu_torch.ops.kernels import fusion_ops as fo, scc_block as sb

    def route(kf, plain, n):
        fn = kf.with_kernel(plain)
        return lambda *args, reference=False: fn(*args[:n])

    monkeypatch.setattr(hsp, "conv3x3", route(cv.CONV3X3, cv.conv3x3_reference, 5))
    monkeypatch.setattr(hsp, "conv3x3_shuffled",
                        route(cv.CONV3X3_SHUFFLED, cv.conv3x3_shuffled_reference, 4))
    monkeypatch.setattr(hsp, "conv3x3_shuffled_tail",
                        route(cv.SHUFFLED_TAIL, cv.conv3x3_shuffled_tail_reference, 6))
    monkeypatch.setattr(hsp, "htb_tail", route(ffn.HTB_TAIL, ffn._tail_plain, 12))
    monkeypatch.setattr(hsp, "scc_block", route(sb.SCC_BLOCK, sb.scc_block_reference, 13))
    monkeypatch.setattr(hsp, "fused_fusion", route(
        fo.FUSED_FUSION, lambda a, b, raws, packed: fo.fused_fusion_reference(a, b, raws), 4))
    monkeypatch.setattr(ffn, "dwconv5x5",
                        route(dwconv.DWCONV5X5, dwconv.depthwise_conv_reference, 3))


def _psnr_step():
    """A tiny HiTSIR's ``make_train_step`` (L1, Adam) and one batch."""
    from sisr_tpu_torch.configs.model_config import get_loss_function
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR
    from sisr_tpu_torch.train.train_state import make_train_step

    torch.manual_seed(0)
    model = HiTSIR(**TINY)
    step = make_train_step(model, get_loss_function("l1"),
                           torch.optim.Adam(model.parameters(), 1e-4))
    g = torch.Generator().manual_seed(1)
    lr = torch.rand((2, 16, 16, 3), generator=g)
    hr = torch.rand((2, 64, 64, 3), generator=g)
    return lambda: step(lr, hr, torch.Generator().manual_seed(2))


def _tiler(chunk=2):
    from sisr_tpu_torch.parallel.tiling import TiledSR

    up = lambda p: p.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return TiledSR(up, scale=2, tile=16, overlap=4, chunk=chunk)


@build.launched("conv3x3")
def _fake_wrapper(x, fail=False):
    if fail:
        raise ValueError("refused")
    return x + 1


def _every_path(monkeypatch):
    """One pass over every spanned path the CPU runs."""
    from sisr_tpu_torch.ops.kernels import conv3x3 as cv

    _route_kernels(monkeypatch)
    _psnr_step()()
    _tiler()(torch.rand(40, 56, 3))
    _fake_wrapper(torch.zeros(2))
    w = torch.rand(3, 3, 8, 8)
    build.cached(w, "_probe_pack", (w,), lambda: w * 2)
    cv._packed(w, 64)


def _span_counts(prof):
    return {e.key: e.count for e in prof.key_averages() if e.key.startswith("sisr.")}


def test_span_off_builds_no_record_function(monkeypatch):
    built = []

    class Counting(torch.autograd.profiler.record_function):
        def __init__(self, name, args=None):
            built.append(name)
            super().__init__(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("x") is profiling.span("y")
    _every_path(monkeypatch)
    assert [n for n in built if n.startswith("sisr.")] == []
    # the same paths under a profiler: the count sees every family
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _every_path(monkeypatch)
    families = {n.split(".")[1] for n in built if n.startswith("sisr.")}
    assert families == {"step", "vjp", "recompute", "derive", "tiler", "kernel"}


def test_psnr_step_records_forward_backward_recompute_and_derive(monkeypatch, tmp_path):
    _route_kernels(monkeypatch)
    step = _psnr_step()
    step()                                  # the first call's one-time work
    with profiling.trace(str(tmp_path)) as prof:
        step()
    names = _span_counts(prof)
    assert names["sisr.step.forward"] == names["sisr.step.backward"] == 1
    vjp = {n[len("sisr.vjp."):] for n in names if n.startswith("sisr.vjp.")}
    assert vjp == KERNEL_NAMES
    derive = {n[len("sisr.derive."):] for n in names if n.startswith("sisr.derive.")}
    assert {"conv", "msce", "scc", "tail", "fusion", "up2"} <= derive
    # every recompute runs inside the backward, every derive inside the forward
    spans = {}
    for e in prof.events():
        spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    within = lambda inner, outer: all(outer[0][0] <= s and e <= outer[0][1] for s, e in inner)
    for name, ranges in spans.items():
        if name.startswith("sisr.vjp."):
            assert within(ranges, spans["sisr.step.backward"]), name
        if name.startswith("sisr.derive."):
            assert within(ranges, spans["sisr.step.forward"]), name


def test_recompute_opens_inside_its_vjp_on_the_same_thread(monkeypatch):
    _route_kernels(monkeypatch)
    step = _psnr_step()
    step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    vjps, recomputes = [], []
    for e in prof.events():
        for prefix, into in (("sisr.vjp.", vjps), ("sisr.recompute.", recomputes)):
            if e.name.startswith(prefix):
                into.append((e.name[len(prefix):], e.thread, e.time_range.start,
                             e.time_range.end))
    # dwconv5x5 has a vjp of its own; CPU tensors never replay
    assert {r[0] for r in recomputes} == KERNEL_NAMES - {"dwconv5x5"}
    assert not [e for e in prof.events() if e.name.startswith("sisr.replay.")]
    for name, thread, s, e in recomputes:
        assert any(n == name and t == thread and vs <= s and e <= ve
                   for n, t, vs, ve in vjps), name
    assert len(recomputes) == len([v for v in vjps if v[0] != "dwconv5x5"])


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_tiler_records_one_request_and_one_model_span_per_chunk(chunk):
    tiler = _tiler(chunk)
    img = torch.rand(40, 56, 3)
    chunks = len(tiler._positions(40, 56)) // chunk
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = tiler(img)
    assert _span_counts(prof) == {"sisr.tiler": 1, "sisr.tiler.model": chunks}
    assert chunks > 1
    np.testing.assert_allclose(out.numpy(), img.repeat_interleave(2, 0)
                               .repeat_interleave(2, 1).numpy(), rtol=1e-6)


def test_launched_counts_as_the_hand_written_counters():
    before = dict(build.launches)
    for k in range(3):
        assert float(_fake_wrapper(torch.zeros(1))) == 1.0
        assert build.launches["conv3x3"] == before["conv3x3"] + k + 1
    with pytest.raises(ValueError):
        _fake_wrapper(torch.zeros(1), fail=True)
    assert build.launches["conv3x3"] == before["conv3x3"] + 3
    assert all(build.launches[k] == before[k] for k in build.launches if k != "conv3x3")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _fake_wrapper(torch.zeros(1))
    assert _span_counts(prof) == {"sisr.kernel.conv3x3": 1}
    assert _fake_wrapper.__name__ == "_fake_wrapper"


def test_every_kernel_function_is_named_for_its_counter():
    from sisr_tpu_torch.ops.kernels import conv3x3 as cv, dwconv, ffn
    from sisr_tpu_torch.ops.kernels import fusion_ops as fo, scc_block as sb, win_attn as wa

    fns = [cv.CONV3X3, cv.CONV3X3_SHUFFLED, cv.SHUFFLED_TAIL, cv.SHUFFLED_TAIL_PACKED,
           ffn.HTB_TAIL, sb.SCC_BLOCK, fo.FUSION_POOLS, fo.FUSED_FUSION, dwconv.DWCONV5X5,
           wa.WIN_ATTN]
    names = [f.name for f in fns]
    assert len(set(names)) == len(names) and set(names) <= set(build.launches)
    assert all(f.with_kernel(f.plain).name == f.name for f in fns)


@pytest.mark.cuda
def test_vjp_span_runs_on_the_autograd_engine_thread():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from sisr_tpu_torch.ops.kernels.dwconv import dwconv5x5

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((1, 16, 16, 8), device=dev, generator=g, requires_grad=True)
    w = torch.rand((5, 5, 8), device=dev, generator=g, requires_grad=True)
    b = torch.rand((8,), device=dev, generator=g, requires_grad=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("probe"):
            dwconv5x5(x, w, b).square().sum().backward()
        torch.cuda.synchronize()
    threads = {}
    for e in prof.events():
        if e.name.startswith("sisr.") and e.device_type == torch.autograd.DeviceType.CPU:
            threads.setdefault(e.name, set()).add(e.thread)
    assert set(threads) >= {"sisr.probe", "sisr.vjp.dwconv5x5", "sisr.kernel.dwconv5x5"}
    assert threads["sisr.vjp.dwconv5x5"].isdisjoint(threads["sisr.probe"])
    assert x.grad is not None and w.grad is not None and b.grad is not None
