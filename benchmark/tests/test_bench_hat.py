"""HAT's frame cell and the batch-16 PSNR cell on the CPU: the chunked
reference against itself unchunked and against HAT's own formulation, the
work counter against the hand count, the new readers on synthetic traces,
and whole tiny runs: sound runs are correct; the fp8 control and two faults
planted in the program (the shift mask left out; the overlapping
attention's zero keys dropped from its softmax) are not, the faults by the
worst window square's ratio (``sr_vs_fp8.window``)."""

import json

import pytest
import torch

import benchmark.run as bench_run
from benchmark.control import control
from benchmark.harness.loops import Window
from benchmark.harness.spec import Cell, load_module
from benchmark.harness.synth import synth
from benchmark.harness.trace import Trace
from benchmark.reference import hat as ref
from benchmark.tests.tiny import TINY_MODEL
from benchmark.work.hat import attention_work, forward_ops, layer_ops
from sisr_tpu_torch.ops.kernels import win_attn as wa

PLAIN = wa.win_attn_reference

HAT_CELL, B16_CELL = "hat.frame1080.bf16", "hitsir_pro.train_b16.f32"
TINY_HAT = {"embed_dim": 24, "depths": [2, 2], "num_heads": [2, 2], "window_size": 4,
            "squeeze_factor": 6}


def tiny(name: str) -> Cell:
    cell = Cell(name)
    cell.config = dict(cell.config, **(TINY_HAT if name == HAT_CELL else TINY_MODEL))
    cell.traffic = dict(cell.traffic, **({"sizes": [[18, 26]], "dtype": "float32"}
                                         if name == HAT_CELL else
                                         {"lr_size": 16, "pool": 3, "batch": 4}))
    return cell


def _run(name, seed=2**31 + 91):
    return bench_run.run(name, seed, 1.0, False, device="cpu", require_device=False,
                         cell=tiny(name))


def test_chunked_reference_is_the_unchunked_one_and_hats(monkeypatch):
    """Chunks of windows change nothing; and the reference agrees with HAT
    written as HAT computes it (``sisr_tpu_torch/models/hat_reference.py``:
    rolls, partitions, F.unfold), float32 round-off apart."""
    from sisr_tpu_torch.models import hat_reference

    cfg = tiny(HAT_CELL).config
    P = synth(ref.manifest(cfg), 5, "generator", "cpu")
    x = torch.rand(2, 18, 26, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        whole = ref.forward(P, cfg, x)
        monkeypatch.setattr(ref, "CHUNK_ELEMS", 700)
        chunked = ref.forward(P, cfg, x)
        hats = hat_reference.forward(P, x, cfg)
    assert whole.shape == (2, 72, 104, 3)
    assert torch.equal(whole, chunked)
    assert float((whole - hats).abs().max()) < 1e-5 * float(hats.abs().max())


def test_work_against_the_hand_count():
    """25,361,388 multiply-adds an LR pixel at HAT x4's widths (conv_first
    4,860; a HAB 545,760: qkv 97,200, QK^T and its product with v 2 x
    46,080, proj 32,400, the CAB convs 2 x 97,200, the MLP 2 x 64,800; an
    OCAB 466,560 with 576 keys; a group's conv 291,600; conv_after_body
    291,600; conv_before_upsample 103,680; the head 147,456 + 589,824 +
    27,648); a 1080p frame 105.18 TFLOP, 18% of it attention."""
    cfg = Cell(HAT_CELL).config
    assert forward_ops(cfg, 1, 1) == 2 * 25_361_388
    ops = layer_ops(cfg, 1080, 1920)
    assert abs(forward_ops(cfg, 1080, 1920) - 105.1787e12) < 1e8
    assert 0.17 < ops["win_attn"] / sum(ops.values()) < 0.19
    nbytes, flops = attention_work(2, 3, 12, 36, es=2)
    assert (nbytes, flops) == (2 * 4 * 6 * 12, 2.0 * 2 * 6 * 36 * 12)
    assert ref.n_params(cfg) == cfg["parameters"] == 20_772_507


class _Ctx:
    def __init__(self, cell, trace, calls, sizes, seconds):
        self.cell, self.trace = cell, trace
        self.entry = type("E", (), {"spans": type("S", (), {"model_calls": calls})()})()
        self.window = Window()
        self.window.sizes, self.window.end = sizes, seconds


def test_readers_on_a_synthetic_trace():
    """Two attention kernels of 10 ms and 30 ms and a conv of 60 ms in a
    1 s window, one 1080 x 1920 request: the roofline is the least time of
    36 + 6 attentions over 40 ms, the share 40 of 100 busy ms, the mfu
    105.18 TFLOP over 1 s at 989 TFLOP/s."""
    cell = Cell(HAT_CELL)
    ms = 1_000_000
    device = [("void (anonymous namespace)::win_attn_bf16<16, 16>(...)", 0, 10 * ms, True),
              ("void (anonymous namespace)::win_attn_bf16<16, 24>(...)", 20 * ms, 50 * ms, True),
              ("conv3x3_wgmma_kernel", 50 * ms, 110 * ms, True)]
    ctx = _Ctx(cell, Trace(device, []), [(1, 1080, 1920, "full")], [(1080, 1920)], 1.0)
    c = 180
    want = (36 * max(2 * 4 * 1080 * 1920 * c / 3.35e12, 4.0 * 1080 * 1920 * 256 * c / 989e12)
            + 6 * max(2 * 4 * 1080 * 1920 * c / 3.35e12, 4.0 * 1080 * 1920 * 576 * c / 989e12))
    roof = load_module("metrics", "win_attn_roofline.hat_frame1080").read(ctx)
    assert roof == pytest.approx(100.0 * want / 0.040)
    share = load_module("metrics", "win_attn_share.hat_frame1080").read(ctx)
    assert share == pytest.approx(40.0)
    mfu = load_module("metrics", "mfu.serve.hat_frame1080").read(ctx)
    assert mfu == pytest.approx(100.0 * forward_ops(cell.config, 1080, 1920) / 989e12)
    empty = _Ctx(cell, Trace(device[2:], []), [(1, 1080, 1920, "full")], [(1080, 1920)], 1.0)
    assert load_module("metrics", "win_attn_roofline.hat_frame1080").read(empty) is None
    assert load_module("metrics", "win_attn_share.hat_frame1080").read(empty) is None


def test_benchmark_lists_the_new_cells():
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[HAT_CELL]["config"] == "hat" and cells[B16_CELL]["chips"] == 1
    hat_metrics = {m["name"] for m in Cell(HAT_CELL).per_layer}
    assert hat_metrics == {"win_attn_roofline.hat_frame1080", "win_attn_share.hat_frame1080",
                           "mfu.serve.hat_frame1080", "idle_share.serve.hat_frame1080",
                           "kernel_host_us.hat_frame1080"}
    assert {m["name"] for m in Cell(B16_CELL).end_to_end} == {"train_mps.psnr", "setup_s"}


@pytest.mark.parametrize("name", [HAT_CELL, B16_CELL])
def test_sound_tiny_run_is_correct(name):
    res = _run(name)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in tiny(name).end_to_end}


def test_fp8_control_is_not_correct():
    for seed in (3, 2**31 + 5):
        out = control(tiny(HAT_CELL), seed, device="cpu")
        assert out["precision"] == "fp8" and out["correct"] is False


def _unmasked(qkv, bias, heads, window, shift=0, key_window=0):
    if not shift:
        return PLAIN(qkv, bias, heads, window, 0, key_window)
    out = PLAIN(torch.roll(qkv, (-shift, -shift), (1, 2)), bias, heads, window)
    return torch.roll(out, (shift, shift), (1, 2))


def _edge_keys_dropped(qkv, bias, heads, window, shift=0, key_window=0):
    """The overlapping attention with the keys past the map masked out of
    the softmax (each window its own mask) instead of read as zeros."""
    key_window = key_window or window
    if key_window == window:
        return PLAIN(qkv, bias, heads, window, shift, key_window)
    b, h, w, c3 = qkv.shape
    c, d = c3 // 3, c3 // 3 // heads
    q, k, v = qkv.split(c, -1)
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)
    qw = split(wa._windows(q, window))
    kw = split(wa._overlap_windows(k, window, key_window))
    vw = split(wa._overlap_windows(v, window, key_window))
    inside = wa._overlap_windows(torch.ones(b, h, w, 1), window, key_window)[..., 0] > 0
    s = qw @ kw.transpose(-1, -2) * d ** -0.5 + bias
    s = s.masked_fill(~inside[:, None, None, :], float("-inf"))
    out = (torch.softmax(s, -1) @ vw).transpose(1, 2).reshape(qw.shape[0], -1, c)
    return wa._unwindows(out, window, b, h, w)


@pytest.mark.parametrize("fault", [_unmasked, _edge_keys_dropped], ids=["no_mask", "edge_keys"])
def test_planted_fault_reads_over_the_limit(fault, monkeypatch):
    monkeypatch.setattr(wa, "win_attn_reference", fault)
    res = _run(HAT_CELL)
    c = res["checks"]["sr_vs_fp8.window"]
    assert res["correct"] is False and c["value"] > c["limit"], res["checks"]
