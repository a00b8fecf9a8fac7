"""DAT's frame cell and the runner's epoch cell on the CPU: the chunked
reference against itself unchunked and against DAT written as DAT computes
it, the work counter against the hand count, the new readers on synthetic
traces, and whole tiny runs: sound runs are correct; the fp8 control and
four faults planted in the program (padded keys masked instead of read as
zeros; the shift mask left out; one branch's shift axes swapped; the
channel attention's sums taken over a tile instead of the whole frame) are
not; in the epoch cell a stale checkpoint reads a ``ckpt_gap`` above 0."""

import json

import pytest
import torch

import benchmark.run as bench_run
from benchmark.control import control
from benchmark.entries.dat_whole import weights
from benchmark.harness.loops import Window
from benchmark.harness.spec import Cell, load_module
from benchmark.harness.trace import Trace
from benchmark.reference import dat as ref
from benchmark.reference.hitsir import Ops
from benchmark.reference.precision import Precision
from benchmark.tests.tiny import TINY_MODEL
from benchmark.work.dat import chan_attn_work, forward_ops, layer_ops
from sisr_tpu_torch.ops.kernels import chan_attn as ca
from sisr_tpu_torch.ops.kernels import win_attn as wa

DAT_CELL, EPOCH_CELL = "dat.frame1080.bf16", "hitsir_pro.epoch.f32"
TINY_DAT = {"embed_dim": 60, "depth": [2, 2], "num_heads": [2, 2]}
# a 40 x 72 frame: 24 padded rows under the 8 x 32 windows, 24 columns
SIZE = [40, 72]


def tiny(name: str) -> Cell:
    cell = Cell(name)
    if name == DAT_CELL:
        cell.config = dict(cell.config, **TINY_DAT)
        cell.traffic = dict(cell.traffic, sizes=[SIZE], dtype="float32")
    else:
        cell.config = dict(cell.config, **TINY_MODEL)
        cell.traffic = dict(cell.traffic, images=4, image_size=[300, 320], check_steps=2)
    return cell


def _run(name, seed=2**31 + 91):
    return bench_run.run(name, seed, 1.0, False, device="cpu", require_device=False,
                         cell=tiny(name))


def test_chunked_reference_is_the_unchunked_one_and_dats(monkeypatch):
    """Chunks of windows change nothing; and the reference agrees with DAT
    written as DAT computes it (``sisr_tpu_torch/models/dat_reference.py``:
    tokens, F.pad, rolls, img2windows, the mask from slices), float32
    round-off apart."""
    from sisr_tpu_torch.models import dat_reference

    cfg = tiny(DAT_CELL).config
    P = weights(cfg, 5, "cpu")
    x = torch.rand(2, *SIZE, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        whole = ref.forward(P, cfg, x)
        monkeypatch.setattr(ref, "CHUNK_ELEMS", 3000)
        chunked = ref.forward(P, cfg, x)
        dats = dat_reference.forward(P, x, cfg)
    assert whole.shape == (2, 160, 288, 3)
    assert torch.equal(whole, chunked)
    assert float((whole - dats).abs().max()) < 1e-5 * float(dats.abs().max())


def test_work_against_the_hand_count():
    """16,678,584 multiply-adds an LR pixel at DAT x4's widths (conv_first
    4,860; a block's Linears 324,000: qkv 97,200, proj 32,400, fc1 129,600,
    fc2 64,800; a spatial block's QK^T and its product with v 2 x 46,080;
    a channel block's Gram and product 2 x 5,400; a block's depthwise convs
    and spatial gate 1,620 + 3,240 + 1,991; a group's conv 291,600;
    conv_after_body 291,600; conv_before_upsample 103,680; the head
    147,456 + 589,824 + 27,648); a 1080p frame 69.17 TFLOP, 10% of it the
    window attention; 14,802,051 parameters."""
    cfg = Cell(DAT_CELL).config
    assert forward_ops(cfg, 1, 1) == 2 * 16_678_584
    assert abs(forward_ops(cfg, 1080, 1920) - 69.1694e12) < 1e8
    ops = layer_ops(cfg, 1080, 1920)
    assert 0.09 < ops["win_attn"] / sum(ops.values()) < 0.11
    assert chan_attn_work(2, 3, 12, 6, es=2) == (2 * 2 * 6 * 12, 2.0 * 6 * (12 * 6 + 24))
    assert ref.n_params(cfg) == cfg["parameters"] == 14_802_051


def test_frames_change_over_the_frame():
    """The cell's frames: in [0, 1], the same for the same seed, and each
    of the 3 x 4 regions with its own mean colour, where the smooth images
    of the other cells keep one mean over the frame."""
    from benchmark.entries.dat_whole import REGIONS, frames
    from benchmark.harness.synth import generator, images

    def region_means(x):
        n, h, w, _ = x.shape
        rh, rw = REGIONS
        return x.reshape(n, rh, h // rh, rw, w // rw, 3).mean(dim=(2, 4))

    a = frames(generator(2**31 + 7, "inputs", "cpu"), 2, 120, 160, "cpu")
    b = frames(generator(2**31 + 7, "inputs", "cpu"), 2, 120, 160, "cpu")
    assert a.shape == (2, 120, 160, 3) and torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    flat = images(generator(2**31 + 7, "inputs", "cpu"), 2, 120, 160, "cpu")
    spread = lambda x: float(region_means(x).flatten(1, 2).std(dim=1).mean())
    assert spread(a) > 0.1 > 0.05 > spread(flat), (spread(a), spread(flat))


class _Ctx:
    def __init__(self, cell, trace, calls, sizes, seconds):
        self.cell, self.trace = cell, trace
        self.entry = type("E", (), {"spans": type("S", (), {"model_calls": calls})()})()
        self.window = Window()
        self.window.sizes, self.window.end = sizes, seconds


def test_readers_on_a_synthetic_trace():
    """A window attention kernel of 40 ms, the channel sums' two kernels of
    10 ms and a conv of 50 ms in a 1 s window, one 1080 x 1920 request: the
    win_attn roofline is the least time of 18 attentions over 40 ms, the
    chan_attn roofline that of 18 sums' bytes over 10 ms, the shares 40 and
    10 of 100 busy ms, the mfu 69.17 TFLOP over 1 s at 989 TFLOP/s."""
    cell = Cell(DAT_CELL)
    ms = 1_000_000
    device = [("void (anonymous namespace)::win_attn_bf16<8, 32, 8, 32>(...)", 0, 40 * ms, True),
              ("(anonymous namespace)::chan_attn_reduce_bf16(...)", 40 * ms, 48 * ms, True),
              ("(anonymous namespace)::chan_attn_sum(...)", 48 * ms, 50 * ms, True),
              ("conv3x3_wgmma_kernel", 50 * ms, 100 * ms, True)]
    ctx = _Ctx(cell, Trace(device, []), [(1, 1080, 1920, "full")], [(1080, 1920)], 1.0)
    c, px = 180, 1080 * 1920
    want = 18 * max(2 * 4 * px * c / 3.35e12, 4.0 * px * 256 * c / 989e12)
    read = lambda name, cx=ctx: load_module("metrics", name).read(cx)
    assert read("win_attn_roofline.dat_frame1080") == pytest.approx(100.0 * want / 0.040)
    sums = 18 * max(2 * 2 * px * c / 3.35e12, 2.0 * px * (c * 30 + 2 * c) / 989e12)
    assert read("chan_attn_roofline.dat_frame1080") == pytest.approx(100.0 * sums / 0.010)
    assert read("win_attn_share.dat_frame1080") == pytest.approx(40.0)
    assert read("chan_attn_share.dat_frame1080") == pytest.approx(10.0)
    assert read("mfu.serve.dat_frame1080") == pytest.approx(
        100.0 * forward_ops(cell.config, 1080, 1920) / 989e12)
    empty = _Ctx(cell, Trace(device[3:], []), [(1, 1080, 1920, "full")], [(1080, 1920)], 1.0)
    for name in ("win_attn_roofline", "win_attn_share", "chan_attn_roofline", "chan_attn_share"):
        assert read(f"{name}.dat_frame1080", empty) is None


def test_epoch_readers_on_a_synthetic_trace():
    """Two loader waits of 100 and 300 ms and two checkpoints of 40 and 60
    ms in a 2 s window: a 20% wait share and 50 ms a checkpoint; a trace
    without the program's spans (the parent's) reads None."""
    ms = 1_000_000
    host = [("sisr.loader.wait", 0, 100 * ms, 1), ("sisr.loader.wait", 500 * ms, 800 * ms, 1),
            ("sisr.ckpt.save", 900 * ms, 940 * ms, 1), ("sisr.ckpt.save", 1 * 10**9,
                                                        1060 * ms, 1)]
    ctx = _Ctx(Cell(EPOCH_CELL), Trace([("k", 0, ms, True)], host), [], [], 2.0)
    assert load_module("metrics", "loader_wait_share.epoch").read(ctx) == pytest.approx(20.0)
    assert load_module("metrics", "checkpoint_ms.epoch").read(ctx) == pytest.approx(50.0)
    bare = _Ctx(Cell(EPOCH_CELL), Trace([("k", 0, ms, True)], []), [], [], 2.0)
    assert load_module("metrics", "loader_wait_share.epoch").read(bare) is None
    assert load_module("metrics", "checkpoint_ms.epoch").read(bare) is None


def test_benchmark_lists_the_new_cells():
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[DAT_CELL]["config"] == "dat" and cells[DAT_CELL]["chips"] == 1
    assert cells[EPOCH_CELL]["traffic"] == "epoch.f32" and cells[EPOCH_CELL]["chips"] == 1
    assert {m["name"] for m in Cell(DAT_CELL).per_layer} == {
        "mfu.serve.dat_frame1080", "idle_share.serve.dat_frame1080",
        "win_attn_roofline.dat_frame1080", "win_attn_share.dat_frame1080",
        "chan_attn_roofline.dat_frame1080", "chan_attn_share.dat_frame1080",
        "kernel_host_us.dat_frame1080"}
    assert {m["name"] for m in Cell(EPOCH_CELL).per_layer} == {
        "loader_wait_share.epoch", "checkpoint_ms.epoch", *(
            f"{m}.train.psnr" for m in ("idle_share", "mfu", "launches_per_step",
                                        "optimizer_ms", "forward_ms", "backward_ms",
                                        "recompute_ms", "derive_ms", "vjp_replay_share"))}
    assert {m["name"] for m in Cell(EPOCH_CELL).end_to_end} == {"train_mps.psnr", "setup_s"}


@pytest.mark.parametrize("name", [DAT_CELL, EPOCH_CELL])
def test_sound_tiny_run_is_correct(name):
    res = _run(name)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in tiny(name).end_to_end}
    if name == EPOCH_CELL:
        assert res["checks"]["ckpt_gap"]["value"] == 0.0


def test_fp8_control_is_not_correct():
    for seed in (3, 2**31 + 5):
        out = control(tiny(DAT_CELL), seed, device="cpu")
        assert out["precision"] == "fp8" and out["correct"] is False


def _spatial_fault(kind):
    """The program's window attention replaced by the reference's with
    ``kind`` planted, for DAT's two-branch call (HAT's calls untouched)."""
    plain = wa.win_attn_reference

    def fault(qkv, bias, heads, window, shift=0, key_window=0, branches=1, align=0):
        if branches != 2:
            return plain(qkv, bias, heads, window, shift, key_window, branches, align)
        biases = bias.reshape(2, heads, *bias.shape[-2:])
        return ref.spatial(Ops(Precision()), qkv, biases, 2 * heads, window,
                           tuple(shift) != (0, 0), kind)
    return fault


def _tile_sums(qkv, heads):
    """The channel attention's sums over the top-left 8 x 8 pixels: 2% of
    the tiny frame, as a 192 x 192 tile of TiledSR is of a 1080p frame."""
    return ca.chan_attn_reference(qkv[:, :8, :8], heads)


@pytest.mark.parametrize("kind", ["sound", "pad_masked", "no_mask", "axes_swapped", "tile"])
def test_planted_fault_reads_over_the_limit(kind, monkeypatch):
    """The reference's own spatial attention in the program's place reads
    correct ('sound'); each fault planted there, or in the channel sums,
    reads over a limit."""
    if kind == "tile":
        monkeypatch.setattr(ca.CHAN_ATTN, "plain", _tile_sums)
    else:
        monkeypatch.setattr(wa, "win_attn_reference",
                            _spatial_fault("" if kind == "sound" else kind))
    res = _run(DAT_CELL)
    over = [n for n, c in res["checks"].items() if c["value"] > c["limit"]]
    assert (res["correct"] is True) == (kind == "sound"), (kind, res["checks"])
    assert bool(over) == (kind != "sound"), (kind, res["checks"])


def test_stale_checkpoint_reads_a_ckpt_gap(monkeypatch):
    """A checkpoint written from a copy of the weights taken before the
    epoch's steps (a stale state) reads a ckpt_gap above its limit of 0."""
    from sisr_tpu_torch.experiments import experiment as ex

    real = ex.Experiment.save_model_weights
    stale = {}

    def save(self, path):
        model = self.state.model
        if not stale:
            stale.update({k: v.clone() for k, v in model.state_dict().items()})
        now = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(stale)
        real(self, path)
        model.load_state_dict(now)

    monkeypatch.setattr(ex.Experiment, "train_steps", _first_step_snapshot(stale))
    monkeypatch.setattr(ex.Experiment, "save_model_weights", save)
    res = _run(EPOCH_CELL)
    c = res["checks"]["ckpt_gap"]
    assert res["correct"] is False and c["value"] > c["limit"], res["checks"]


def _first_step_snapshot(stale):
    from sisr_tpu_torch.experiments import experiment as ex

    real = ex.Experiment.train_steps

    def train_steps(self):
        if not stale:
            stale.update({k: v.clone() for k, v in self.state.model.state_dict().items()})
        yield from real(self)
    return train_steps
