"""The frozen work counters against hand counts, and the tile
redundancy of one round of the photo mix."""

import pytest
import torch

from benchmark.harness.spec import Cell, load_module
from benchmark.harness.loops import Window
from benchmark.work.hitsir import conv_ops, forward_ops, layer_ops, scc_work, tail_work
from benchmark.work.nets import discriminator_ops, vgg_ops


def test_tail_and_scc_work_by_hand():
    # fc1 (4 -> 8), 5x5 depthwise on 8, fc2 (8 -> 4) on a 2 x 3 map
    nbytes, ops = tail_work(2, 3, c=4, ch=8, es=2)
    assert ops == 2.0 * 6 * (4 * 8 + 25 * 8 + 8 * 4)
    assert nbytes == 2 * (3 * 6 * 4 + (2 * 4 * 8 + 25 * 8 + 2 * 8 + 6 * 4))
    _, ops_stats = tail_work(2, 3, c=4, ch=8, es=2, stats=True)
    assert ops_stats == ops
    # window 8 at base 8 (one base cell a token), C = 12, 2 heads (d = 3)
    _, ops = scc_work(8, 8, 8, base=8, c=12, heads=2, es=2)
    per_token = 18 * 12 + 12 * 6 + 36 + 2 * 64 * 6 + 36 + 64 * 6 + 36 + 144
    assert ops == 2.0 * 64 * per_token + 2.0 * 1 * 64 * 6 * 3


def test_forward_ops_flagship():
    cfg = Cell("hitsir_pro.photos.bf16").config
    per_px = forward_ops(cfg, 64, 64) / (64 * 64)
    assert 25e6 < per_px < 27e6                 # 26 MFLOP an LR pixel
    ops = layer_ops(cfg, 10, 10)
    assert ops["conv3x3"] == 7 * conv_ops(10, 10, 180, 180) + conv_ops(10, 10, 180, 64)
    assert ops["head"] == 36 * conv_ops(10, 10, 64, 64) + 16 * conv_ops(10, 10, 64, 3)


def test_gan_network_ops_by_hand():
    assert vgg_ops(2, 2) == 2.0 * 4 * 9 * (3 * 64 + 64 * 64) + 2.0 * 1 * 9 * (
        64 * 128 + 128 * 128)                    # the two 1x1 levels beyond the first pool
    d = discriminator_ops(8, 8, ndf=1)
    hand = (2 * 64 * 9 * 3 + 2 * 16 * 16 * 1 * 2 + 2 * 4 * 16 * 2 * 4 + 2 * 1 * 16 * 4 * 8
            + 2 * 4 * 9 * 8 * 4 + 2 * 16 * 9 * 4 * 2 + 2 * 64 * 9 * 2 * 1 + 2 * 2 * 64 * 9 * 1
            + 2 * 64 * 9 * 1)
    assert d == hand


class _Spans:
    def __init__(self):
        self.model_calls = []


class _Ctx:
    pass


def test_tile_redundancy_of_one_round():
    from sisr_tpu_torch.parallel.tiling import TiledSR

    cell = Cell("hitsir_pro.photos.bf16")
    spans = _Spans()

    def model(x):
        spans.model_calls.append((x.shape[0], x.shape[1], x.shape[2], "full"))
        return torch.zeros(x.shape[0], 4 * x.shape[1], 4 * x.shape[2], 3)

    win = Window()
    runner = TiledSR(model, scale=4, tile=cell.traffic["tile"])
    for h, w in cell.traffic["sizes"]:
        runner(torch.zeros(h, w, 3))
        win.lr_pixels += h * w
    ctx = _Ctx()
    ctx.trace, ctx.window, ctx.entry = object(), win, _Ctx()
    ctx.entry.spans = spans
    value = load_module("metrics", "tile_redundancy.photos").read(ctx)
    assert len(spans.model_calls) == 32
    assert value == pytest.approx(1179648 / 797248)
    assert round(value, 2) == 1.48


def test_a_metric_split_by_cell_is_read_by_its_familys_reader():
    assert load_module("metrics", "serve_mps.frame1080") is not None
    assert load_module("metrics", "idle_share.train.psnr").__file__.endswith("idle_share.py")
    assert load_module("metrics", "mfu.train.gan").__file__.endswith("mfu.train.py")
    with pytest.raises(FileNotFoundError):
        load_module("metrics", "no_such_metric.frame1080")
