"""The one generator: inputs and orders are fixed by the seed, and the
photo mix's rounds hold every size once."""

import torch

from benchmark.harness.spec import Cell
from benchmark.harness.synth import generator, images, synth
from benchmark.harness.traffic import check_sample, serve_sequence
from benchmark.reference import hitsir as ref

SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)


def test_serve_sequence_is_fixed_by_the_seed():
    traffic = Cell("hitsir_pro.photos.bf16").traffic
    for seed in SEEDS:
        assert serve_sequence(traffic, seed, 200) == serve_sequence(traffic, seed, 200)
    assert serve_sequence(traffic, 1, 70) != serve_sequence(traffic, 2, 70)


def test_photo_rounds_hold_each_size_once():
    traffic = Cell("hitsir_pro.photos.bf16").traffic
    n = len(traffic["sizes"])
    for seed in SEEDS:
        seq = serve_sequence(traffic, seed, 10 * n)
        for r in range(10):
            assert sorted(s for s, _ in seq[r * n:(r + 1) * n]) == list(range(n))


def test_sample_holds_the_largest_request():
    traffic = Cell("hitsir_pro.photos.bf16").traffic
    largest = max(range(len(traffic["sizes"])),
                  key=lambda s: traffic["sizes"][s][0] * traffic["sizes"][s][1])
    for seed in SEEDS:
        seq = serve_sequence(traffic, seed, 1000)
        sample = check_sample(traffic, seed, seq)
        assert sample == check_sample(traffic, seed, seq)
        assert any(seq[i][0] == largest for i in sample)
        assert len(sample) >= traffic["check"]["sample"]


def test_weights_and_images_are_fixed_by_the_seed():
    cfg = dict(Cell("hitsir_pro.train.f32").config, embed_dim=24, depths=[1], num_heads=[2])
    man = ref.manifest(cfg)
    a, b = synth(man, 2**31 + 9, "generator", "cpu"), synth(man, 2**31 + 9, "generator", "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = synth(list(reversed(man)), 2**31 + 9, "generator", "cpu")
    assert all(torch.equal(a[k], c[k]) for k in a)       # order of the manifest is free
    d = synth(man, 2**31 + 10, "generator", "cpu")
    assert not torch.equal(a["conv_last.weight"], d["conv_last.weight"])
    x = images(generator(5, "inputs", "cpu"), 2, 20, 24, "cpu")
    y = images(generator(5, "inputs", "cpu"), 2, 20, 24, "cpu")
    assert torch.equal(x, y) and x.shape == (2, 20, 24, 3)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
