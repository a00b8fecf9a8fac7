"""The frozen plain reference against the program's plain CPU path at a
tiny width: the generator's forward (whole and banded head), the
discriminator with its spectral norms, the perceptual loss.  The test
imports both; the reference itself imports nothing of the program."""

import torch

from benchmark.harness import program
from benchmark.harness.synth import generator, images, synth
from benchmark.reference import gan as gref
from benchmark.reference import hitsir as ref
from benchmark.reference.precision import Precision
from benchmark.tests.tiny import tiny_cell


def test_generator_forward_matches_the_plain_path():
    cfg = tiny_cell("hitsir_pro.photos.bf16").config
    P = synth(ref.manifest(cfg), 2**31 + 1, "generator", "cpu")
    model = program.hitsir(cfg, torch.float32, P, "cpu")
    assert ref.n_params(cfg) == sum(p.numel() for p in model.parameters())
    x = images(generator(3, "inputs", "cpu"), 2, 36, 28, "cpu")
    with torch.no_grad():
        want = model(x)
        got = ref.forward(P, cfg, x)
        banded = ref.forward(P, cfg, x, head_rows=8)
    assert (got - want).abs().max() < 1e-5
    assert (banded - got).abs().max() < 1e-6


def test_flagship_manifest_is_the_published_size():
    cfg = tiny_cell("hitsir_pro.photos.bf16").config
    full = dict(cfg, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6,
                hier_win_ratios=[0.5, 1, 2, 4, 6, 8, 10, 12])
    assert ref.n_params(full) == 10220014


def test_discriminator_and_perceptual_match_the_program():
    from sisr_tpu_torch.train.losses import gan_loss

    ndf = 8
    dw = synth(gref.d_manifest(ndf), 4, "discriminator", "cpu")
    vw = synth(gref.vgg_manifest(), 4, "vgg", "cpu")
    d = program.discriminator({"gan": {"ndf": ndf}}, dw, "cpu")
    perc = program.perceptual(vw, "cpu")
    buffers = {k: v.clone() for k, v in dw.items() if k.endswith(("weight_u", "weight_v"))}
    D = {k: v for k, v in dw.items() if k not in buffers}
    x = images(generator(6, "inputs", "cpu"), 2, 32, 32, "cpu")
    y = images(generator(7, "inputs", "cpu"), 2, 32, 32, "cpu")
    o = ref.Ops(Precision())
    with torch.no_grad():
        for _ in range(3):                     # the power iterations advance alike
            want, got = d(x), gref.discriminator(o, D, buffers, x, ndf)
            assert (got - want).abs().max() < 1e-5
        assert abs(float(gan_loss(want, True)) - float(gref.bce(got, True))) < 1e-6
        assert abs(float(perc(x, y)) - float(gref.perceptual_loss(o, vw, x, y))) < 1e-5
    assert torch.allclose(buffers["conv4.weight_u"], d.conv4.weight_u, atol=1e-6)


def test_adam_matches_torch():
    p = torch.randn(5, 3)
    q = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=2e-5, betas=(0.9, 0.99), eps=1e-8)
    mine = gref.Adam({"p": p}, 2e-5, (0.9, 0.99), 1e-8)
    for k in range(3):
        g = torch.randn(5, 3, generator=torch.Generator().manual_seed(k))
        q.grad = g.clone()
        opt.step()
        mine.step({"p": g})
    assert torch.allclose(p, q.detach(), atol=1e-9, rtol=0)


def test_lower_precisions_round_as_named():
    t = torch.tensor([1.0 + 2 ** -12, 3.0, 1000.3])
    assert Precision("float32")(t) is t
    assert float(Precision("bfloat16")(t)[2]) == 1000.0
    f8 = Precision("fp8")(t)
    assert abs(float(f8[2]) - 1000.3) < 1e-2          # the largest maps to 448 exactly
    assert abs(float(f8[1]) - 3.0) > 1e-2             # 3 mantissa bits


def test_exact_turns_tf32_off_and_restores_the_flags():
    from benchmark.reference.precision import exact

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with exact():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
