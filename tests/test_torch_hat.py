"""HAT on the port (``models/hat.py``) against its plain float32 reference
(``models/hat_reference.py``, HAT's own formulation: rolls, window
partitions, Swin's mask, ``F.unfold``) on the CPU, where every kernel runs
its plain version: the forward, one L1 + Adam step's loss and every
gradient, the window attention's shift mask and overlapping zero keys
against a pixel-by-pixel loop, the published widths' parameter count, the
runner (``main("hat")``: one epoch, eval and test) and ``infer --arch hat``
through ``TiledSR``.  The kernel itself is held to the plain version on a
card in ``test_torch_win_attn.py``.

Tiny model: embed 24, 2 heads (d = 12), window 4 (key window 6), depths
(2, 2), squeeze 6 (HAT's 30 would leave 24 channels no gate), on 18 x 22
inputs that need window padding.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sisr_tpu_torch.models import hat_reference as ref
from sisr_tpu_torch.models.hat import HAT, rpi_oca, rpi_sa, _dense_bias
from sisr_tpu_torch.ops.kernels.win_attn import WIN_ATTN, win_attn_reference

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=4, squeeze_factor=6)


def _model(seed=3):
    from sisr_tpu_torch.infer import synth_weights

    model = HAT(**TINY)
    synth_weights(model, seed)
    return model


def _lr(seed=0, shape=(2, 18, 22, 3)):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def test_forward_matches_the_reference():
    """float32 on both sides; the port's LayerNorm takes the variance as
    E[x^2] - E[x]^2 and its convs and Linears sum in another order, so the
    two agree to float32 round-off grown through 4 blocks of 2 groups:
    1e-5 of the output's scale (its range is ~3)."""
    model, x = _model(), _lr()
    with torch.no_grad():
        got = model(x)
        want = ref.forward(dict(model.named_parameters()), x, TINY)
    assert got.shape == (2, 72, 88, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * float(want.abs().max()),
                               rtol=0)


def test_train_step_loss_and_every_gradient():
    """One step of the runner's own step (``make_train_step``: L1, Adam
    2e-4, betas (0.9, 0.99)) against the reference's loss, its gradient of
    every parameter, and Adam's update of every parameter from them.  The
    loss agrees to 1e-6 relative (float32 means of 30,000 values); each
    gradient within 1e-4 of that leaf's norm plus 1e-7 of the largest
    leaf's (round-off of sums over the batch, worst at the small bias
    tables); every parameter after the step within 1e-5, a twentieth of
    the step: Adam's first step moves an element by lr g / (|g| + 1e-8),
    2e-4 for most, and an element whose gradient is near 1e-8 moves by a
    share that the gradient's round-off changes."""
    from sisr_tpu_torch.configs.model_config import get_optimizer
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    model = _model(5).train()
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    lr_img = _lr(1)
    hr = torch.from_numpy(np.random.default_rng(2).random((2, 72, 88, 3), dtype=np.float32))
    kw = {"betas": [0.9, 0.99], "weight_decay": 0}
    opt = get_optimizer("Adam", model.parameters(), 2e-4, kw)
    loss = float(make_train_step(model, l1_loss, opt)(lr_img, hr))

    P = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    want_loss, grads = ref.l1_grads(P, lr_img, hr, TINY)
    assert abs(loss - float(want_loss)) <= 1e-6 * float(want_loss)
    top = max(float(g.norm()) for g in grads.values())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        err = float((p.grad - grads[name]).norm())
        assert err <= 1e-4 * float(grads[name].norm()) + 1e-7 * top, (name, err)
    ref_opt = get_optimizer("Adam", list(P.values()), 2e-4, kw)
    for k, v in P.items():
        v.grad = grads[k]
    ref_opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), P[name].detach().numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def _pixel_loop(qkv, bias, heads, ws, shift, wk):
    """The attention pixel by pixel from its definition: each query's keys
    listed by coordinates on the unrolled map (zeros past the map), the
    mask from the regions of the rolled map, in float64."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = qkv.double().split(c, -1)
    o = (wk - ws) // 2

    def region(y, n):
        return 0 if y < n - ws else (1 if y < n - shift else 2)

    out = torch.zeros(b, h, w, c, dtype=torch.float64)
    for bi in range(b):
        for Y in range(h):
            for X in range(w):
                wy, wx, iy, ix = Y // ws, X // ws, Y % ws, X % ws
                qy, qx = (Y + shift) % h, (X + shift) % w
                keys = []
                for jy in range(wk):
                    for jx in range(wk):
                        ky, kx = wy * ws - o + jy, wx * ws - o + jx
                        if wk == ws:
                            ky, kx = (ky + shift) % h, (kx + shift) % w
                        inside = 0 <= ky < h and 0 <= kx < w
                        mask = 0.0
                        if shift and (region(Y, h), region(X, w)) != (
                                region(wy * ws + jy, h), region(wx * ws + jx, w)):
                            mask = -100.0
                        keys.append((ky, kx, inside, jy * wk + jx, mask))
                for hd in range(heads):
                    sl = slice(hd * d, (hd + 1) * d)
                    qv = q[bi, qy, qx, sl]
                    logits, vals = [], []
                    for ky, kx, inside, j, mask in keys:
                        kv = k[bi, ky, kx, sl] if inside else torch.zeros(d, dtype=torch.float64)
                        vv = v[bi, ky, kx, sl] if inside else torch.zeros(d, dtype=torch.float64)
                        logits.append(float(qv @ kv) * d ** -0.5
                                      + float(bias[hd, iy * ws + ix, j]) + mask)
                        vals.append(vv)
                    p = torch.softmax(torch.tensor(logits, dtype=torch.float64), 0)
                    out[bi, qy, qx, sl] = sum(pi * vi for pi, vi in zip(p, vals))
    return out


@pytest.mark.parametrize("shift,wk", [(0, 4), (2, 4), (0, 6)],
                         ids=["unshifted", "shifted", "overlapping"])
def test_window_attention_against_a_pixel_loop(shift, wk):
    """The plain version (what the kernel is held to) on an 8 x 12 map:
    the shift's roll and mask, and the overlapping windows' zero keys at
    the map's edge, which enter the softmax with the bias alone.  Leaving
    out either (no mask; the edge keys dropped from the softmax) moves the
    result by far more than the float32 round-off allowed (1e-5)."""
    g = torch.Generator().manual_seed(shift + wk)
    heads, ws = 2, 4
    qkv = torch.randn(1, 8, 12, 3 * 2 * 6, generator=g)
    bias = torch.randn(heads, ws * ws, wk * wk, generator=g)
    got = win_attn_reference(qkv, bias, heads, ws, shift, wk).double()
    want = _pixel_loop(qkv, bias, heads, ws, shift, wk)
    assert float((got - want).abs().max()) < 1e-5
    if shift:
        unmasked = win_attn_reference(torch.roll(qkv, (-shift, -shift), (1, 2)), bias, heads,
                                      ws)
        unmasked = torch.roll(unmasked, (shift, shift), (1, 2)).double()
        assert float((unmasked - want).abs().max()) > 1e-2
    if wk > ws:
        # the top-left window's keys past the map pushed out of the softmax
        o = (wk - ws) // 2
        jy, jx = torch.arange(wk * wk) // wk, torch.arange(wk * wk) % wk
        dropped = bias.clone()
        dropped[:, :, (jy < o) | (jx < o)] = -1e4
        top_left = win_attn_reference(qkv, dropped, heads, ws, 0, wk).double()[:, :ws, :ws]
        assert float((top_left - want[:, :ws, :ws]).abs().max()) > 1e-2


def test_kernel_function_gradients_are_the_plain_vjp():
    """``WIN_ATTN`` with the plain version standing in for the kernel:
    its backward (the plain version recomputed from the saved qkv and
    bias) gives autograd's gradients of the plain version, for the shifted
    and the overlapping call."""
    fn = WIN_ATTN.with_kernel(win_attn_reference)
    g = torch.Generator().manual_seed(7)
    for shift, wk in ((2, 4), (0, 6)):
        qkv = torch.randn(2, 8, 8, 36, generator=g, requires_grad=True)
        bias = torch.randn(2, 16, wk * wk, generator=g, requires_grad=True)
        dy = torch.randn(2, 8, 8, 12, generator=g)
        got = torch.autograd.grad(fn(qkv, bias, 2, 4, shift, wk), (qkv, bias), dy)
        want = torch.autograd.grad(win_attn_reference(qkv, bias, 2, 4, shift, wk),
                                   (qkv, bias), dy)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_position_indices_and_dense_bias():
    """HAT's two index buffers (its ``calculate_rpi_sa`` and
    ``calculate_rpi_oca``, the latter from -880 to 640 at 16 and 24, every
    offset its own row once indexing wraps the negatives) and the dense
    bias gathered from a table."""
    assert torch.equal(rpi_sa(16), ref.calculate_rpi_sa(16))
    oca = rpi_oca(16, 24)
    assert torch.equal(oca, ref.calculate_rpi_oca(16, 24))
    assert (int(oca.min()), int(oca.max())) == (-880, 640)
    assert len(set((oca % 1521).flatten().tolist())) == 1521
    table = torch.randn(1521, 6)
    bias = _dense_bias(table, oca)
    assert bias.shape == (6, 256, 576)
    assert torch.equal(bias[2, 17, 300], table[int(oca[17, 300]), 2])


def test_spans_of_a_traced_forward():
    """Under a profiler a forward opens ``sisr.hat.cab`` once a HAB and
    ``sisr.hat.pad`` twice (the pad and the crop)."""
    model = _model()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(_lr(shape=(1, 18, 22, 3)))
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("sisr.hat.")}
    assert counts == {"sisr.hat.cab": sum(TINY["depths"]), "sisr.hat.pad": 2}


def test_published_widths_on_the_meta_device():
    """HAT x4 at its published widths: 20,772,507 parameters under HAT's
    names, and the two index buffers."""
    with torch.device("meta"):
        model = HAT()
    assert sum(p.numel() for p in model.parameters()) == 20_772_507
    names = set(model.state_dict())
    for name in ("conv_first.weight", "patch_embed.norm.weight",
                 "layers.5.residual_group.blocks.5.attn.relative_position_bias_table",
                 "layers.0.residual_group.blocks.1.conv_block.cab.3.attention.3.bias",
                 "layers.2.residual_group.overlap_attn.relative_position_bias_table",
                 "layers.2.residual_group.overlap_attn.mlp.fc2.weight", "layers.3.conv.bias",
                 "norm.weight", "conv_after_body.weight", "conv_before_upsample.0.weight",
                 "upsample.0.weight", "upsample.2.weight", "conv_last.bias",
                 "relative_position_index_SA", "relative_position_index_OCA"):
        assert name in names, name
    assert model.layers[0].residual_group.blocks[1].shift == 8
    assert model.layers[0].residual_group.overlap_attn.key_window == 24


def _make_data(root):
    rng = np.random.default_rng(0)
    for split, n, size in (("train", 2, (272, 264)), ("eval", 1, (88, 72)),
                           ("test", 1, (88, 72))):
        d = root / "data" / split / ("setA" if split == "train" else "setB")
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)).save(
                d / f"im{i}.png")
    return root


def test_main_hat_trains_evaluates_and_tests(tmp_path, monkeypatch):
    """``python -m sisr_tpu_torch hat``'s ``main``: one tiny epoch with its
    evaluation (the whole image through ``model(x)``), then test mode on
    the best checkpoint."""
    from sisr_tpu_torch.__main__ import main

    root = _make_data(tmp_path)
    monkeypatch.chdir(root)
    kw = dict(loss="l1", epochs=1, is_augment=True, batch_size=2,
              test_model_name="best_psnr_ssim_lpips_model.pth", embed_dim=24,
              depths=[2, 2], num_heads=[2, 2], mlp_ratio=2, window_size=4, squeeze_factor=6,
              train_data_name_list=["setA"], eval_data_name_list=["setB"],
              test_data_name_list=["setB"], loader_workers=0, device="cpu", progress=False,
              # the HiT-SIR options the command line always passes
              is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
              is_fusion=True, base_win_size=[8, 8], upsampler="nearest+conv",
              hier_win_ratios=[0.5, 1])
    exp = main("hat", False, **kw)
    assert isinstance(exp.model, HAT) and exp._banded_eval is None
    folder = "hat_loss(l1)_embed_dim(24)_len(depths)(2)_window(4)"
    assert (root / "weights" / folder / "best_psnr_ssim_lpips_model.pth").exists()
    rows = (root / "logs" / folder / "psnr_ssim_lpips_log.txt").read_text().splitlines()
    assert len(rows) == 1 and 3 < float(rows[0].split()[1]) < 60
    main("hat", True, **kw)
    assert (root / "results" / folder / "best_psnr_ssim_lpips_model" / "setB" /
            "test_log.txt").exists()


def test_infer_arch_hat_through_tiled_sr(tmp_path, monkeypatch):
    """``python -m sisr_tpu_torch.infer --arch hat`` builds HAT, falls back
    to seeded weights without a checkpoint, and serves the image through
    ``TiledSR``; a checkpoint in HAT's ``params_ema`` layout loads strictly
    and gives the same image."""
    from sisr_tpu_torch import infer

    monkeypatch.setattr(infer, "create_hat", lambda dtype, device: HAT(**TINY).eval())
    calls = []
    real = infer.upscale
    monkeypatch.setattr(infer, "upscale", lambda m, lr, tile: calls.append(
        (type(m).__name__, tuple(lr.shape), tile)) or real(m, lr, tile))
    src = tmp_path / "lr.png"
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (20, 26, 3),
                                                      dtype=np.uint8)).save(src)
    out = infer.main(str(src), str(tmp_path / "sr.png"), str(tmp_path / "none.pth"),
                     tile="24", device="cpu", arch="hat")
    first = np.asarray(Image.open(out))
    assert first.shape == (80, 104, 3) and calls == [("HAT", (20, 26, 3), "24")]
    model = HAT(**TINY)
    infer.load_model_weights(model, str(tmp_path / "none.pth"))
    torch.save({"params_ema": model.state_dict()}, tmp_path / "hat.pth")
    out2 = infer.main(str(src), str(tmp_path / "sr2.png"), str(tmp_path / "hat.pth"),
                      tile="24", device="cpu", arch="hat")
    np.testing.assert_array_equal(np.asarray(Image.open(out2)), first)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_no_kernel_and_no_jax():
    """``hat_reference.py`` imports torch and the standard library alone:
    nothing of the port (its kernels above all) and nothing of JAX."""
    names = set(_imports(REPO / "sisr_tpu_torch" / "models" / "hat_reference.py"))
    assert names and {n.split(".")[0] for n in names} <= {"__future__", "math", "contextlib",
                                                          "typing", "torch"}
