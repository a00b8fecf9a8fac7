"""DAT on the port (``models/dat.py``) against its plain float32 reference
(``models/dat_reference.py``, DAT's own formulation: tokens, ``F.pad`` with
zeros, rolls, ``img2windows``, the mask from slices, ``F.normalize``) on the
CPU, where every kernel runs its plain version: the forward, one L1 + Adam
step's loss and every gradient with BatchNorm on the batch's statistics,
both spatial branches of the window attention's plain version against
DAT's literal pad, roll, partition and mask, the published widths'
parameter count and names, the traced spans, the runner (``main("dat")``:
one epoch, eval and test, and ``train_steps`` a step at a time) and
``infer --arch dat`` through ``TiledSR``.  The kernels themselves are held
to their plain versions on a card in ``test_torch_win_attn.py`` and
``test_torch_chan_attn.py``.

Tiny model: embed 60, 2 heads (one a branch, d = 30), depths (2, 2): an
unshifted spatial block, a shifted one (group 1, block 0) and two channel
blocks, on 40 x 48 inputs, which pad to 64 x 64 for the 8 x 32 windows.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sisr_tpu_torch.models import dat_reference as ref
from sisr_tpu_torch.models.dat import DAT, AdaptiveSpatialAttention, shifted
from sisr_tpu_torch.ops.kernels.win_attn import WIN_ATTN, win_attn_reference

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(embed_dim=60, depth=(2, 2), num_heads=(2, 2))
CFG = dict(ref.DAT_X4, **TINY)


def _stats(module, seed):
    """BatchNorm running statistics away from 0 and 1, so that no
    BatchNorm is the identity in inference."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.2 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(torch.exp(0.4 * torch.randn(m.running_var.shape,
                                                                generator=g)))
    return module


def _model(seed=3):
    from sisr_tpu_torch.infer import synth_weights

    model = DAT(**TINY)
    synth_weights(model, seed)
    return _stats(model, seed)


def _lr(seed=0, shape=(2, 40, 48, 3)):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def test_forward_matches_the_reference():
    """float32 on both sides (BatchNorm on running statistics, folded into
    the convs on the port's side): within 1e-5 of the output's scale."""
    model, x = _model(), _lr()
    with torch.no_grad():
        got = model(x)
        want = ref.forward(dict(model.state_dict()), x, CFG)
    assert got.shape == (2, 160, 192, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * float(want.abs().max()),
                               rtol=0)


def test_train_step_loss_and_every_gradient():
    """One step of the runner's own step (``make_train_step``: L1, Adam
    2e-4, betas (0.9, 0.99), ``deterministic=False``: BatchNorm on the
    batch's statistics) against the reference's loss and its gradient of
    every parameter, both sides in float64: float32's round-off, grown
    through BatchNorm on a batch of 2 and the whole-image normalisation of
    the channel attention, reaches 5e-4 of a leaf's norm, which would hide
    a fault of that size.  The loss to 1e-9 relative, each gradient within
    1e-5 of that leaf's norm plus 1e-8 of the largest leaf's (the biases
    before a BatchNorm and the last bias of the position MLP have a
    gradient of 0 up to round-off); every BatchNorm's running statistics
    moved by the step, as nn.BatchNorm2d's train mode does."""
    from sisr_tpu_torch.configs.model_config import get_optimizer
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    model = _model(5).to(torch.float64)
    model.dtype = torch.float64
    names = {k for k, _ in model.named_parameters()}
    P = {k: v.detach().clone().requires_grad_(k in names) for k, v in model.state_dict().items()}
    lr_img = _lr(1).double()
    hr = torch.from_numpy(np.random.default_rng(2).random((2, 160, 192, 3)))
    opt = get_optimizer("Adam", model.parameters(), 2e-4, {"betas": [0.9, 0.99],
                                                            "weight_decay": 0})
    loss = float(make_train_step(model, l1_loss, opt)(lr_img, hr))
    want_loss, grads = ref.l1_grads(P, lr_img, hr, CFG)
    assert abs(loss - float(want_loss)) <= 1e-9 * float(want_loss)
    top = max(float(g.norm()) for g in grads.values())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        err = float((p.grad - grads[name]).norm())
        assert err <= 1e-5 * float(grads[name].norm()) + 1e-8 * top, (name, err)
    key = "layers.0.blocks.0.attn.dwconv.1.running_mean"
    assert float((model.state_dict()[key] - P[key]).abs().max()) > 1e-4


@pytest.mark.parametrize("shift", [False, True], ids=["unshifted", "shifted"])
def test_spatial_branches_against_dat_literal(shift):
    """The window attention's plain version, both branches in one call
    (8 x 32 and 32 x 8 windows, the map zero-padded to 64 x 64 by the index
    arithmetic's rule), with the dense bias of the port's position MLP,
    against DAT's two ``Spatial_Attention`` calls as DAT makes them (F.pad,
    roll, img2windows, the mask from slices, windows2img, crop), at embed
    120, 2 heads a branch (d = 30), on a 40 x 48 map: within 1e-5."""
    from sisr_tpu_torch.infer import synth_weights

    torch.manual_seed(0)
    mod = AdaptiveSpatialAttention(120, 4, (8, 32), shift)
    synth_weights(mod, 7)
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 40, 48, 360, generator=g)
    with torch.no_grad():
        bias = torch.cat([a.dense_bias() for a in mod.attns])
        got = win_attn_reference(qkv, bias, 2, (8, 32), mod.shift, 0, 2, 32)
        tokens = qkv.reshape(2, 40 * 48, 3, 120).permute(2, 0, 1, 3)
        want = ref.spatial_branches(dict(mod.state_dict()), "", tokens, 40, 48, (8, 32), 2,
                                    (4, 16) if shift else None)
    assert got.shape == (2, 40, 48, 120)
    assert float((got.reshape(2, -1, 120) - want).abs().max()) < 1e-5


def test_kernel_function_gradients_are_the_plain_vjp():
    """``WIN_ATTN`` with the plain version standing in for the kernel, on
    DAT's two-branch call: its backward gives autograd's gradients of the
    plain version for qkv and the bias."""
    fn = WIN_ATTN.with_kernel(win_attn_reference)
    g = torch.Generator().manual_seed(7)
    qkv = torch.randn(2, 40, 48, 3 * 60, generator=g, requires_grad=True)
    bias = torch.randn(2, 256, 256, generator=g, requires_grad=True)
    dy = torch.randn(2, 40, 48, 60, generator=g)
    args = (1, (8, 32), (4, 16), 0, 2, 32)
    got = torch.autograd.grad(fn(qkv, bias, *args), (qkv, bias), dy)
    want = torch.autograd.grad(win_attn_reference(qkv, bias, *args), (qkv, bias), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_published_widths_on_the_meta_device():
    """DAT x4 at its published widths: 14,802,051 parameters under DAT's
    names, its buffers, its shifted blocks; a state dict holding DAT's
    stored masks of the shifted blocks loads strictly."""
    with torch.device("meta"):
        model = DAT()
    assert sum(p.numel() for p in model.parameters()) == 14_802_051
    names = set(model.state_dict())
    for name in ("conv_first.weight", "before_RG.1.weight", "layers.5.conv.bias",
                 "layers.0.blocks.0.attn.qkv.bias", "layers.0.blocks.0.attn.dwconv.1.running_var",
                 "layers.0.blocks.0.attn.channel_interaction.4.weight",
                 "layers.0.blocks.0.attn.spatial_interaction.3.bias",
                 "layers.0.blocks.0.attn.attns.1.pos.pos3.2.weight",
                 "layers.0.blocks.0.attn.attns.0.rpe_biases",
                 "layers.0.blocks.0.attn.attns.0.relative_position_index",
                 "layers.3.blocks.5.attn.temperature", "layers.2.blocks.4.ffn.sg.conv.weight",
                 "layers.2.blocks.4.ffn.sg.norm.bias", "norm.weight", "conv_after_body.weight",
                 "conv_before_upsample.0.weight", "upsample.0.weight", "upsample.2.weight",
                 "conv_last.bias"):
        assert name in names, name
    attn = model.layers[0].blocks[0].attn.attns
    assert tuple(attn[0].rpe_biases.shape) == (945, 2)
    assert (attn[0].H_sp, attn[0].W_sp, attn[1].H_sp, attn[1].W_sp) == (8, 32, 32, 8)
    assert [(i, j) for i in range(6) for j in (0, 2, 4) if shifted(i, j)] == [
        (0, 2), (1, 0), (1, 4), (2, 2), (3, 0), (3, 4), (4, 2), (5, 0), (5, 4)]
    assert model.layers[1].blocks[0].attn.shift == (4, 16)
    assert model.layers[0].blocks[0].attn.shift == (0, 0)
    small = _model()
    state = dict(small.state_dict())
    state["layers.1.blocks.0.attn.attn_mask_0"] = torch.zeros(16, 256, 256)
    state["layers.1.blocks.0.attn.attn_mask_1"] = torch.zeros(16, 256, 256)
    small.load_state_dict(state, strict=True)


def test_position_bias_against_dat_gather():
    """The dense bias the port derives (both branches' heads in turn) is
    DAT's ``pos[relative_position_index]`` from its ``DynamicPosBias`` at the
    published widths (pos_dim 5, 945 rows for 8 x 32)."""
    from sisr_tpu_torch.infer import synth_weights

    mod = AdaptiveSpatialAttention(180, 6, (8, 32), False)
    synth_weights(mod, 2)
    P = dict(mod.state_dict())
    with torch.no_grad():
        got = torch.cat([a.dense_bias() for a in mod.attns])
        for i, (hs, ws) in enumerate(((8, 32), (32, 8))):
            pos = ref.dynamic_pos_bias(P, f"attns.{i}.pos.", ref.rpe_biases(hs, ws))
            want = pos[ref.relative_position_index(hs, ws).view(-1)].view(256, 256, 3)
            assert torch.equal(got[3 * i:3 * i + 3], want.permute(2, 0, 1))
    assert mod.attns[0].pos.pos_proj.weight.shape == (5, 2)


def test_spans_of_a_traced_forward():
    """Under a profiler a forward opens ``sisr.dat.aim`` and
    ``sisr.dat.sgfn`` once a block."""
    model = _model()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(_lr(shape=(1, 40, 48, 3)))
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("sisr.dat.")}
    assert counts == {"sisr.dat.aim": 4, "sisr.dat.sgfn": 4}


def _make_data(root, n_train=2):
    rng = np.random.default_rng(0)
    for split, n, size in (("train", n_train, (272, 264)), ("eval", 1, (88, 72)),
                           ("test", 1, (88, 72))):
        d = root / "data" / split / ("setA" if split == "train" else "setB")
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)).save(
                d / f"im{i}.png")
    return root


KW = dict(loss="l1", epochs=1, is_augment=True, batch_size=2,
          test_model_name="best_psnr_ssim_lpips_model.pth", embed_dim=60, depths=[2, 2],
          num_heads=[2, 2], mlp_ratio=2, train_data_name_list=["setA"],
          eval_data_name_list=["setB"], test_data_name_list=["setB"], loader_workers=0,
          device="cpu", progress=False,
          # the HiT-SIR options the command line always passes
          is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True, is_fusion=True,
          base_win_size=[8, 8], upsampler="nearest+conv", hier_win_ratios=[0.5, 1])
FOLDER = "dat_loss(l1)_embed_dim(60)_len(depths)(2)_split(8x32)"


def test_main_dat_trains_evaluates_and_tests(tmp_path, monkeypatch):
    """``python -m sisr_tpu_torch dat``'s ``main``: one tiny epoch with its
    evaluation (the whole image through ``model(x)``), then test mode on
    the best checkpoint."""
    from sisr_tpu_torch.__main__ import main, parse_args

    assert parse_args(["dat"]).model == "dat"
    root = _make_data(tmp_path)
    monkeypatch.chdir(root)
    exp = main("dat", False, **KW)
    assert isinstance(exp.model, DAT) and exp._banded_eval is None
    assert exp.model.layers[0].blocks[0].ffn.fc1.out_features == 240
    assert (root / "weights" / FOLDER / "best_psnr_ssim_lpips_model.pth").exists()
    rows = (root / "logs" / FOLDER / "psnr_ssim_lpips_log.txt").read_text().splitlines()
    assert len(rows) == 1 and 3 < float(rows[0].split()[1]) < 60
    main("dat", True, **KW)
    assert (root / "results" / FOLDER / "best_psnr_ssim_lpips_model" / "setB" /
            "test_log.txt").exists()


def test_train_steps_yields_each_step_then_checkpoints(tmp_path, monkeypatch):
    """``Experiment.train_steps``: one yield a step, the epoch's checkpoint
    written after the last, and under a profiler ``sisr.loader.wait`` once a
    batch (and once more for the loader's end) and ``sisr.ckpt.save`` once."""
    from sisr_tpu_torch.__main__ import main

    root = _make_data(tmp_path, n_train=4)
    monkeypatch.chdir(root)
    exp = main("dat", False, run=False, **KW)
    ckpt = root / "weights" / FOLDER / "new_epoch_model.pth"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        steps = exp.train_steps()
        next(steps)
        assert not ckpt.exists() and exp.epoch_loss.count == 2      # one batch of 2
        assert sum(1 for _ in steps) == 1 and ckpt.exists()
    exp.close()
    counts = {e.key: e.count for e in prof.key_averages()
              if e.key in ("sisr.loader.wait", "sisr.ckpt.save")}
    assert counts == {"sisr.loader.wait": 3, "sisr.ckpt.save": 1}


def test_infer_arch_dat_through_tiled_sr(tmp_path, monkeypatch):
    """``python -m sisr_tpu_torch.infer --arch dat`` builds DAT, falls back
    to seeded weights without a checkpoint, and serves the image through
    ``TiledSR``; a checkpoint in DAT's ``params`` layout loads strictly and
    gives the same image."""
    from sisr_tpu_torch import infer

    monkeypatch.setattr(infer, "create_dat", lambda dtype, device: DAT(**TINY).eval())
    calls = []
    real = infer.upscale
    monkeypatch.setattr(infer, "upscale", lambda m, lr, tile: calls.append(
        (type(m).__name__, tuple(lr.shape), tile)) or real(m, lr, tile))
    src = tmp_path / "lr.png"
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (20, 26, 3),
                                                      dtype=np.uint8)).save(src)
    out = infer.main(str(src), str(tmp_path / "sr.png"), str(tmp_path / "none.pth"),
                     tile="32", device="cpu", arch="dat")
    first = np.asarray(Image.open(out))
    assert first.shape == (80, 104, 3) and calls == [("DAT", (20, 26, 3), "32")]
    model = DAT(**TINY)
    infer.load_model_weights(model, str(tmp_path / "none.pth"))
    torch.save({"params": model.state_dict()}, tmp_path / "dat.pth")
    out2 = infer.main(str(src), str(tmp_path / "sr2.png"), str(tmp_path / "dat.pth"),
                      tile="32", device="cpu", arch="dat")
    np.testing.assert_array_equal(np.asarray(Image.open(out2)), first)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_no_kernel_and_no_jax():
    """``dat_reference.py`` imports torch and the standard library alone:
    nothing of the port (its kernels above all) and nothing of JAX."""
    names = set(_imports(REPO / "sisr_tpu_torch" / "models" / "dat_reference.py"))
    assert names and {n.split(".")[0] for n in names} <= {"__future__", "math", "contextlib",
                                                          "typing", "torch"}
