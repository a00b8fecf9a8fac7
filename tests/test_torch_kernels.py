"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch (``tests/conftest.py`` imports JAX; leave it out):

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q

The plain versions are held equal to the JAX package in
``test_torch_ops.py``; ``chip_smoke.py`` repeats these checks at the
flagship's shapes.
"""

from contextlib import nullcontext

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(rng, *shape, scale=0.3):
    return rng.normal(size=shape).astype(np.float32) * scale


def _on(device, dtype, *arrays):
    return [None if a is None else torch.from_numpy(a).to(device, dtype)
            for a in arrays]


def _upcast(arg):
    """Every tensor in ``arg`` (nested in tuples and lists) as float32."""
    if isinstance(arg, torch.Tensor):
        return arg.float()
    if isinstance(arg, (tuple, list)):
        return type(arg)(_upcast(a) for a in arg)
    return arg


def _flat(out):
    return [out] if isinstance(out, torch.Tensor) else [t for o in out for t in _flat(o)]


def _check(fn, args, tol):
    """The kernel against the plain version on the same inputs.  float32:
    within ``tol``, absolute and relative.  bfloat16 rounds where the two
    versions round differently, so each output of the kernel must stay as
    close to the float32 plain version on the same (upcast) inputs as twice
    the plain bfloat16 version does, or within 4 bf16 ulps of its scale."""
    from sisr_tpu_torch.ops.kernels.autograd import plain_versions
    from sisr_tpu_torch.utils.precision import exact_mode

    with exact_mode():
        got = fn(*args)
        with plain_versions():
            ref, truth = fn(*args), fn(*_upcast(list(args)))
    for g, r, t in zip(_flat(got), _flat(ref), _flat(truth)):
        assert bool(torch.isfinite(g).all())
        if args[0].dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=tol * max(1.0, float(r.abs().max())), rtol=tol)
            continue
        e_kernel = float((g.float() - t).abs().max())
        e_plain = float((r.float() - t).abs().max())
        scale = max(1.0, float(t.abs().max()))
        assert e_kernel <= max(2.0 * e_plain, 4 * 2.0 ** -8 * scale), (e_kernel, e_plain)
    return got


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout,act,with_res", [
    (20, 12, "leaky", True), (180, 64, "leaky", False), (64, 3, "none", False),
    (6, 10, "leaky2", False)])
def test_conv3x3_kernel_matches_plain_on_card(cuda_device, dtype, cin, cout, act,
                                              with_res):
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3

    rng = np.random.default_rng(0)
    y, k, b, res = _on(cuda_device, dtype, _rand(rng, 1, 16, 24, cin, scale=1.0),
                       _rand(rng, 3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                       _rand(rng, cout), _rand(rng, 1, 16, 24, cout) if with_res else None)
    _check(conv3x3, (y, res, k, b, act), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bhw", [(2, 13, 17), (2, 64, 64)])
@pytest.mark.parametrize("cin,cout,act,with_res", [
    (180, 180, "none", True), (180, 180, "none", False), (180, 64, "leaky", False),
    (64, 256, "leaky2", False)])
def test_conv3x3_model_shapes_match_plain_on_card(cuda_device, dtype, bhw, cin, cout, act,
                                                  with_res):
    """The model's four convs (the bfloat16 wgmma path, n184, n64 and n256,
    and the float32 path's 96-, 64- and 128-wide N tiles), at a ragged map
    (partial row tiles, batch 2) and at a training step's 2x64x64."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3

    rng = np.random.default_rng(3)
    y, k, b, res = _on(cuda_device, dtype, _rand(rng, *bhw, cin, scale=1.0),
                       _rand(rng, 3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                       _rand(rng, cout), _rand(rng, *bhw, cout) if with_res else None)
    _check(conv3x3, (y, res, k, b, act), 1e-4)


def _tail_args(rng, h, w, c, ch, b=1, pad=(0, 0)):
    return (_rand(rng, b, h + pad[0], w + pad[1], c), _rand(rng, b, h, w, c),
            _rand(rng, c) + 1.0, _rand(rng, c), _rand(rng, c, ch), _rand(rng, ch),
            _rand(rng, 5, 5, ch), _rand(rng, ch), _rand(rng, ch, c), _rand(rng, c),
            _rand(rng, c) + 1.0, _rand(rng, c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,c,ch,pad", [(12, 20, 16, 40, (4, 4)), (9, 7, 24, 48, (0, 0)),
                                          (16, 8, 180, 360, (8, 0))])
def test_htb_tail_kernel_matches_plain_on_card(cuda_device, dtype, h, w, c, ch, pad):
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail, htb_tail_stats

    args = _on(cuda_device, dtype, *_tail_args(np.random.default_rng(1), h, w, c, ch,
                                               b=2, pad=pad))
    out, stats = _check(htb_tail_stats, args, 1e-4)
    # the variant without statistics stores the same out
    torch.testing.assert_close(htb_tail(*args), out, atol=0, rtol=0)
    # the statistics describe out as stored (and as the next block reads it)
    f32 = out.to(torch.float32)
    own = (f32.mean(-1), f32.amax(-1), f32.sum((1, 2)), f32.amax((1, 2)))
    for got, want in zip(stats, own):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,pad", [(13, 29, (3, 0)), (20, 37, (4, 11)), (8, 16, (0, 0)),
                                     (5, 3, (0, 0))])
def test_htb_tail_model_widths_match_plain_on_card(cuda_device, dtype, h, w, pad):
    """C = 180, Ch = 360 (the bfloat16 wgmma path's widths), batch 2, ragged
    maps that end inside an 8x16 output tile, and a window-padded attn:
    htb_tail_stats against its plain version; htb_tail stores the same out;
    the statistics describe out as stored."""
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail, htb_tail_stats

    args = _on(cuda_device, dtype, *_tail_args(np.random.default_rng(30 + h), h, w, 180, 360,
                                               b=2, pad=pad))
    out, stats = _check(htb_tail_stats, args, 1e-4)
    torch.testing.assert_close(htb_tail(*args), out, atol=0, rtol=0)
    f32 = out.to(torch.float32)
    own = (f32.mean(-1), f32.amax(-1), f32.sum((1, 2)), f32.amax((1, 2)))
    for got, want in zip(stats, own):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
def test_htb_tail_bands_match_one_band_on_card(cuda_device, monkeypatch):
    """The wgmma path in 8-row bands (h of a band capped low) stores the same
    out and statistics as in one band: fc1 recomputes the conv's 2-row halo
    of each band; the per-channel totals add up in another order."""
    from sisr_tpu_torch.ops.kernels import ffn

    args = _on(cuda_device, torch.bfloat16, *_tail_args(np.random.default_rng(40), 37, 29, 180,
                                                          360, b=2, pad=(3, 0)))
    whole, st_whole = ffn.htb_tail_stats(*args)
    monkeypatch.setattr(ffn, "_BAND_BYTES", 1)
    assert ffn.band_rows(2, 37, 29, 360) == 8
    banded, st_banded = ffn.htb_tail_stats(*args)
    torch.testing.assert_close(banded, whole, atol=0, rtol=0)
    for got, want in zip(st_banded, st_whole):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
def test_htb_tail_statistics_are_the_same_bits_back_to_back(cuda_device):
    """The wgmma path's per-channel sums add up in one order however its
    persistent blocks finish: calls queued back to back behind a long
    kernel (as a CUDA graph's replay runs them) store the bits of a call
    made on an idle card, at a 192² tile of the flagship's widths."""
    from sisr_tpu_torch.ops.kernels import ffn

    args = _on(cuda_device, torch.bfloat16,
               *_tail_args(np.random.default_rng(41), 192, 192, 180, 360, b=1))
    out, want = ffn.htb_tail_stats(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)        # ~0.1 s: the calls below queue behind it
    got = [ffn.htb_tail_stats(*args) for _ in range(20)]
    torch.cuda.synchronize()
    for o, st in got:
        assert torch.equal(o, out)
        assert all(torch.equal(a, b) for a, b in zip(st, want))


def _scc_args(rng, win, base, heads, c, nw, with_sca, device, dtype, b=1):
    from sisr_tpu_torch.ops.kernels.scc_attention import (blockdiag_kgen, head_mask,
                                                          pooling_matrix)

    d = c // (2 * heads)
    bh = min(win, base)
    rh = win // bh
    mk = lambda *s: torch.from_numpy(_rand(rng, *s))
    x = mk(b, nw * win, nw * win, c)
    sca = ((mk(9, c), mk(c), mk(9, c), mk(c), mk(b, 1, 1, c), mk(b, 1, 1, c))
           if with_sca else None)
    w1, w2, bb = blockdiag_kgen(mk(d, d), mk(d), mk(d, d), mk(d), heads)
    pmat, pb = pooling_matrix(mk(rh * rh, 1), mk(1), win, win, bh, bh, torch.float32)
    mask = head_mask(heads, bh * bh, c // 2, torch.float32)
    cast = lambda t: t.to(device, dtype)
    return (cast(x), None if sca is None else tuple(map(cast, sca)), cast(w1), cast(w2),
            cast(bb), cast(pmat), pb.to(device), cast(mask),
            cast(mk(win * win, heads * bh * bh)), cast(mk(c, c)), cast(mk(c)), heads,
            (win, win))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("win,heads,c,with_sca", [(4, 2, 24, True), (8, 2, 24, False),
                                                  (16, 2, 24, True), (8, 6, 180, True),
                                                  (32, 6, 180, False)])
def test_scc_block_kernel_matches_plain_on_card(cuda_device, dtype, win, heads, c,
                                                with_sca):
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    args = _scc_args(np.random.default_rng(2), win, 8, heads, c, 2 if win < 32 else 1,
                     with_sca, cuda_device, dtype)
    _check(scc_block, args, 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("win", [4, 8, 16, 32, 48, 64])
@pytest.mark.parametrize("sca", ["none", "sca", "threaded"])
def test_scc_block_model_shapes_match_plain_on_card(cuda_device, dtype, win, sca):
    """The model's block (C = 180, 6 heads, base window 8) at every window of
    its ladder, batch 2, without SCA, with it, and with the previous tail's
    channel maps: maps of 3x3 windows of 4 (18 windows, a partial last
    tile of the bfloat16 path's four-window tiles), 2x2 of 8 and 16, one
    window of 32, 48 (the 96x96 map a 64x64 training crop pads to) and
    64."""
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    nw = 3 if win == 4 else 2 if win <= 16 else 1
    args = list(_scc_args(np.random.default_rng(20 + win), win, 8, 6, 180, nw, sca != "none",
                          cuda_device, dtype, b=2))
    if sca == "threaded":
        x = args[0].float()
        args[1] = args[1] + (x.mean(-1) + 0.1, x.amax(-1) - 0.1)   # float32, as the tail emits
    _check(scc_block, args, 2e-3)


@pytest.mark.cuda
def test_scc_block_takes_threaded_channel_maps_on_card(cuda_device):
    """The SCA patches come from the previous tail's cmean/cmax when given."""
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    args = list(_scc_args(np.random.default_rng(3), 8, 8, 2, 24, 2, True, cuda_device,
                          torch.float32))
    x = args[0]
    args[1] = args[1] + (x.mean(-1) + 0.1, x.amax(-1) - 0.1)
    _check(scc_block, args, 2e-3)


@pytest.mark.cuda
def test_cuda_tensor_never_reaches_plain_code(cuda_device, monkeypatch):
    """A CUDA tensor runs the kernel (the launch counter moves) unless the
    caller asks for the plain version."""
    from sisr_tpu_torch.ops.kernels import build, conv3x3 as mod
    from sisr_tpu_torch.ops.kernels.autograd import plain_versions

    calls = []
    monkeypatch.setattr(mod, "conv3x3_reference",
                        lambda *a, **k: calls.append(1) or torch.zeros(1))
    y = torch.zeros(1, 4, 4, 4, device=cuda_device)
    k = torch.zeros(3, 3, 4, 4, device=cuda_device)
    b = torch.zeros(4, device=cuda_device)
    before = build.launches["conv3x3"]
    mod.conv3x3(y, None, k, b)
    assert build.launches["conv3x3"] == before + 1 and not calls
    with plain_versions():
        mod.conv3x3(y, None, k, b)
    assert build.launches["conv3x3"] == before + 1 and calls == [1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h2,w2,cin,cout,act", [(8, 12, 64, 256, "leaky2"), (6, 10, 8, 12, "none"),
                                                (5, 7, 6, 10, "leaky")])
def test_conv3x3_shuffled_kernel_matches_plain_on_card(cuda_device, dtype, h2, w2, cin, cout,
                                                       act):
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled

    rng = np.random.default_rng(4)
    yp, k, b = _on(cuda_device, dtype, _rand(rng, 2, h2, w2, 4 * cin, scale=1.0),
                   _rand(rng, 3, 3, cin, cout, scale=(9 * cin) ** -0.5), _rand(rng, cout))
    out = _check(conv3x3_shuffled, (yp, k, b, act), 1e-4)
    assert tuple(out.shape) == (2, 2 * h2, 2 * w2, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h2,w2,cin,c1,cout", [(12, 20, 64, 64, 3), (8, 9, 8, 12, 5),
                                               (7, 15, 6, 10, 3)])
def test_conv3x3_shuffled_tail_kernel_matches_plain_on_card(cuda_device, dtype, h2, w2, cin, c1,
                                                            cout):
    """Output tiles cut by the image border on both sides, conv_hr widths
    below the kernel's 64, and (6, 10) off the tensor-core path."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled_tail

    rng = np.random.default_rng(5)
    yp, k1, b1, k2, b2 = _on(cuda_device, dtype, _rand(rng, 2, h2, w2, 4 * cin, scale=1.0),
                             _rand(rng, 3, 3, cin, c1, scale=(9 * cin) ** -0.5),
                             _rand(rng, c1), _rand(rng, 3, 3, c1, cout, scale=(9 * c1) ** -0.5),
                             _rand(rng, cout))
    fn = lambda yp, k1, b1, k2, b2: conv3x3_shuffled_tail(yp, k1, b1, "leaky2", k2, b2)
    out = _check(fn, (yp, k1, b1, k2, b2), 1e-4)
    assert tuple(out.shape) == (2, 2 * h2, 2 * w2, cout)


# the x4 head's shapes: a 192x192 tile, a head band of the 1080p frame, a
# training step (batch 2), and an odd map that leaves partial blocks
HEAD_SHAPES = [(1, 192, 192), (1, 140, 1920), (2, 64, 64), (2, 13, 23)]


def _head_args(rng, device, dtype, b, h2, w2, cin=64, c1=64, cout=3):
    return _on(device, dtype, _rand(rng, b, h2, w2, 4 * cin, scale=1.0),
               _rand(rng, 3, 3, cin, c1, scale=(9 * cin) ** -0.5), _rand(rng, c1),
               _rand(rng, 3, 3, c1, cout, scale=(9 * c1) ** -0.5), _rand(rng, cout))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bhw", HEAD_SHAPES)
def test_conv3x3_shuffled_model_shapes_match_plain_on_card(cuda_device, dtype, bhw):
    """conv_up2 (64 -> 256, leaky 0.2) at the head's shapes: the bfloat16
    wgmma kernel (n256, 16-byte shuffled gather) and the float32 8x8
    register tiles (two N tiles of 128)."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled

    rng = np.random.default_rng(14)
    yp, k, b = _on(cuda_device, dtype, _rand(rng, *bhw, 256, scale=1.0),
                   _rand(rng, 3, 3, 64, 256, scale=(9 * 64) ** -0.5), _rand(rng, 256))
    out = _check(conv3x3_shuffled, (yp, k, b, "leaky2"), 1e-4)
    assert tuple(out.shape) == (bhw[0], 2 * bhw[1], 2 * bhw[2], 256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bhw", HEAD_SHAPES)
def test_conv3x3_shuffled_tail_model_shapes_match_plain_on_card(cuda_device, dtype, bhw):
    """conv_hr + conv_last (64 -> 64 -> 3) at the head's shapes on the
    region kernels (16 x 32 hr regions: bfloat16 on wgmma and mma.sync,
    float32 on 8x8 register tiles), partial tiles included (2W = 46 and 2H
    = 26 are no multiples of 30 and 14)."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled_tail

    args = _head_args(np.random.default_rng(17), cuda_device, dtype, *bhw)
    fn = lambda yp, k1, b1, k2, b2: conv3x3_shuffled_tail(yp, k1, b1, "leaky2", k2, b2)
    out = _check(fn, tuple(args), 1e-4)
    assert tuple(out.shape) == (bhw[0], 2 * bhw[1], 2 * bhw[2], 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,c1,cout", [(12, 16, 3), (64, 64, 9), (6, 10, 3), (8, 10, 3)])
def test_conv3x3_shuffled_tail_outside_the_rule_matches_plain_on_card(cuda_device, dtype, cin,
                                                                      c1, cout):
    """Shapes the region kernels' rule leaves to the earlier kernel in
    bfloat16 (Cin != 64, Cout > 8) or in both types (Cin % 4 != 0, or in
    float32 C1 % 4 != 0: f32k copies w1's rows 4 floats at a time)."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled_tail, tail_wgmma

    assert not tail_wgmma(cin, c1, cout)
    args = _head_args(np.random.default_rng(18), cuda_device, dtype, 2, 9, 17, cin, c1, cout)
    fn = lambda yp, k1, b1, k2, b2: conv3x3_shuffled_tail(yp, k1, b1, "leaky2", k2, b2)
    _check(fn, tuple(args), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_shuffled_conv_outside_the_rule_matches_plain_on_card(cuda_device, dtype):
    """Cin 12 (Cin % 4 == 0, Cin % 8 != 0): the plain conv would take wgmma,
    the shuffled conv keeps the earlier loop in bfloat16."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled, wgmma_width

    assert wgmma_width(12, 16, shuffled=True) is None and wgmma_width(12, 16) == 64
    rng = np.random.default_rng(19)
    yp, k, b = _on(cuda_device, dtype, _rand(rng, 2, 6, 10, 48, scale=1.0),
                   _rand(rng, 3, 3, 12, 16, scale=(9 * 12) ** -0.5), _rand(rng, 16))
    _check(conv3x3_shuffled, (yp, k, b, "none"), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_and_unpacked_tails_are_the_same_bytes_on_card(cuda_device, dtype):
    """At the model's widths the packed tail's output is the unpacked one's
    bytes: one kernel writes both."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_shuffled_tail,
                                                    conv3x3_shuffled_tail_packed)

    yp, k1, b1, k2, b2 = _head_args(np.random.default_rng(20), cuda_device, dtype, 1, 24, 64)
    flat = conv3x3_shuffled_tail(yp, k1, b1, "leaky2", k2, b2)
    packed = conv3x3_shuffled_tail_packed(yp, k1, b1, "leaky2", k2, b2)
    assert tuple(packed.shape) == (1, 48, 8, 48)
    assert torch.equal(packed.reshape(flat.shape).view(torch.int16 if dtype == torch.bfloat16
                                                       else torch.int32),
                       flat.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.cuda
def test_head_weight_packs_are_kept_while_unchanged_on_card(cuda_device):
    """conv_up2's and conv_hr's wgmma packs (bfloat16) are made once per
    weight tensor, as the model's cached weights serve them, and anew after
    a write to the weights (a training step's new weights)."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled, conv3x3_shuffled_tail

    yp, k1, b1, k2, b2 = _head_args(np.random.default_rng(23), cuda_device, torch.bfloat16,
                                    1, 8, 16)
    k, b = _on(cuda_device, torch.bfloat16, _rand(np.random.default_rng(24), 3, 3, 64, 256),
               np.zeros(256, np.float32))
    def packs():
        conv3x3_shuffled(yp, k, b, "leaky2")
        conv3x3_shuffled_tail(yp, k1, b1, "leaky2", k2, b2)
        return k._wgmma_pack[1], k1._wgmma_pack[1]

    first = packs()
    assert tuple(first[0].shape) == (256, 576) and tuple(first[1].shape) == (64, 576)
    again = packs()
    assert again[0] is first[0] and again[1] is first[1]
    k.mul_(0.5)
    k1.mul_(0.5)
    after = packs()
    assert after[0] is not first[0] and after[1] is not first[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,conv_kernel,tail_kernel", [
    (torch.bfloat16, "shuffled_conv_wgmma_kernel", "tail_wgmma_kernel"),
    (torch.float32, "shuffled_conv_f32_kernel", "tail_f32_kernel")])
def test_head_model_shapes_take_the_redesigned_kernels_on_card(cuda_device, dtype, conv_kernel,
                                                               tail_kernel):
    """At the model's widths conv_up2 and the tail launch the redesigned
    kernels and no other: every kernel under the profile prefixes
    chip_smoke.py reads (shuffled_conv_, tail_) is one of them, over three
    calls of each (the launch counters hold one launch a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled, conv3x3_shuffled_tail

    yp, k1, b1, k2, b2 = _head_args(np.random.default_rng(21), cuda_device, dtype, 1, 24, 64)
    k, b = _on(cuda_device, dtype, _rand(np.random.default_rng(22), 3, 3, 64, 256),
               np.zeros(256, np.float32))
    calls = lambda: (conv3x3_shuffled(yp, k, b, "leaky2"),
                     conv3x3_shuffled_tail(yp, k1, b1, "leaky2", k2, b2))
    calls()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            calls()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.count]
    head = [n for n in names if "::shuffled_conv_" in n or "::tail_" in n]
    assert any(conv_kernel in n for n in head) and any(tail_kernel in n for n in head), names
    assert all(conv_kernel in n or tail_kernel in n for n in head), head


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 12, 20), (1, 9, 70, 180), (1, 5, 3, 300),
                                   (1, 9, 1920, 180), (1, 37, 200, 180), (1, 16, 5, 7),
                                   (2, 64, 64, 64), (1, 96, 120, 64), (1, 192, 192, 64)])
def test_fusion_pools_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    from sisr_tpu_torch.ops.kernels.autograd import plain_versions
    from sisr_tpu_torch.ops.kernels.fusion_ops import fusion_pools

    rng = np.random.default_rng(6)
    a, b = _on(cuda_device, dtype, _rand(rng, *shape, scale=1.0), _rand(rng, *shape, scale=1.0))
    cp3, hp3, wp3 = _check(fusion_pools, (a, b), 1e-5)
    assert cp3.dtype == wp3.dtype == dtype and hp3.dtype == torch.float32
    # the max slots hold stored values: exact
    with plain_versions():
        ref = fusion_pools(a, b)
    for got, want in zip((cp3, hp3, wp3), ref):
        torch.testing.assert_close(got[:, 1::2], want[:, 1::2], atol=0, rtol=0)


def _ua_raws(rng, c, device):
    mk = lambda *s, scale=0.3: torch.from_numpy(_rand(rng, *s, scale=scale)).to(device)
    return tuple(((mk(3, 3, 2, 1), mk(1)), (mk(3, 3, 2, 1), mk(1)), (mk(3, 3, 2, 1), mk(1)),
                  (mk(3, 3, c, c, scale=(9 * c) ** -0.5), mk(c))) for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 8, 12), (1, 16, 48, 12), (1, 24, 20, 180),
                                   (1, 1, 5, 8), (1, 9, 1920, 180), (1, 37, 200, 180),
                                   (1, 16, 5, 7), (1, 192, 192, 180), (1, 300, 400, 180),
                                   (2, 64, 64, 64), (1, 96, 120, 64), (1, 192, 192, 64)])
def test_fused_fusion_kernels_match_plain_on_card(cuda_device, dtype, shape):
    """Pools, maps and gate against the Fusion module's math, including a
    one-row image (both row corrections on one row), and DenseSR's width
    (C = 64: its training step's batch, an eval image, a 192x192 tile)."""
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.ops.kernels.fusion_ops import fused_fusion, pack_params

    rng = np.random.default_rng(7)
    a, b = _on(cuda_device, dtype, _rand(rng, *shape, scale=1.0), _rand(rng, *shape, scale=1.0))
    raws = _ua_raws(rng, shape[-1], cuda_device)
    packed = pack_params(raws, shape[-1], dtype)
    before = dict(build.launches)
    _check(lambda a, b: fused_fusion(a, b, raws, packed), (a, b), 1e-4)
    assert build.launches["fused_fusion"] == before["fused_fusion"] + 1
    assert build.launches["fusion_pools"] == before["fusion_pools"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (1, 24, 20, 180)])
def test_fused_fusion_backward_through_kernel_function_on_card(cuda_device, dtype, shape):
    """The gate's gradients through ``KernelFunction`` (the kernels forward,
    the plain version's vjp backward) against the plain path's, at DenseSR's
    training step (2, 64, 64, 64) and a flagship-width map: a, b and every
    raw parameter, each within 1e-6 relative norm error.  The backward
    recomputes the same plain forward from the same saved inputs, so with
    TF32 off and cuDNN's deterministic algorithms (its default weight
    gradients sum in no fixed order: the small convs' kernels moved by
    1.6e-5 relative at (1, 24, 20, 180), NVIDIA H100 80GB HBM3, 700.00 W)
    the two agree to rounding."""
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.ops.kernels.autograd import plain_versions
    from sisr_tpu_torch.ops.kernels.fusion_ops import fused_fusion, pack_params
    from sisr_tpu_torch.utils.precision import exact_mode

    rng = np.random.default_rng(9)
    a, b, dy = _on(cuda_device, dtype, _rand(rng, *shape, scale=1.0),
                   _rand(rng, *shape, scale=1.0), _rand(rng, *shape, scale=1.0))
    raws = _ua_raws(rng, shape[-1], cuda_device)
    leaves = [a, b] + [t for ua in raws for kb in ua for t in kb]
    for t in leaves:
        t.requires_grad_(True)
    packed = pack_params(tuple(tuple((k.detach(), bb.detach()) for k, bb in ua)
                               for ua in raws), shape[-1], dtype)
    grads = []
    with exact_mode(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                  deterministic=True, allow_tf32=False):
        for plain in (False, True):
            before = dict(build.launches)
            with plain_versions() if plain else nullcontext():
                out = fused_fusion(a, b, raws, packed)
            grads.append(torch.autograd.grad(out, leaves, dy))
            assert build.launches["fused_fusion"] == before["fused_fusion"] + (not plain)
    for got, want in zip(*grads):
        assert bool(torch.isfinite(got).all())
        err = float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))
        assert err <= 1e-6, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 9, 1920, 180), (2, 37, 70, 180), (1, 192, 192, 180),
                                   (1, 300, 400, 180)])
def test_fusion_kernels_store_the_same_bits_twice(cuda_device, dtype, shape):
    """No float atomics and no block writing another's pixels: every sum is
    taken in a fixed order, so two calls of each kernel on the same inputs
    store the same bits (a 192x192 tile and a 300x400 map have interior
    gate blocks, 8 and 16 rows high)."""
    from sisr_tpu_torch.ops.kernels.fusion_ops import fused_fusion, fusion_pools, pack_params

    rng = np.random.default_rng(8)
    a, b = _on(cuda_device, dtype, _rand(rng, *shape, scale=1.0), _rand(rng, *shape, scale=1.0))
    raws = _ua_raws(rng, shape[-1], cuda_device)
    packed = pack_params(raws, shape[-1], dtype)
    for first, second in zip(fusion_pools(a, b), fusion_pools(a, b)):
        assert torch.equal(first, second)
    assert torch.equal(fused_fusion(a, b, raws, packed), fused_fusion(a, b, raws, packed))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h2,w2,cin,c1,cout", [(12, 24, 64, 64, 3), (7, 8, 8, 12, 5)])
def test_conv3x3_shuffled_tail_packed_kernel_matches_plain_on_card(cuda_device, dtype, h2, w2,
                                                                   cin, c1, cout):
    """The packed output holds the unpacked kernel's bytes, and the shapes
    whose output width is not a multiple of 16 are refused."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_shuffled_tail,
                                                    conv3x3_shuffled_tail_packed)

    rng = np.random.default_rng(8)
    yp, k1, b1, k2, b2 = _on(cuda_device, dtype, _rand(rng, 2, h2, w2, 4 * cin, scale=1.0),
                             _rand(rng, 3, 3, cin, c1, scale=(9 * cin) ** -0.5),
                             _rand(rng, c1), _rand(rng, 3, 3, c1, cout, scale=(9 * c1) ** -0.5),
                             _rand(rng, cout))
    fn = lambda yp, k1, b1, k2, b2: conv3x3_shuffled_tail_packed(yp, k1, b1, "leaky2", k2,
                                                                 b2)
    out = _check(fn, (yp, k1, b1, k2, b2), 1e-4)
    assert tuple(out.shape) == (2, 2 * h2, 2 * w2 // 16, 16 * cout)
    flat = conv3x3_shuffled_tail(yp, k1, b1, "leaky2", k2, b2)
    torch.testing.assert_close(out.reshape(flat.shape), flat, atol=0, rtol=0)
    with pytest.raises(ValueError):
        conv3x3_shuffled_tail_packed(yp[:, :, :w2 - 2], k1, b1, "leaky2", k2, b2)


def _fused_args(rng, win, heads, c, ch, nh, nw, with_sca, device, dtype, b=1):
    scc = _scc_args(rng, win, win, heads, c, 1, with_sca, device, dtype, b=b)
    x = torch.from_numpy(_rand(rng, b, nh * win, nw * win, c)).to(device, dtype)
    tail = _on(device, dtype, *_tail_args(rng, 1, 1, c, ch)[2:])
    return (x,) + scc[1:] + tuple(tail)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("win,heads,c,ch,nh,nw,with_sca", [
    (4, 2, 20, 40, 4, 3, True), (4, 2, 48, 96, 3, 5, True), (8, 2, 20, 40, 2, 3, True),
    (4, 2, 20, 40, 3, 3, False), (8, 6, 180, 360, 3, 4, True)])
def test_htb_fused_kernel_matches_plain_on_card(cuda_device, dtype, stats, win, heads, c, ch,
                                                nh, nw, with_sca):
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused

    args = _fused_args(np.random.default_rng(9), win, heads, c, ch, nh, nw, with_sca,
                       cuda_device, dtype, b=2)
    before = build.launches["htb_fused"]
    fn = lambda *a: htb_fused(*a, emit_stats=stats)
    got = _check(fn, args, 2e-3)
    assert build.launches["htb_fused"] == before + 1
    if stats:
        out, st = got
        f32 = out.to(torch.float32)
        own = (f32.mean(-1), f32.amax(-1), f32.sum((1, 2)), f32.amax((1, 2)))
        for g, want in zip(st, own):
            torch.testing.assert_close(g, want, rtol=1e-5,
                                       atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
def test_htb_fused_takes_threaded_channel_maps_on_card(cuda_device):
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused

    args = list(_fused_args(np.random.default_rng(10), 4, 2, 24, 48, 3, 4, True, cuda_device,
                            torch.float32))
    x = args[0]
    args[1] = args[1] + (x.mean(-1) + 0.1, x.amax(-1) - 0.1)
    _check(htb_fused, args, 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("win,nh,nw,sca", [(4, 3, 5, "sca"), (4, 2, 3, "threaded"),
                                           (8, 2, 3, "threaded"), (8, 3, 1, "none")])
def test_htb_fused_wgmma_shapes_match_plain_and_the_chain_on_card(cuda_device, stats, win, nh,
                                                                  nw, sca):
    """bfloat16 at the flagship's fused blocks (C = 180 in 6 heads, Ch =
    360, windows 4 and 8), batch 2, without SCA, with it and with the
    previous tail's channel maps: htb_fused, one launch counted per call,
    within the plain version's bar (``_check``); and it stores the bits of
    the unfused kernel chain (scc_block, then htb_tail or htb_tail_stats)
    on the same inputs, out and the channel maps exactly (its wgmma
    launches round where the chain rounds and sum in its order; the earlier
    launches, with their float32 spatial branch, cannot), the per-channel
    sums within 1e-5 relative (atomics in another order)."""
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail, htb_tail_stats
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    args = list(_fused_args(np.random.default_rng(50 + win), win, 6, 180, 360, nh, nw,
                            sca != "none", cuda_device, torch.bfloat16, b=2))
    if sca == "threaded":
        x = args[0].float()
        args[1] = args[1] + (x.mean(-1) + 0.1, x.amax(-1) - 0.1)   # float32, as the tail emits
    fn = lambda *a: htb_fused(*a, emit_stats=stats)
    before = dict(build.launches)
    got = _check(fn, args, 2e-3)
    assert build.launches["htb_fused"] == before["htb_fused"] + 1
    assert all(build.launches[k] == before[k] for k in build.launches if k != "htb_fused")
    attn = scc_block(*args[:13])
    chain = (htb_tail_stats if stats else htb_tail)(attn, args[0], *args[13:])
    if not stats:
        torch.testing.assert_close(got, chain, atol=0, rtol=0)
        return
    (out, st), (want, want_st) = got, chain
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    for i, (g, w) in enumerate(zip(st, want_st)):
        if i == 2:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * max(1.0, float(w.abs().max())))
        else:
            torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.cuda
def test_scc_block_kernel_over_65535_windows_on_card(cuda_device):
    """1032 x 1040 at window 4 is 67,080 windows, past gridDim.y's 65,535."""
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    args = list(_scc_args(np.random.default_rng(11), 4, 8, 2, 24, 1, True, cuda_device,
                          torch.float32))
    args[0] = torch.from_numpy(_rand(np.random.default_rng(12), 1, 1032, 1040, 24)).to(
        cuda_device)
    _check(scc_block, args, 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,band,fused", [((40, 32), 16, False), ((50, 22), 16, False),
                                           ((48, 24), 16, True)])
def test_banded_head_matches_whole_forward_on_card(cuda_device, hw, band, fused):
    """BandedHeadSR (stacked and packed; canvas and unpacked) equals the
    whole forward on the kernels, and stays within the parity bar of the
    plain model."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR
    from sisr_tpu_torch.ops.kernels.autograd import plain_versions
    from sisr_tpu_torch.parallel.tiling import BandedHeadSR
    from sisr_tpu_torch.utils.param_synth import synth_state_dict
    from sisr_tpu_torch.utils.precision import exact_mode

    model = HiTSIR(embed_dim=24, depths=(4,), num_heads=(2,), base_win_size=(8, 8),
                   hier_win_ratios=(0.5, 1, 2, 4), fused_htb=fused).to(cuda_device).eval()
    manifest = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synth_state_dict(manifest, 1).items()})
    img = torch.from_numpy(np.random.default_rng(13).random((*hw, 3), dtype=np.float32)).to(
        cuda_device)
    with torch.inference_mode(), exact_mode():
        banded = BandedHeadSR(model, band_rows=band)(img)
        whole = model(img[None])[0]
        with plain_versions():
            plain = model(img[None])[0]
    assert banded.shape == whole.shape == (4 * hw[0], 4 * hw[1], 3)
    torch.testing.assert_close(banded, whole, atol=1e-5, rtol=0)
    assert float((banded - plain).abs().max()) < 1e-3


# --- training: dwconv5x5, the Functions' gradients, the grad guards -----------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 192, 192, 360), (2, 64, 64, 360), (1, 13, 17, 24)])
def test_dwconv5x5_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    """The forward kernel, and dx (the same kernel on dy, reading the
    filter flipped, no bias: one launch) against plain autograd's dx, at the
    model's two shapes and an odd one (partial tiles and channel slices)."""
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.ops.kernels.autograd import in_plain_versions
    from sisr_tpu_torch.ops.kernels.dwconv import _kernel, dwconv5x5, dwconv_vjp

    rng = np.random.default_rng(20)
    c = shape[-1]
    x, w, b, dy = _on(cuda_device, dtype, _rand(rng, *shape, scale=1.0),
                      _rand(rng, 5, 5, c, scale=0.2), _rand(rng, c), _rand(rng, *shape, scale=1.0))
    before = build.launches["dwconv5x5"]
    _check(dwconv5x5, (x, w, b), 1e-5)
    assert build.launches["dwconv5x5"] == before + 1

    def dx(dy, x, w, b):
        if in_plain_versions():
            xg = x.detach().requires_grad_()
            return torch.autograd.grad(dwconv5x5(xg, w, b), xg, dy)[0]
        return dwconv_vjp(_kernel, (x, w, b), (True, False, False), (dy,))[0]

    before = build.launches["dwconv5x5"]
    _check(dx, (dy, x, w, b), 1e-5)
    assert build.launches["dwconv5x5"] == before + 1


def _grad_cases(device):
    """name -> (public function, float32 CUDA arguments, the indices of the
    tensors to differentiate): every kernel Function at small shapes."""
    from sisr_tpu_torch.ops.kernels import conv3x3 as cv, dwconv, ffn, fusion_ops as fo
    from sisr_tpu_torch.ops.kernels import scc_block as sb

    rng = np.random.default_rng(21)
    mk = lambda *s, scale=0.3: torch.from_numpy(_rand(rng, *s, scale=scale)).to(device)
    f = 16
    conv = lambda *a: cv.conv3x3(*a, "leaky")
    tail = lambda *a: cv.conv3x3_shuffled_tail(a[0], a[1], a[2], "leaky2", a[3], a[4])
    packed = lambda *a: cv.conv3x3_shuffled_tail_packed(a[0], a[1], a[2], "leaky2", a[3], a[4])
    shuffled = lambda *a: cv.conv3x3_shuffled(*a, "leaky2")
    head = (mk(2, 6, 8, 4 * f, scale=1.0), mk(3, 3, f, f, scale=f ** -1), mk(f),
            mk(3, 3, f, 3, scale=f ** -1), mk(3))
    cases = {
        "conv3x3": (conv, (mk(2, 12, 10, 20, scale=1.0), None, mk(3, 3, 20, 24, scale=0.07),
                           mk(24))),
        "conv3x3 +res": (conv, (mk(2, 12, 10, 20, scale=1.0), mk(2, 12, 10, 24),
                                mk(3, 3, 20, 24, scale=0.07), mk(24))),
        "conv3x3_shuffled": (shuffled, (mk(2, 6, 8, 4 * f, scale=1.0),
                                        mk(3, 3, f, 24, scale=f ** -1), mk(24))),
        "conv3x3_shuffled_tail": (tail, head),
        "conv3x3_shuffled_tail_packed": (packed, head),
        "htb_tail": (ffn.htb_tail, tuple(_on(device, torch.float32, *_tail_args(
            rng, 12, 10, 24, 48, b=2, pad=(4, 6))))),
        "dwconv5x5": (dwconv.dwconv5x5, (mk(2, 9, 11, 40, scale=1.0), mk(5, 5, 40), mk(40))),
        "fusion_pools": (fo.fusion_pools, (mk(2, 8, 6, 20, scale=1.0), mk(2, 8, 6, 20, scale=1.0))),
    }
    for with_sca in (True, False):
        args = _scc_args(rng, 8, 8, 2, 24, 2, with_sca, device, torch.float32, b=2)
        cases[f"scc_block {'+' if with_sca else '-'}sca"] = (sb.scc_block, args)
    raws = _ua_raws(rng, 20, device)
    cases["fused_fusion"] = (
        lambda a, b, raws: fo.fused_fusion(a, b, raws, fo.pack_params(raws, 20, torch.float32)),
        (mk(2, 8, 6, 20, scale=1.0), mk(2, 8, 6, 20, scale=1.0), raws))
    return cases


def _with_grad(args):
    """Fresh float32 copies of the tensors in args (nested in tuples) that
    require grad, and the flat list of them."""
    leaves = []

    def conv(a):
        if isinstance(a, torch.Tensor):
            t = a.detach().clone().requires_grad_(a.is_floating_point())
            if t.requires_grad:
                leaves.append(t)
            return t
        if isinstance(a, tuple):
            return tuple(conv(v) for v in a)
        return a

    return [conv(a) for a in args], leaves


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv3x3", "conv3x3 +res", "conv3x3_shuffled",
                                  "conv3x3_shuffled_tail", "conv3x3_shuffled_tail_packed",
                                  "htb_tail", "scc_block +sca", "scc_block -sca",
                                  "fusion_pools", "fused_fusion", "dwconv5x5"])
def test_kernel_function_gradients_match_plain_on_card(cuda_device, name):
    """Forward on the kernel, backward through its Function, against plain
    autograd of the plain path, float32 with TF32 off: outputs within 1e-4
    and every input gradient within a relative norm error of 1e-4."""
    from sisr_tpu_torch.ops.kernels.autograd import plain_versions
    from sisr_tpu_torch.utils.precision import exact_mode

    fn, args = _grad_cases(cuda_device)[name]
    with exact_mode():
        k_args, k_leaves = _with_grad(args)
        p_args, p_leaves = _with_grad(args)
        got = _flat(fn(*k_args))
        with plain_versions():
            ref = _flat(fn(*p_args))
        seeds = [torch.randn(r.shape, generator=torch.Generator(cuda_device).manual_seed(i),
                             device=cuda_device) for i, r in enumerate(ref)]
        g_k = torch.autograd.grad(got, k_leaves, seeds, allow_unused=True)
        g_p = torch.autograd.grad(ref, p_leaves, seeds, allow_unused=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4 * max(1.0, float(r.abs().max())), rtol=1e-4)
    for a, b in zip(g_k, g_p):
        assert (a is None) == (b is None)
        if a is not None:
            assert bool(torch.isfinite(a).all())
            err = float((a - b).norm() / b.norm().clamp_min(1e-30))
            assert err < 1e-4, err


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_grad(cuda_device):
    """htb_tail_stats and htb_fused have no backward: inputs that need a
    gradient raise instead of handing back an output with none; without
    grad they run."""
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail_stats
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused

    rng = np.random.default_rng(22)
    tail = _on(cuda_device, torch.float32, *_tail_args(rng, 8, 8, 24, 48))
    fused = _fused_args(rng, 4, 2, 20, 40, 2, 2, True, cuda_device, torch.float32)
    for fn, args in ((htb_tail_stats, tail), (htb_fused, fused)):
        args = list(args)
        with torch.no_grad():
            fn(*args)
        args[0] = args[0].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)


@pytest.mark.cuda
def test_derived_weights_cache_only_without_grad_on_card(cuda_device):
    """Under inference_mode the derived weights are cached and a forward
    launches exactly the serving counts; a forward that records gradients
    makes them anew, keeps nothing, launches no stats tail, and its
    backward runs dwconv5x5 twice per block (the recomputed forward and
    dx); the kernel path's gradients match the plain path's."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.ops.kernels.autograd import plain_versions
    from sisr_tpu_torch.utils.param_synth import synth_state_dict
    from sisr_tpu_torch.utils.precision import exact_mode

    model = HiTSIR(embed_dim=24, depths=(3, 3), num_heads=(2, 2), base_win_size=(8, 8),
                   hier_win_ratios=(0.5, 1, 2)).to(cuda_device)
    manifest = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synth_state_dict(manifest, 3).items()})
    x = torch.from_numpy(np.random.default_rng(23).random((2, 24, 20, 3),
                                                          dtype=np.float32)).to(cuda_device)
    serve = dict(conv3x3=5, conv3x3_shuffled=1, conv3x3_shuffled_tail=1, fusion_pools=1,
                 fused_fusion=1, scc_block=6, htb_tail=6, htb_tail_stats=4)
    conv = model.conv_after_body
    with torch.inference_mode():
        model(x)
        cached = conv.__dict__["_derived"][("conv", torch.float32, x.device)][1]
        build.reset_launches()
        model(x)
    assert {k: v for k, v in build.launches.items() if v} == serve
    assert conv.__dict__["_derived"][("conv", torch.float32, x.device)][1] is cached

    conv.__dict__["_derived"].clear()
    grads = {}
    with exact_mode():
        for plain in (False, True):
            model.zero_grad(set_to_none=True)
            build.reset_launches()
            with plain_versions() if plain else nullcontext():
                (model(x, deterministic=False) ** 2).mean().backward()
            counts = {k: v for k, v in build.launches.items() if v}
            grads[plain] = {k: p.grad.clone() for k, p in model.named_parameters()
                            if p.grad is not None}
            if not plain:
                want = dict(serve, htb_tail_stats=0, dwconv5x5=12)
                assert counts == {k: v for k, v in want.items() if v}, counts
    assert not conv.__dict__["_derived"]
    assert grads[False].keys() == grads[True].keys()
    assert len(grads[False]) == sum(1 for _ in model.parameters()) - 2   # conv_first.norm
    for k, g in grads[False].items():
        err = float((g - grads[True][k]).norm() / grads[True][k].norm().clamp_min(1e-30))
        assert err < 1e-3, (k, err)
