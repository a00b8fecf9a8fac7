"""The layouts the redesigned kernels read, held against JAX on the CPU.

The bfloat16 conv3x3 kernel (``csrc/conv3x3.cu``, wgmma) reads its weights
packed by ``pack_weights`` and sums over a flat K in the order tap-major,
Cin inner, padded to its K step.  It runs only on a card, so here a plain
PyTorch emulation of that order over the packed weights stands in for it
and is held to ``conv3x3_reference`` and to JAX's Pallas kernel in
interpret mode.  The dwconv5x5 kernel computes dx in one launch by reading
the filter flipped (``flip=True``); its plain version takes the same flag
and is held to JAX's ``custom_vjp``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "sisr_tpu_torch" / "csrc"
# the model's conv3x3 calls (models/hit_sir_pro.py): RHTB residual convs,
# conv_after_body, conv_before_upsample, conv_up1 (phase-folded)
MODEL_CONVS = [(180, 180, "none", True), (180, 180, "none", False),
               (180, 64, "leaky", False), (64, 256, "leaky2", False)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(ref, dtype=np.float32), atol=atol, rtol=rtol)


def _conv_inputs(rng, b, h, w, cin, cout, with_res):
    y = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    res = rng.normal(size=(b, h, w, cout)).astype(np.float32) if with_res else None
    return y, res, k, bias


def flat_k_emulation(y, res, packed, bias, act, cout):
    """What the wgmma kernel computes, in its order: the im2col rows of y
    (zero 'same' padding) with K = 9*Cin in tap-major, Cin-inner order,
    zero-padded to the packed Kpad, times the packed (Npad, Kpad) weights;
    the first Cout columns, + bias, act, + res."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import _act

    b, h, w, cin = y.shape
    yp = F.pad(y, (0, 0, 1, 1, 1, 1))
    cols = [yp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    a = torch.cat(cols, dim=-1).reshape(b * h * w, 9 * cin)
    a = F.pad(a, (0, packed.shape[1] - 9 * cin))
    out = (a @ packed.t())[:, :cout].reshape(b, h, w, cout) + bias
    out = _act(out, act)
    return out if res is None else res + out


@pytest.mark.parametrize("cin,cout", [(180, 180), (180, 64), (64, 256), (20, 12), (8, 10),
                                      (4, 2)])
def test_pack_weights_round_trips_with_zero_padding(cin, cout):
    from sisr_tpu_torch.ops.kernels.conv3x3 import K_STEP, pack_weights, wgmma_width

    k = _t(np.random.default_rng(0).normal(size=(3, 3, cin, cout)))
    npad = wgmma_width(cin, cout)
    packed = pack_weights(k, npad)
    kk = 9 * cin
    assert packed.shape == (npad, -(-kk // K_STEP) * K_STEP)
    assert packed.shape[1] % K_STEP == 0 and npad % 8 == 0 and npad >= cout
    # row n, column (3*dy + dx)*Cin + ci holds k[dy, dx, ci, n]
    np.testing.assert_array_equal(packed[:cout, :kk].t().reshape(3, 3, cin, cout).numpy(),
                                  k.numpy())
    assert not packed[cout:].any() and not packed[:, kk:].any()


def test_wgmma_width_follows_the_shape_rule():
    """The model's widths, and the shapes the rule sends to the older
    kernels (Cin % 4, odd Cout, Cout > 256)."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import wgmma_width

    assert [wgmma_width(ci, co) for ci, co, _, _ in MODEL_CONVS] == [184, 184, 64, 256]
    assert wgmma_width(20, 12) == 64 and wgmma_width(64, 130) == 184
    assert wgmma_width(6, 10) is None          # Cin % 4 != 0
    assert wgmma_width(64, 3) is None          # odd Cout
    assert wgmma_width(64, 258) is None        # wider than one wgmma tile


@pytest.mark.parametrize("cin,cout,act,with_res", MODEL_CONVS)
def test_flat_k_order_over_packed_weights_matches_reference_and_pallas(cin, cout, act,
                                                                        with_res):
    """The kernel's flat-K order over the packed weights, at the model's
    four (Cin, Cout) pairs, against the plain version and JAX's
    ``_conv3x3_pallas`` in interpret mode, 1e-4."""
    from sisr_tpu.ops.pallas.conv3x3 import _conv3x3_pallas
    from sisr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_reference, pack_weights,
                                                    wgmma_width)

    y, res, k, bias = _conv_inputs(np.random.default_rng(1), 2, 8, 7, cin, cout, with_res)
    packed = pack_weights(_t(k), wgmma_width(cin, cout))
    got = flat_k_emulation(_t(y), None if res is None else _t(res), packed, _t(bias), act,
                           cout)
    ref = conv3x3_reference(_t(y), None if res is None else _t(res), _t(k), _t(bias), act)
    _close(got, ref, 1e-4, 1e-4)
    jargs = (jnp.asarray(y), None if res is None else jnp.asarray(res), jnp.asarray(k),
             jnp.asarray(bias), act)
    _close(got, _conv3x3_pallas(*jargs, interpret=True), 1e-4, 1e-4)


def test_pack_is_kept_on_the_kernel_while_it_is_unchanged():
    """Serving packs once (the same cached weights every call); a write to
    the weights, or other weights, packs anew; an inference tensor, which
    has no version counter, is packed every call."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import _packed, pack_weights

    k = _t(np.random.default_rng(2).normal(size=(3, 3, 8, 10)))
    first = _packed(k, 64)
    assert _packed(k, 64) is first
    torch.testing.assert_close(first, pack_weights(k, 64), rtol=0, atol=0)
    k.mul_(2.0)
    second = _packed(k, 64)
    assert second is not first
    torch.testing.assert_close(second, pack_weights(k, 64), rtol=0, atol=0)
    with torch.inference_mode():
        ki = k * 1.0
        assert _packed(ki, 64) is not _packed(ki, 64)


def test_wgmma_header_is_generated_from_its_script():
    """``wgmma.cuh`` is what ``gen_wgmma.py`` writes: one wrapper per width,
    among them every width of ``conv3x3.WGMMA_WIDTHS`` and those scc_block
    (16, 48, 96) and htb_tail (184) use."""
    import importlib.util

    from sisr_tpu_torch.ops.kernels.conv3x3 import WGMMA_WIDTHS

    spec = importlib.util.spec_from_file_location("gen_wgmma", CSRC / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert set(WGMMA_WIDTHS) | {16, 48, 96, 184} <= set(gen.WIDTHS)
    assert (CSRC / "wgmma.cuh").read_text() == gen.HEAD + "".join(gen.one(n)
                                                                  for n in gen.WIDTHS)


@pytest.mark.parametrize("shape", [(1, 8, 12, 16), (2, 16, 20, 24), (1, 7, 5, 6)])
def test_dwconv_flip_gives_jax_custom_vjp_dx(shape):
    """dx as the kernel now computes it, one call with the filter read
    flipped and no bias, through the plain version that takes the same
    flag, against JAX's ``dwconv5x5`` custom_vjp dx, 1e-5."""
    from sisr_tpu.ops.pallas.dwconv import dwconv5x5 as jx
    from sisr_tpu_torch.ops.kernels.dwconv import depthwise_conv_reference, dwconv_vjp

    rng = np.random.default_rng(6)
    x, w, b, dy = (rng.normal(size=s).astype(np.float32)
                   for s in (shape, (5, 5, shape[-1]), (shape[-1],), shape))
    _, vjp = jax.vjp(lambda *a: jx(*a, False), *map(jnp.asarray, (x, w, b)))
    ref_dx = vjp(jnp.asarray(dy))[0]
    _close(depthwise_conv_reference(_t(dy), _t(w), None, True), ref_dx, 1e-5, 1e-5)
    calls = []

    def counted(*args):
        calls.append(args[2:])
        return depthwise_conv_reference(*args)

    dx = dwconv_vjp(counted, (_t(x), _t(w), _t(b)), (True, False, False), (_t(dy),))[0]
    _close(dx, ref_dx, 1e-5, 1e-5)
    assert calls == [(None, True)]    # one call: no bias, the flip flag set


# --- scc_block's wgmma path -------------------------------------------------

def _rbf(t):
    """t rounded to bfloat16, kept in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def scc_wgmma_emulation(x, sca, w1, w2, bb, pmat, pb, bias, proj_k, proj_b, heads, window,
                        rnd=_rbf, split=True, part_rnd=None, spatial=False):
    """What ``csrc/scc_block.cu``'s wgmma path computes, over the packed
    operands and in its slot layout, in float32 with its rounding points
    (``rnd``: bfloat16, or the identity for float32): qkv rounded, k = qkv @
    pack_wkv^T + bb, the gram rounded then / L, KP and VP rounded then +
    pb, M and VP_big split into hi + lo parts (``split``; only hi when
    False), the spatial branch one 16-slot product a head, [out_s | out_c]
    rounded, the projection over pack_proj."""
    from sisr_tpu_torch.ops.kernels.scc_block import (SLOT_WIDTH, pack_proj, pack_wkv,
                                                      sca_reference, slots)

    f = lambda t: t.to(torch.float32)
    b, hp, wp, c = x.shape
    wh, ww = window
    big_l, lb, half, pw = wh * ww, pmat.shape[0], c // 2, SLOT_WIDTH
    qkv = rnd(sca_reference(f(x), *map(f, sca)) if sca is not None else f(x))
    xw = qkv.reshape(b, hp // wh, wh, wp // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    xw = xw.reshape(-1, big_l, c)
    s = slots(half, heads)
    xa = xw.new_zeros(xw.shape[0], big_l, 2 * pw)
    xa[..., s], xa[..., pw + s] = xw[..., :half], xw[..., half:]
    bbp = xa.new_zeros(pw)
    bbp[s] = f(bb).reshape(-1)
    k = rnd(xa @ rnd(pack_wkv(f(w1), f(w2), heads)).t() + bbp)
    q, v = xa[..., :pw], xa[..., pw:]
    gram = rnd(rnd(q.transpose(1, 2) @ k) / big_l)               # [c][d]
    part_rnd = rnd if part_rnd is None else part_rnd
    pm = f(pmat)
    kp = rnd(pm @ k) + f(pb).reshape(())
    vp = rnd(pm @ v) + f(pb).reshape(())
    out_c = rnd(v @ gram.transpose(1, 2))
    live = (torch.arange(pw) % 16) < 15
    same = (torch.arange(pw)[:, None] // 16 == torch.arange(pw)[None, :] // 16)
    m = (kp.transpose(1, 2) @ vp) / (half // heads) * (same & live[:, None] & live[None, :])
    vp = vp * live

    def parts(t):
        hi = part_rnd(t)
        return (hi, part_rnd(t - hi)) if split else (hi,)

    out_s = 0.0
    fb = f(bias)
    for h in range(heads):
        cols = slice(16 * h, 16 * h + 16)
        for mt, vt in zip(parts(m), parts(vp)):
            out_s = out_s + torch.nn.functional.pad(
                q[..., cols] @ mt[:, cols, cols] + fb[:, h * lb:(h + 1) * lb] @ vt[:, :, cols],
                (16 * h, pw - 16 * h - 16))
    if spatial:
        return out_s
    ot = torch.cat([rnd(out_s), out_c], dim=-1)
    out = rnd(ot @ rnd(pack_proj(f(proj_k), heads)).t()[:, :c] + f(proj_b))
    out = out.reshape(b, hp // wh, wp // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, hp, wp, c)


def _scc_model_args(win, nh, nw, with_sca, b=2, seed=0):
    """numpy inputs of one model block: C = 180, 6 heads, base window 8."""
    from sisr_tpu.ops.pallas.scc_attention import (blockdiag_kgen, head_mask,
                                                   pooling_matrix)

    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32) * 0.3
    c, heads = 180, 6
    d, bh = c // (2 * heads), min(win, 8)
    rh = win // bh
    x = mk(b, nh * win, nw * win, c)
    sca = ((mk(9, c), mk(c), mk(9, c), mk(c), mk(b, 1, 1, c), mk(b, 1, 1, c))
           if with_sca else None)
    w1, w2, bb = blockdiag_kgen(*map(jnp.asarray, (mk(d, d), mk(d), mk(d, d), mk(d))), heads)
    pmat, pb = pooling_matrix(jnp.asarray(mk(rh * rh, 1)), jnp.asarray(mk(1)), win, win, bh,
                              bh, jnp.float32)
    mask = head_mask(heads, bh * bh, c // 2, jnp.float32)
    rest = [np.asarray(a) for a in (w1, w2, bb, pmat, pb, mask)]
    return (x, sca, *rest, mk(win * win, heads * bh * bh), mk(c, c) / 4, mk(c), heads,
            (win, win))


def _torch_args(args, dtype=torch.float32):
    out = [_t(a).to(dtype) if isinstance(a, np.ndarray) else a for a in args]
    if args[1] is not None:
        out[1] = tuple(_t(a).to(dtype) for a in args[1])
    out[6] = _t(args[6])               # pb stays float32
    return out


def _emulate(pt, **kw):
    """The emulation on plain-version arguments (the kernel derives the head
    mask from ``heads``: no mask argument)."""
    return scc_wgmma_emulation(*pt[:7], *pt[8:], **kw)


@pytest.mark.parametrize("win,nh,nw,with_sca", [(4, 2, 3, True), (8, 1, 2, False),
                                                (16, 1, 1, True)])
def test_scc_wgmma_layout_matches_reference_and_pallas(win, nh, nw, with_sca):
    """The wgmma path's slot layout and packed operands, emulated in float32
    (no rounding), against the plain version and JAX's ``_scc_block_pallas``
    in interpret mode at C = 180, 6 heads, windows 4, 8 and 16: 2e-4 against
    the plain version (the same float32 products, summed in another
    order), 2e-3 against JAX as ``test_torch_ops.py`` holds the plain
    version to it."""
    from sisr_tpu.ops.pallas.scc_block import _scc_block_pallas
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block_reference, wgmma_path

    args = _scc_model_args(win, nh, nw, with_sca)
    assert wgmma_path(torch.bfloat16, 180, 6, win * win, min(win, 8) ** 2)
    pt = _torch_args(args)
    got = _emulate(pt, rnd=lambda t: t)
    _close(got, scc_block_reference(*pt), 2e-4, 2e-4)
    jx = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    if with_sca:
        jx[1] = tuple(map(jnp.asarray, args[1]))
    _close(got, _scc_block_pallas(*jx, interpret=True), 2e-3, 2e-3)


@pytest.mark.parametrize("win,nh,nw,with_sca", [(4, 2, 3, True), (8, 1, 2, True),
                                                (16, 1, 1, False), (32, 1, 1, True)])
def test_scc_wgmma_bf16_rounding_stays_within_the_plain_bf16_error(win, nh, nw, with_sca):
    """With the kernel's bfloat16 rounding points, the emulation stays as
    close to the float32 plain version as twice the plain bfloat16 version
    does (the bar the card tests hold the kernel to), and the hi + lo split
    matters: with M and VP_big rounded to bfloat16 alone the spatial branch
    moves at least 64x further from its float32 value than with the hi + lo
    pairs (~2^-8 against ~2^-16 relative)."""
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block_reference

    args = _scc_model_args(win, nh, nw, with_sca, seed=1)
    truth = scc_block_reference(*_torch_args(args))
    b16 = _torch_args(args, torch.bfloat16)
    e_plain = float((scc_block_reference(*b16).float() - truth).abs().max())
    f32 = _torch_args([a if not isinstance(a, np.ndarray) else
                       _t(a).to(torch.bfloat16).float().numpy() for a in args])
    if args[1] is not None:
        f32[1] = tuple(t.to(torch.float32) for t in b16[1])
    e_kernel = float((_emulate(f32) - truth).abs().max())
    scale = max(1.0, float(truth.abs().max()))
    assert e_kernel <= max(2.0 * e_plain, 4 * 2.0 ** -8 * scale), (e_kernel, e_plain)
    # the spatial branch alone, everything else in float32
    ident = lambda t: t
    exact = _emulate(f32, rnd=ident, spatial=True)
    hi_only = float((_emulate(f32, rnd=ident, part_rnd=_rbf, split=False, spatial=True)
                     - exact).abs().max())
    both = float((_emulate(f32, rnd=ident, part_rnd=_rbf, spatial=True) - exact).abs().max())
    assert 64 * both <= hi_only, (both, hi_only)


# --- htb_tail's wgmma path --------------------------------------------------

def htb_wgmma_emulation(attn, shortcut, ln1_s, ln1_b, w1, b1, dw, dwb, w2, b2, ln2_s, ln2_b,
                        rnd=_rbf):
    """What ``csrc/htb_tail.cu``'s wgmma path computes, over the packed W1
    (two halves of the hidden channels, C padded to 192) and W2 (C padded
    to 184 rows over Ch padded to 384), in float32 with its rounding points
    (``rnd``): x = s + LN1(a), fc1's product, + b1, gelu; the depthwise conv
    + dwb, gelu, h2; fc2's product, + b2, LN2, out."""
    from sisr_tpu_torch.ops.kernels.dwconv import depthwise_conv_reference
    from sisr_tpu_torch.ops.kernels.ffn import layer_norm, pack_w1, pack_w2

    f = lambda t: t.to(torch.float32)
    h, w, c = shortcut.shape[1:]
    ch = w1.shape[1]
    x = rnd(f(shortcut) + rnd(layer_norm(f(attn[:, :h, :w]), f(ln1_s), f(ln1_b))))
    w1p = rnd(pack_w1(f(w1)))
    acc = F.pad(x, (0, w1p.shape[1] - c)) @ w1p.t()
    rows = w1p.shape[0] // 2
    pre = torch.cat([acc[..., :ch // 2], acc[..., rows:rows + ch // 2]], dim=-1)
    hh = rnd(F.gelu(rnd(rnd(pre) + f(b1))))
    h2 = rnd(hh + rnd(F.gelu(rnd(depthwise_conv_reference(hh, f(dw), f(dwb))))))
    w2p = rnd(pack_w2(f(w2)))
    y = (F.pad(h2, (0, w2p.shape[1] - ch)) @ w2p.t())[..., :c]
    y = rnd(rnd(y) + f(b2))
    return rnd(x + rnd(layer_norm(y, f(ln2_s), f(ln2_b))))


def _tail_model_args(h, w, pad, b=2, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32) * 0.3
    c, ch = 180, 360
    return (mk(b, h + pad[0], w + pad[1], c), mk(b, h, w, c), mk(c) + 1.0, mk(c),
            mk(c, ch) / 4, mk(ch), mk(5, 5, ch), mk(ch), mk(ch, c) / 4, mk(c), mk(c) + 1.0,
            mk(c))


def test_htb_packs_round_trip_with_zero_padding():
    """pack_w1: hidden channel j of half g at row 184 g + j, K over C; pack_w2:
    output channel n at row n, K over Ch; zero elsewhere."""
    from sisr_tpu_torch.ops.kernels.ffn import pack_w1, pack_w2, wgmma_path

    rng = np.random.default_rng(3)
    w1, w2 = _t(rng.normal(size=(180, 360))), _t(rng.normal(size=(360, 180)))
    p1, p2 = pack_w1(w1), pack_w2(w2)
    assert p1.shape == (368, 192) and p2.shape == (184, 384)
    torch.testing.assert_close(p1[:180, :180], w1[:, :180].t(), rtol=0, atol=0)
    torch.testing.assert_close(p1[184:364, :180], w1[:, 180:].t(), rtol=0, atol=0)
    torch.testing.assert_close(p2[:180, :360], w2.t(), rtol=0, atol=0)
    assert int((p1 != 0).sum()) == int((w1 != 0).sum())
    assert int((p2 != 0).sum()) == int((w2 != 0).sum())
    assert wgmma_path(torch.bfloat16, 180, 360)
    assert not wgmma_path(torch.float32, 180, 360) and not wgmma_path(torch.bfloat16, 24, 48)


@pytest.mark.parametrize("h,w,pad", [(12, 20, (0, 0)), (9, 17, (7, 0))])
def test_htb_wgmma_layout_matches_reference_and_pallas(h, w, pad):
    """The packed W1 / W2 products, emulated in float32 (no rounding), at C =
    180, Ch = 360 with ragged maps and a window-padded attn, against the
    plain version (1e-4: the same float32 products in another order) and
    JAX's ``_htb_tail_pipe`` in interpret mode (1e-4, as
    ``test_torch_ops.py`` holds the plain version to it)."""
    from sisr_tpu.ops.pallas.ffn import _htb_tail_pipe
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail_reference

    args = _tail_model_args(h, w, pad)
    pt = [_t(a) for a in args]
    got = htb_wgmma_emulation(*pt, rnd=lambda t: t)
    _close(got, htb_tail_reference(pt[0][:, :h, :w], *pt[1:]), 1e-4, 1e-4)
    if pad == (0, 0):
        _close(got, _htb_tail_pipe(*map(jnp.asarray, args), interpret=True), 1e-4, 1e-4)


@pytest.mark.parametrize("h,w", [(12, 20), (9, 17)])
def test_htb_wgmma_bf16_rounding_stays_within_the_plain_bf16_error(h, w):
    """With the kernel's bfloat16 rounding points the emulation stays as
    close to the float32 plain version as twice the plain bfloat16 version
    does, or within 4 bf16 ulps of the output scale (the card tests' bar)."""
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail_reference

    pt = [_t(a) for a in _tail_model_args(h, w, (0, 0), seed=4)]
    b16 = [t.to(torch.bfloat16) for t in pt]
    up = [t.float() for t in b16]
    truth = htb_tail_reference(*up)
    e_plain = float((htb_tail_reference(*b16).float() - truth).abs().max())
    e_kernel = float((htb_wgmma_emulation(*up) - truth).abs().max())
    scale = max(1.0, float(truth.abs().max()))
    assert e_kernel <= max(2.0 * e_plain, 4 * 2.0 ** -8 * scale), (e_kernel, e_plain)


def test_htb_band_rows_bound_h_of_a_band():
    """The wgmma path's bands: one band where h fits 256 MiB (a 192x192 tile,
    a training batch), 192-row bands at the 1080p frame; always a multiple
    of 8 rows."""
    from sisr_tpu_torch.ops.kernels.ffn import _BAND_BYTES, band_rows

    assert band_rows(1, 192, 192, 360) == 192
    assert band_rows(2, 64, 64, 360) == 64
    assert band_rows(2, 13, 29, 360) == 16
    assert band_rows(1, 1088, 1920, 360) == 192
    for b, h, w in ((1, 1088, 1920), (4, 1088, 1920), (1, 4000, 4000)):
        rows = band_rows(b, h, w, 360)
        assert rows % 8 == 0 and rows >= 8
        assert rows == 8 or 2 * b * rows * w * 360 <= _BAND_BYTES


def test_weight_packs_are_kept_while_their_weights_are_unchanged():
    """``build.cached`` (scc_block's and htb_tail's packed weights): the same
    pack while the weights keep their version counters; a write to one of
    them, or another tensor, packs anew; an inference tensor every call."""
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.ops.kernels.scc_block import pack_wkv

    rng = np.random.default_rng(7)
    w1, w2 = _t(rng.normal(size=(90, 90))), _t(rng.normal(size=(90, 90)))
    make = lambda: pack_wkv(w1, w2, 6)
    first = build.cached(w1, "_test_pack", (w1, w2), make)
    assert build.cached(w1, "_test_pack", (w1, w2), make) is first
    w2.mul_(2.0)
    second = build.cached(w1, "_test_pack", (w1, w2), make)
    assert second is not first
    torch.testing.assert_close(second, pack_wkv(w1, w2, 6), rtol=0, atol=0)
    with torch.inference_mode():
        wi = w1 * 1.0
        assert build.cached(wi, "_test_pack", (wi,), make) is not \
            build.cached(wi, "_test_pack", (wi,), make)
