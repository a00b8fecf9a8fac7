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
    (16, 48, 96) and htb_tail (184) use, and the register-A n64 wrapper of
    the tail's conv_hr."""
    import importlib.util

    from sisr_tpu_torch.ops.kernels.conv3x3 import WGMMA_WIDTHS

    spec = importlib.util.spec_from_file_location("gen_wgmma", CSRC / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert set(WGMMA_WIDTHS) | {16, 48, 96, 184} <= set(gen.WIDTHS)
    assert 64 in gen.RS_WIDTHS                  # the tail's conv_hr, A from registers
    assert (CSRC / "wgmma.cuh").read_text() == gen.text()


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
                        rnd=_rbf, w1_read=lambda w1p: w1p):
    """What ``csrc/htb_tail.cu``'s wgmma path computes, over the packed W1
    (two halves of the hidden channels, C padded to 192) and W2 (C padded
    to 184 rows over Ch padded to 384), in float32 with its rounding points
    (``rnd``): x = s + LN1(a), fc1's product, + b1, gelu; the depthwise conv
    + dwb, gelu, h2; fc2's product, + b2, LN2, out.  ``w1_read`` maps the
    packed W1 to W1 as fc1's product reads it."""
    from sisr_tpu_torch.ops.kernels.dwconv import depthwise_conv_reference
    from sisr_tpu_torch.ops.kernels.ffn import layer_norm, pack_w1, pack_w2

    f = lambda t: t.to(torch.float32)
    h, w, c = shortcut.shape[1:]
    ch = w1.shape[1]
    x = rnd(f(shortcut) + rnd(layer_norm(f(attn[:, :h, :w]), f(ln1_s), f(ln1_b))))
    w1p = w1_read(rnd(pack_w1(f(w1))))
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


def _tail_constants() -> dict:
    """The wgmma tail's constexpr ints in ``csrc/htb_tail_wg.cuh``,
    evaluated in order (C's integer division as Python's)."""
    import re

    src = (CSRC / "htb_tail_wg.cuh").read_text()
    consts: dict = {}
    for decl in re.findall(r"^constexpr int (.*?);", src, re.M):
        for name, expr in re.findall(r"(\w+) = ([^,]+(?:\([^)]*\)[^,]*)*)", decl):
            consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    return consts


def test_htb_tail_wg_kernels_keep_the_roofline_prefix():
    """Every kernel of htb_tail.cu's wgmma path (namespace wgt) keeps
    ``htb_tail_`` in its name, so the benchmark's ``htb_tail_roofline``
    (kernels matching ``PATTERN``) reads both launches of a band."""
    import re

    src = (CSRC / "htb_tail.cu").read_text()
    body = src[src.index("namespace wgt {"):src.index("}  // namespace wgt")]
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", body)
    assert sorted(names) == ["htb_tail_fc1_wg", "htb_tail_out_wg"], names
    metric = (Path(__file__).resolve().parents[1] / "benchmark" / "metrics"
              / "htb_tail_roofline.py").read_text()
    pattern = re.search(r'^PATTERN = "(.*)"', metric, re.M).group(1)
    assert all(pattern in f"wgt::{name}" for name in names), (pattern, names)
    # both launches of a band go out under these names
    assert "htb_tail_fc1_wg<<<" in body and "launch_tail(htb_tail_out_wg" in body


@pytest.mark.parametrize("b,h,w,bands,tiles,blocks", [
    (2, 13, 29, 1, [8], [8]),                    # ragged, smaller than the card
    (1, 192, 192, 1, [288], [132]),              # a photo's 192x192 tile
    (2, 64, 64, 1, [64], [64]),                  # a training batch
    (1, 1088, 1920, 6, [2880] * 5 + [1920], [132] * 6),   # the 1080p frame
    (4, 1088, 1920, 23, [2880] * 22 + [1920], [132] * 23),   # four frames: 48-row bands
])
def test_htb_tail_grid_plan(b, h, w, bands, tiles, blocks):
    """The tail's launches (``ffn.tail_plan``, as ``wgt::launch`` and
    ``wgt::tail_grid`` plan them): each band's 8x16 tiles, one persistent block an SM
    (132 on the H100) or one a tile where there are fewer; the bands cover
    every row once, each a multiple of 8 rows but the last."""
    from sisr_tpu_torch.ops.kernels import ffn

    consts = _tail_constants()
    assert (consts["TH"], consts["TW"]) == (8, 16)
    plan = ffn.tail_plan(b, h, w, 360, 132)
    assert len(plan) == bands
    assert plan[0][0] == 0 and plan[-1][1] == h
    for (r0, r1, n, grid), nxt in zip(plan, plan[1:] + [None]):
        assert nxt is None or (nxt[0] == r1 and (r1 - r0) % consts["TH"] == 0)
        assert n == b * -(-(r1 - r0) // consts["TH"]) * -(-w // consts["TW"])
        assert grid == min(n, 132) >= 1
    if tiles is not None:
        assert [p[2] for p in plan] == tiles and [p[3] for p in plan] == blocks


def test_htb_tail_shared_memory_and_ring_sizes():
    """The tail's block (``csrc/htb_tail_wg.cuh``): two consumer
    warpgroups and a producer warpgroup, 168 registers a thread at launch
    rebalanced to 232 a consumer and 40 the producer's (65,536 an SM); W2 resident (184 x 384 bf16), each consumer's h2 one 64 x 64 K
    block, two ring stages of exactly the three TMA boxes (h 64 x 20 x 12,
    the 25 taps and dwb of 64 channels), wgmma operands on 1024 bytes, all
    within the 227 KB a block may take."""
    c = _tail_constants()
    assert c["NTT"] == 3 * 128 and 2 * 128 * 232 + 128 * 40 <= 65536
    src = (CSRC / "htb_tail_wg.cuh").read_text()
    assert "setmaxnreg.dec.sync.aligned.u32 40;" in src
    assert "setmaxnreg.inc.sync.aligned.u32 232;" in src
    assert c["H2_OFF"] == c["NH"] * c["NCH"] * c["HC"] * 2 == 184 * 384 * 2
    assert c["H2C_B"] == 64 * c["HC"] * 2
    assert c["STAGE_B"] == 2 * c["HC"] * (c["PW"] * c["PH"] + 25 + 1)
    assert (c["PW"], c["PH"], c["HC"], c["NCH"], c["STAGES"]) == (20, 12, 64, 6, 2)
    assert c["RING_OFF"] == c["H2_OFF"] + 2 * c["H2C_B"]
    assert c["PAR_OFF"] == c["RING_OFF"] + c["STAGES"] * c["STAGE_B"]
    assert c["STAT_OFF"] - c["PAR_OFF"] >= 3 * 180 * 2
    assert c["BAR_OFF"] - c["STAT_OFF"] == 2 * 2 * 180 * 4
    assert c["SMEM2"] == c["BAR_OFF"] + 2 * c["STAGES"] * 8 + 1024 <= 232448
    for key in ("W2C_B", "H2_OFF", "H2C_B"):
        assert c[key] % 1024 == 0, key
    for key in ("RING_OFF", "STAGE_B", "HALO_B"):
        assert c[key] % 128 == 0, key


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


# --- htb_fused's wgmma path -------------------------------------------------

# launch A's shared memory in bytes (csrc/htb_fused.cu, namespace fwg, over
# csrc/scc_wg.cuh's regions): the attention's tiles, then W1's 64-deep K
# blocks (SW(368, 64), 47,104 bytes each) where they land
_XA_B, _PM_B, _G_B, _META_B, _U_ATT = 24576, 8192, 24576, 1024, 86016
_W1C_B, _XR_B, _PAR1_B, _X2_B, _SMEM_MAX = 47104, 64 * 180 * 2, (2 * 180 + 360) * 2, 24576, 232448


def fused_layout(lb):
    """Launch A's layout at windows of ``lb`` tokens, as byte offsets from its
    first region: W1's K blocks (the first ``nf`` over the regions the
    window loop frees, bias to Ball, beside the x rows and the LN1 / fc1
    parameters; the others over U once the projection's product is done),
    the x2 tile, and the bytes the kernel asks for (1024 of alignment
    slack included)."""
    bias_b = 64 * ((6 * lb + 63) // 64 * 64) * 2
    ball_b = 96 * ((2 * (16 + lb) + 63) // 64 * 64) * 2
    xs_ball_b = max(ball_b, 64 * 180 * 2 + 64 * 18 * 2 + 256)
    free = bias_b + _PM_B + _G_B + xs_ball_b
    nf = (free - _XR_B - _PAR1_B) // _W1C_B
    u = _XA_B + free + _META_B
    blocks = [_XA_B + k * _W1C_B if k < nf else u + (k - nf) * _W1C_B for k in range(3)]
    x2t = u + (3 - nf) * _W1C_B
    smem = u + max(_U_ATT, (3 - nf) * _W1C_B + _X2_B) + 1024
    return dict(nf=nf, blocks=blocks, x2t=x2t, free=(_XA_B, _XA_B + free), u=u, smem=smem)


def w1_through_shared_memory(w1p, lb):
    """The packed W1 (368, 192) as launch A's fc1 reads it: each K block
    staged by ``wgt::stage_w1``'s copies (16 bytes: row n, chunk c at n * 128
    + ((c ^ n % 8) << 4) of its block) into a model of the shared memory at
    ``fused_layout``'s offsets, then read back through the wgmma
    descriptors' 128-byte swizzle, element (n, k) of block b at
    blocks[b] + n * 128 + ((k // 8 ^ n % 8) << 4) + 2 (k % 8)."""
    lay = fused_layout(lb)
    rows = w1p.shape[0]
    mem = torch.full((lay["smem"] // 2,), float("nan"))
    n = torch.arange(rows)[:, None, None]
    c = torch.arange(8)[None, :, None]
    j = torch.arange(8)[None, None, :]
    for b, base in enumerate(lay["blocks"]):
        byte = base + n * 128 + ((c ^ (n % 8)) << 4) + 2 * j
        mem[byte // 2] = w1p[n, 64 * b + 8 * c + j]
    k = torch.arange(64)[None, :]
    nn = torch.arange(rows)[:, None]
    return torch.cat([mem[(base + nn * 128 + (((k // 8) ^ (nn % 8)) << 4) + 2 * (k % 8)) // 2]
                      for base in lay["blocks"]], dim=1)


def htb_fused_wgmma_emulation(x, sca, w1, w2, bb, pmat, pb, bias, proj_k, proj_b, heads,
                              window, *tail, rnd=_rbf):
    """What ``csrc/htb_fused.cu``'s wgmma path computes: launch A's attention
    (scc_block's wgmma phases: ``scc_wgmma_emulation``, attn rounded as the
    chain stores it), x2 = x + LN1(attn) and h = gelu(x2 W1 + b1) with W1
    read through launch A's shared memory (``w1_through_shared_memory``),
    then launch B (htb_tail's wgmma tail): ``htb_wgmma_emulation`` with the
    block's input as the shortcut, each value rounded where the chain
    rounds."""
    attn = scc_wgmma_emulation(x, sca, w1, w2, bb, pmat, pb, bias, proj_k, proj_b, heads,
                               window, rnd=rnd)
    lb = window[0] * window[1]
    return htb_wgmma_emulation(attn, x, *tail, rnd=rnd,
                               w1_read=lambda w1p: w1_through_shared_memory(w1p, lb))


def _fused_model_args(win, nh, nw, threaded, seed=0):
    """numpy inputs of one degenerate-window block of the model (C = 180, 6
    heads, Ch = 360, base window 8: windows 4 and 8 pool by one scalar),
    batch 2; ``threaded``: sca carries the previous tail's (cmean, cmax)
    maps, shifted off x's own pools."""
    args = list(_scc_model_args(win, nh, nw, True, seed=seed))
    if threaded:
        x = args[0]
        args[1] = args[1] + (x.mean(-1) + 0.1, x.max(-1) - 0.1)
    return args + list(_tail_model_args(1, 1, (0, 0), seed=seed + 1)[2:])


def _fused_torch(args, dtype=torch.float32):
    pt = _torch_args(args, dtype)
    pt[13:] = [_t(a).to(dtype) for a in args[13:]]
    return pt


def test_fused_layout_places_w1_in_free_regions():
    """Launch A's shared memory at windows of 16 and 64 tokens: W1's first
    K blocks (two at L = 64, one at 16) with the x rows and the parameters
    inside the regions the window loop frees, the others and the x2 tile
    inside U, every block 1024-byte aligned, nothing overlapping, within
    the 227 KB a block may ask for; the read-back returns W1 unchanged."""
    for lb, nf in ((16, 1), (64, 2)):
        lay = fused_layout(lb)
        assert lay["nf"] == nf and lay["smem"] <= _SMEM_MAX
        f0, f1 = lay["free"]
        assert f0 + nf * _W1C_B + _XR_B + _PAR1_B <= f1
        spans = [(o, o + _W1C_B) for o in lay["blocks"]] + [(lay["x2t"], lay["x2t"] + _X2_B)]
        assert all(o % 1024 == 0 for o, _ in spans)
        assert all(e <= lay["smem"] - 1024 for _, e in spans)
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert all(f0 <= o and o + _W1C_B <= f1 for o in lay["blocks"][:nf])
        assert all(lay["u"] <= o for o in lay["blocks"][nf:])
        w1p = _t(np.random.default_rng(lb).normal(size=(368, 192)))
        torch.testing.assert_close(w1_through_shared_memory(w1p, lb), w1p, rtol=0, atol=0)


@pytest.mark.parametrize("win,nh,nw,threaded", [(4, 2, 3, False), (4, 3, 2, True),
                                                (8, 1, 2, False), (8, 2, 1, True)])
def test_htb_fused_wgmma_layout_matches_reference_and_pallas(win, nh, nw, threaded):
    """The new launches' layouts (the attention's slots, W1's K blocks in
    shared memory, x2 and h), emulated in float32 (no rounding), at C =
    180, 6 heads, Ch = 360, windows 4 and 8, batch 2, with SCA and with the
    previous tail's threaded maps: against the plain version (3e-4: the
    same float32 products in another order, as the scc emulation's 2e-4
    and the tail's 1e-4 add up) and JAX's Pallas ``htb_fused`` in interpret
    mode (3e-3, as ``test_torch_ops.py`` holds the plain version to it)."""
    from sisr_tpu.ops.pallas.htb_block import htb_fused as jx_fused
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused_reference, wgmma_path

    args = _fused_model_args(win, nh, nw, threaded)
    assert wgmma_path(torch.bfloat16, 180, 6, 360, win * win)
    pt = _fused_torch(args)
    got = htb_fused_wgmma_emulation(*pt[:7], *pt[8:], rnd=lambda t: t)
    _close(got, htb_fused_reference(*pt), 3e-4, 3e-4)
    jx = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    jx[1] = tuple(map(jnp.asarray, args[1]))
    _close(got, jx_fused(*jx, interpret=True), 3e-3, 3e-3)


@pytest.mark.parametrize("win,nh,nw,threaded", [(4, 2, 3, True), (8, 1, 2, False)])
def test_htb_fused_wgmma_bf16_rounding_stays_within_the_plain_bf16_error(win, nh, nw,
                                                                        threaded):
    """With the new launches' bfloat16 rounding points (the chain's: qkv, k,
    [out_s | out_c], attn, x2, h, out), the emulation stays as close to the
    float32 plain version as twice the plain bfloat16 version does, or
    within 4 bf16 ulps of the output scale (the card tests' bar)."""
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused_reference

    args = _fused_model_args(win, nh, nw, threaded, seed=5)
    b16 = _fused_torch(args, torch.bfloat16)
    up = [t.float() if isinstance(t, torch.Tensor) else t for t in b16]
    up[1] = tuple(t.float() for t in b16[1])
    truth = htb_fused_reference(*up)
    e_plain = float((htb_fused_reference(*b16).float() - truth).abs().max())
    e_kernel = float((htb_fused_wgmma_emulation(*up[:7], *up[8:]) - truth).abs().max())
    scale = max(1.0, float(truth.abs().max()))
    assert e_kernel <= max(2.0 * e_plain, 4 * 2.0 ** -8 * scale), (e_kernel, e_plain)


def test_htb_fused_shape_rule_mirrors_the_kernel():
    """``htb_block.wgmma_path`` against ``csrc/htb_fused.cu``'s
    ``fwg::takes``, its return expression read from the source and
    evaluated over model and other shapes: bfloat16 at C = 180 in 6 heads,
    Ch = 360 and windows of 16 or 64 tokens (the flagship's fused blocks)
    take the new launches; float32 and every other shape the earlier ones."""
    import re

    from sisr_tpu_torch.ops.kernels.htb_block import wgmma_path

    src = (CSRC / "htb_fused.cu").read_text()
    body = re.search(r"inline bool takes\(int C, int heads, int Ch, int L\) \{\s*return (.*?);",
                     src, re.S).group(1)
    expr = (body.replace("wgs::CC", "180").replace("wgs::HEADS", "6").replace("wgt::CH", "360")
            .replace("&&", " and ").replace("||", " or "))
    for c, heads, ch, l in [(180, 6, 360, 16), (180, 6, 360, 64), (180, 6, 360, 256),
                            (180, 6, 360, 4), (180, 2, 360, 16), (24, 6, 48, 16),
                            (180, 6, 720, 64), (20, 2, 40, 64)]:
        want = eval(expr, {}, dict(C=c, heads=heads, Ch=ch, L=l))
        assert wgmma_path(torch.bfloat16, c, heads, ch, l) == want, (c, heads, ch, l)
        assert not wgmma_path(torch.float32, c, heads, ch, l)
    assert wgmma_path(torch.bfloat16, 180, 6, 360, 16) and wgmma_path(torch.bfloat16, 180, 6,
                                                                        360, 64)


# --- the x4 head's shuffled convs on wgmma (conv3x3_shuffled, the tails) ------

# the tail kernels' hr region and output tile (csrc/shuffled_tail.cu, rg)
TAIL_RH, TAIL_RW = 16, 32
TAIL_OH, TAIL_OW = TAIL_RH - 2, TAIL_RW - 2


def shuffled_rows_emulation(yp, kpad):
    """The im2col rows the shuffled 16-byte gather reads (``conv_gemm.cuh::
    sgw``), one per pixel (b, y, x) of the x2 shuffled image, (B, 2H, 2W,
    kpad): column k = tap*Cin + ci holds yp[b, yy>>1, xx>>1, ((xx&1)*2 +
    (yy&1))*Cin + ci] at (yy, xx) = (y + tap//3 - 1, x + tap%3 - 1), zero
    where that lies outside the image and past K = 9*Cin."""
    b, h2, w2, c4 = yp.shape
    cin, h, w = c4 // 4, 2 * h2, 2 * w2
    ys, xs = torch.arange(h).view(h, 1), torch.arange(w).view(1, w)
    cols = []
    for tap in range(9):
        yy, xx = ys + tap // 3 - 1, xs + tap % 3 - 1
        inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).to(yp.dtype)
        yc, xc = yy.clamp(0, h - 1).expand(h, w), xx.clamp(0, w - 1).expand(h, w)
        chan = (((xc & 1) * 2 + (yc & 1)) * cin)[..., None] + torch.arange(cin)
        cols.append(yp[:, (yc >> 1)[..., None], (xc >> 1)[..., None], chan]
                    * inside[..., None])
    return F.pad(torch.cat(cols, dim=-1), (0, kpad - 9 * cin))


def shuffled_wgmma_emulation(yp, k, bias, act):
    """conv3x3_shuffled as its wgmma kernel computes it: the gathered rows
    times ``pack_weights(k, wgmma_width(Cin, Cout, shuffled=True))``, the
    first Cout columns, + bias, act."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import _act, pack_weights, wgmma_width

    cin, cout = k.shape[2:]
    packed = pack_weights(k, wgmma_width(cin, cout, shuffled=True))
    a = shuffled_rows_emulation(yp, packed.shape[1])
    return _act((a @ packed.t())[..., :cout] + bias, act)


def tail_wgmma_emulation(yp, k1, b1, act1, k2, b2, rnd=_rbf):
    """The region tail (``tail_wgmma_kernel``; ``tail_f32_kernel`` with
    ``rnd`` the identity) block by block.  hr covers a 16 x 32 region
    starting one pixel above and left of the block's 14 x 30 output tile,
    in 4 passes of 128 rows: pass c reads the 6 x 34 patch of shuffled
    pixels (rows from 4c - 1 above the region's first, columns from one
    left of it, zero outside the image, through the 16-byte gather's
    address), and the A row of pass row (ar, ac) at tap (dy, dx) is patch
    pixel (ar + dy) * 34 + ac + dx; times ``pack_weights(k1, 64)``, + b1,
    act1, rounded by ``rnd``, zero outside the image.  conv_last: m16
    tiles of the 420 output pixels (row-major in the tile, the last tile's
    rows past 420 clamped to pixel 419, as the kernel's ldmatrix addresses
    are), each tap's A rows read at region row (p // 30 + dy) * 32 + p % 30
    + dx, times the tap's conv_last weights padded to n8."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import _act, pack_weights

    b, h2, w2, c4 = yp.shape
    cin, c1, cout = c4 // 4, k1.shape[-1], k2.shape[-1]
    h, w = 2 * h2, 2 * w2
    w1p = pack_weights(k1, 64)
    b1p = F.pad(b1, (0, 64 - c1))
    ny, nx = -(-h // TAIL_OH), -(-w // TAIL_OW)
    # the shuffled image (the gather's centre tap) with a zero ring two
    # pixels wide, large enough for every patch
    image = shuffled_rows_emulation(yp, 9 * cin)[..., 4 * cin:5 * cin]
    image = F.pad(image, (0, 0, 2, nx * TAIL_OW + 2 - w, 2, ny * TAIL_OH + 2 - h))
    ys, xs = torch.arange(h).view(h, 1), torch.arange(w).view(1, w)
    arow = torch.arange(128)
    ar, ac = arow // TAIL_RW, arow % TAIL_RW
    w2p = torch.zeros(9, 64, 8, dtype=k2.dtype)
    w2p[:, :c1, :cout] = k2.reshape(9, c1, cout)
    npix = TAIL_OH * TAIL_OW
    p = torch.arange(-(-npix // 16) * 16).clamp(max=npix - 1)
    out = torch.zeros(b, ny * TAIL_OH, nx * TAIL_OW, cout, dtype=yp.dtype)
    for by in range(ny):
        for bx in range(nx):
            oy0, ox0 = by * TAIL_OH, bx * TAIL_OW
            passes = []
            for c in range(TAIL_RH * TAIL_RW // 128):
                # patch pixel (pr, pc): image row oy0 - 2 + 4c + pr, column ox0 - 2 + pc
                patch = image[:, oy0 + 4 * c:oy0 + 4 * c + 6, ox0:ox0 + 34].reshape(b, -1, cin)
                a = torch.cat([patch[:, (ar + t // 3) * 34 + ac + t % 3] for t in range(9)], -1)
                passes.append(a @ w1p.t())
            region = _act(torch.cat(passes, 1) + b1p, act1)
            ry = oy0 - 1 + torch.arange(TAIL_RH * TAIL_RW) // TAIL_RW
            rx = ox0 - 1 + torch.arange(TAIL_RH * TAIL_RW) % TAIL_RW
            inside = ((ry >= 0) & (ry < h) & (rx >= 0) & (rx < w)).to(yp.dtype)[:, None]
            region = rnd(region) * inside
            d = 0
            for t in range(9):
                rr = (p // TAIL_OW + t // 3) * TAIL_RW + p % TAIL_OW + t % 3
                d = d + region[:, rr] @ w2p[t]
            tile = d[:, :npix, :cout].reshape(b, TAIL_OH, TAIL_OW, cout) + b2
            out[:, oy0:oy0 + TAIL_OH, ox0:ox0 + TAIL_OW] = tile
    return out[:, :h, :w]


def _shuffled_inputs(rng, b, h2, w2, cin, c1, cout):
    mk = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return (mk(b, h2, w2, 4 * cin), mk(3, 3, cin, c1, scale=(9 * cin) ** -0.5), mk(c1, scale=0.1),
            mk(3, 3, c1, cout, scale=(9 * c1) ** -0.5), mk(cout, scale=0.1))


@pytest.mark.parametrize("h2,w2,cin,cout,act", [(3, 5, 8, 16, "leaky2"), (4, 6, 16, 40, "none"),
                                                (2, 3, 64, 256, "leaky2")])
def test_shuffled_wgmma_gather_matches_reference_and_pallas(h2, w2, cin, cout, act):
    """The shuffled conv's 16-byte gather and packed weights, emulated in
    float32, at Cin 8, 16 and the model's 64 -> 256, against the plain
    version and JAX's ``_conv3x3_shuffled_pallas`` in interpret mode: 1e-4
    (the same float32 products in another order)."""
    from sisr_tpu.ops.pallas.conv3x3 import _conv3x3_shuffled_pallas
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled_reference

    yp, k, bias = _shuffled_inputs(np.random.default_rng(11), 2, h2, w2, cin, cout, 3)[:3]
    got = shuffled_wgmma_emulation(_t(yp), _t(k), _t(bias), act)
    assert tuple(got.shape) == (2, 2 * h2, 2 * w2, cout)
    _close(got, conv3x3_shuffled_reference(_t(yp), _t(k), _t(bias), act), 1e-4, 1e-4)
    _close(got, _conv3x3_shuffled_pallas(jnp.asarray(yp), jnp.asarray(k), jnp.asarray(bias),
                                         act, interpret=True), 1e-4, 1e-4)


@pytest.mark.parametrize("h2,w2,cin,c1,cout", [(8, 16, 64, 64, 3), (12, 20, 64, 12, 5),
                                               (9, 13, 64, 64, 3)])
def test_tail_region_layout_matches_reference_and_pallas(h2, w2, cin, c1, cout):
    """The region tail's tiling (16 x 32 hr regions, 14 x 30 output tiles,
    partial at the right and bottom edges), its passes' input patches, its
    hr layout and its conv_last operands (m16 rows by tap, w2 padded to
    n8), emulated in float32 without rounding, against the plain version
    and JAX's ``_conv3x3_shuffled_tail_pallas`` in interpret mode: 1e-4."""
    from sisr_tpu.ops.pallas.conv3x3 import _conv3x3_shuffled_tail_pallas
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled_tail_reference

    args = _shuffled_inputs(np.random.default_rng(12), 1, h2, w2, cin, c1, cout)
    yp, k1, b1, k2, b2 = map(_t, args)
    got = tail_wgmma_emulation(yp, k1, b1, "leaky2", k2, b2, rnd=lambda t: t)
    assert tuple(got.shape) == (1, 2 * h2, 2 * w2, cout)
    _close(got, conv3x3_shuffled_tail_reference(yp, k1, b1, "leaky2", k2, b2), 1e-4, 1e-4)
    jx = [jnp.asarray(a) for a in args]
    _close(got, _conv3x3_shuffled_tail_pallas(jx[0], jx[1], jx[2], "leaky2", jx[3], jx[4],
                                              interpret=True), 1e-4, 1e-4)


@pytest.mark.parametrize("h2,w2,cin,c1,cout", [(8, 16, 64, 64, 3), (5, 18, 64, 12, 5)])
def test_tail_wgmma_bf16_rounding_stays_within_the_plain_bf16_error(h2, w2, cin, c1, cout):
    """With hr rounded to bfloat16 where the plain version stores it, the
    emulation on bfloat16 inputs stays as close to the float32 plain
    version as twice the plain bfloat16 version does, or within 4 bf16 ulps
    of the output scale (the card tests' bar)."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled_tail_reference

    args = [_t(a) for a in _shuffled_inputs(np.random.default_rng(13), 1, h2, w2, cin, c1, cout)]
    b16 = [t.to(torch.bfloat16) for t in args]
    up = [t.float() for t in b16]
    ref = lambda a: conv3x3_shuffled_tail_reference(a[0], a[1], a[2], "leaky2", a[3], a[4])
    truth = ref(up)
    e_plain = float((ref(b16).float() - truth).abs().max())
    got = _rbf(tail_wgmma_emulation(up[0], up[1], up[2], "leaky2", up[3], up[4]))
    e_kernel = float((got - truth).abs().max())
    scale = max(1.0, float(truth.abs().max()))
    assert e_kernel <= max(2.0 * e_plain, 4 * 2.0 ** -8 * scale), (e_kernel, e_plain)


def test_shuffled_shape_rules_mirror_the_kernels():
    """The shuffled conv's wgmma rule (``conv3x3.cu::wgmma_ok`` with shuf:
    Cin % 8 == 0 for its 16-byte copies) and the tails' (``shuffled_tail.cu::
    wgmma_ok``: Cin == 64): the model's shapes take the new kernels; the
    shapes outside keep the earlier ones."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import tail_wgmma, wgmma_width

    assert wgmma_width(64, 256, shuffled=True) == 256       # conv_up2
    assert wgmma_width(8, 12, shuffled=True) == 64
    assert wgmma_width(12, 16, shuffled=True) is None       # Cin % 8 != 0
    assert wgmma_width(12, 16) == 64                        # the plain conv's 8-byte copies
    assert wgmma_width(64, 3, shuffled=True) is None        # odd Cout
    assert tail_wgmma(64, 64, 3) and tail_wgmma(64, 12, 5)  # conv_hr + conv_last
    assert not tail_wgmma(8, 12, 3)                         # a patch pixel is 64 channels
    assert not tail_wgmma(72, 64, 3)
    assert not tail_wgmma(64, 64, 9)                        # conv_last is n8


# --- the Fusion gate's kernels (fusion.cu) -----------------------------------

def pools_emulation(a, b, layout):
    """What ``csrc/fusion.cu``'s pools compute, in their order, with
    ``layout`` (``pools_layout``): a + b rounded to a's type; the C pools
    (pools_cw) as 8 lanes a pixel, each summing its share of the channel
    groups (``v`` channels each, in order), combined by a xor-shuffle tree;
    the W pools (pools_cw) as each pixel lane's pixels (pl, pl + pl_n, ..)
    in order, then the lanes in order; the H pools (pools_h) as 4 row
    groups (rows g, g + 4, ..), then the groups in order.  Means divided at
    the end; cp and wp rounded to a's type, hp float32."""
    dt = a.dtype
    bsz, h, w, c = a.shape
    v, pl_n = layout.v, layout.pl
    g = c // v
    parts, per = 8, -(-g // 8)
    srcs = [a.float(), (a.float() + b.float()).to(dt).float(), b.float()]
    cps, hps, wps = [], [], []

    def seq(items, op):
        acc = items[0]
        for item in items[1:]:
            acc = op(acc, item)
        return acc

    for x in srcs:
        for op, mean in ((torch.add, True), (torch.maximum, False)):
            # C: each lane's groups, v channels at a time, then the xor tree
            chans = [x[..., i] for i in range(c)]
            neutral = (torch.zeros_like(chans[0]) if mean
                       else torch.full_like(chans[0], -float("inf")))
            lanes = [seq([neutral] + chans[min(g, part * per) * v:min(g, part * per + per) * v],
                         op) for part in range(parts)]
            for o in (4, 2, 1):
                lanes = [op(lanes[i], lanes[i ^ o]) for i in range(parts)]
            cps.append((lanes[0] / c if mean else lanes[0]).to(dt))
            # W: each pixel lane's pixels in order, then the lanes in order
            lane_sums = [seq([x[:, :, q] for q in range(lane, w, pl_n)], op)
                         for lane in range(min(pl_n, w))]
            wpool = seq(lane_sums, op)
            wps.append((wpool / w if mean else wpool).to(dt))
            # H: four row groups in order, then the groups in order
            groups = [seq([x[:, y] for y in range(rg, h, 4)], op) for rg in range(min(4, h))]
            hpool = seq(groups, op)
            hps.append(hpool / h if mean else hpool)
    return torch.stack(cps, 1), torch.stack(hps, 1), torch.stack(wps, 1)


@pytest.mark.parametrize("shape", [(2, 16, 12, 20), (1, 18, 40, 12), (1, 24, 70, 8),
                                   (1, 7, 5, 7)])
def test_pools_order_matches_reference_and_pallas(shape):
    """The pools' order (C by lanes and a shuffle tree, W by pixel lanes, H
    by row groups) in float32 against the plain version at 1e-5 and JAX's
    ``_fusion_pools_pallas`` in interpret mode at 1e-5 (``test_torch_ops.py``'s
    bar) where its row tiles allow (H % 8 == 0); heights 18 and 7 leave a
    partial row group, widths 70 and 5 a partial chunk, C = 7 one channel a
    thread."""
    from sisr_tpu.ops.pallas.fusion_ops import _fusion_pools_pallas
    from sisr_tpu_torch.ops.kernels.fusion_ops import fusion_pools_reference, pools_layout

    rng = np.random.default_rng(11)
    a, b = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    bsz, _, w, c = shape
    bsz, _, w, c = shape
    got = pools_emulation(_t(a), _t(b), pools_layout(bsz, w, c, 4))
    ref = fusion_pools_reference(_t(a), _t(b))
    for g, r in zip(got, ref):
        _close(g, r, 1e-5, 1e-5)
        assert torch.equal(g[:, 1::2], r[:, 1::2])   # the max slots: exact in any order
    if shape[1] % 8 == 0:
        for g, j in zip(got, _fusion_pools_pallas(jnp.asarray(a), jnp.asarray(b),
                                                  interpret=True)):
            _close(g, j, 1e-5, 1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 12, 20), (1, 18, 40, 12)])
def test_pools_bf16_order_keeps_the_plain_rounding(shape):
    """In bfloat16 the kernel's order rounds where the plain version rounds
    (a + b, cp, wp): the emulation stays within one bfloat16 ulp of the
    plain bfloat16 version, and its max slots are equal to it."""
    from sisr_tpu_torch.ops.kernels.fusion_ops import fusion_pools_reference, pools_layout

    rng = np.random.default_rng(12)
    a, b = (_t(rng.normal(size=shape)).to(torch.bfloat16) for _ in range(2))
    got = pools_emulation(a, b, pools_layout(shape[0], shape[2], shape[3], 2))
    for g, r in zip(got, fusion_pools_reference(a, b)):
        assert g.dtype == r.dtype
        _close(g.float(), r.float(), 2.0 ** -8, 2.0 ** -7)
        assert torch.equal(g[:, 1::2], r[:, 1::2])


def test_pools_layout_mirrors_the_kernel():
    """``pools_layout`` (``csrc/fusion.cu::cw_layout``): at C = 180 pools_cw
    takes 8 pixel lanes of 45 four-channel groups (360 threads) and chunks
    of 32 pixels in bfloat16, 16 in float32; C % 4 != 0 or misaligned
    pointers take one channel a thread; narrow rows fewer lanes; the shapes
    the kernel refuses are None."""
    from sisr_tpu_torch.ops.kernels.fusion_ops import pools_layout

    assert pools_layout(1, 192, 180, 2) == (4, 4, 8, 360, 32)
    assert pools_layout(1, 1920, 180, 2) == (4, 4, 8, 360, 32)
    assert pools_layout(2, 64, 180, 4) == (4, 2, 8, 360, 16)
    assert pools_layout(1, 3, 300, 2) == (4, 4, 1, 75, 4)        # one lane covers the row
    assert pools_layout(1, 5, 7, 2).v == 1                       # C % 4 != 0
    assert pools_layout(1, 8, 180, 2, aligned=False).v == 1
    assert pools_layout(1, 8, 385, 2) is None                    # 385 groups of one
    assert pools_layout(1, 8, 1540, 2) is None                   # 385 groups of four
    assert pools_layout(65536, 8, 180, 2) is None


def fused_fusion_emulation(a, b, pools, packed, rnd=lambda t: t):
    """What ``csrc/fusion.cu``'s maps and gate compute from the pools and
    ``pack_params``'s weights, in float32 with the kernel's rounding points
    (``rnd``: bfloat16, or the identity): c_att from cp by conv1, rounded
    (p27); h_att (w_att) from hp (wp) by conv2 (conv3); each UA's and side's
    folded maps as ONE product, the rows of h_att (w_att) with their +-1
    neighbours (N, 3C), rounded, times the (3C, 3C) block of khw whose row
    block j and column block q is khw[k][base + 3q + j]: [main | corr0 |
    corr1]; the gate from base = p27 @ k1blk, the maps and their border
    corrections; out rounded to a's type."""
    f32 = torch.float32
    c1w, c2w, c3w, cb, khw, clb, k1blk = (t.to(f32) for t in packed)
    cp3, hp3, wp3 = (t.to(f32) for t in pools)
    bsz, h, w, c = a.shape

    def conv18(m0, m1, taps, bias):
        """3x3 2-in-1-out conv over the last two axes, taps [ch*9 + i*3 + j]
        along (axis -2, axis -1), zero padded."""
        pad = [F.pad(m, (1, 1, 1, 1)) for m in (m0, m1)]
        n0, n1 = m0.shape[-2:]
        out = torch.zeros_like(m0)
        for ch in range(2):
            for i in range(3):
                for j in range(3):
                    out = out + pad[ch][..., i:i + n0, j:j + n1] * taps[ch * 9 + i * 3 + j]
        return out + bias

    atts = []
    for k in range(3):
        catt = rnd(conv18(cp3[:, 2 * k], cp3[:, 2 * k + 1], c1w[k], cb[3 * k]))  # (B, H, W)
        # the side convs run over the grid (C, N): taps [ch*9 + a*3 + bb], a along C
        hatt = conv18(hp3[:, 2 * k].transpose(1, 2), hp3[:, 2 * k + 1].transpose(1, 2),
                      c2w[k], cb[3 * k + 1]).transpose(1, 2)                    # (B, W, C)
        watt = conv18(wp3[:, 2 * k].transpose(1, 2), wp3[:, 2 * k + 1].transpose(1, 2),
                      c3w[k], cb[3 * k + 2]).transpose(1, 2)                    # (B, H, C)
        maps = []
        for att, base in ((hatt, 0), (watt, 9)):
            n = att.shape[1]
            ap = F.pad(att, (0, 0, 1, 1))
            rows = rnd(torch.cat([ap[:, j:j + n] for j in range(3)], -1))       # (B, N, 3C)
            blk = torch.cat([torch.cat([khw[k, base + 3 * q + j] for q in range(3)], 1)
                             for j in range(3)], 0)                             # (3C, 3C)
            prod = rows @ blk
            maps.append([prod[..., q * c:(q + 1) * c] for q in range(3)])
        (hout, hc0, hc1), (wout, wc0, wc1) = maps
        hout = hout + clb[k]
        cpad = F.pad(catt, (1, 1, 1, 1))
        p9 = torch.stack([cpad[:, i:i + h, j:j + w] for i in range(3) for j in range(3)], -1)
        base = p9 @ k1blk[9 * k:9 * (k + 1), k * c:(k + 1) * c]                 # (B, H, W, C)
        att = base + hout[:, None] + wout[:, :, None]
        att[:, 0] -= hc0
        att[:, h - 1] -= hc1
        att[:, :, 0] -= wc0
        att[:, :, w - 1] -= wc1
        atts.append(att)
    g = torch.sigmoid(atts[1])
    out = (a.to(f32) * torch.sigmoid(atts[0] * g)
           + b.to(f32) * torch.sigmoid(atts[2] * (1.0 - g)))
    return out.to(a.dtype)


def _fusion_args(shape, seed):
    rng = np.random.default_rng(seed)
    a, b = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    mk = lambda *s: rng.normal(size=s).astype(np.float32) * 0.3
    c = shape[-1]
    raws = tuple(((mk(3, 3, 2, 1), mk(1)), (mk(3, 3, 2, 1), mk(1)), (mk(3, 3, 2, 1), mk(1)),
                  (mk(3, 3, c, c) / np.sqrt(c), mk(c))) for _ in range(3))
    return a, b, raws


def _nest(raws, fn):
    return tuple(tuple((fn(k), fn(b)) for k, b in ua) for ua in raws)


@pytest.mark.parametrize("shape", [(2, 16, 8, 12), (1, 16, 48, 12), (1, 8, 13, 20)])
def test_fusion_maps_as_one_product_match_reference_and_pallas(shape):
    """The folded maps as one (N, 3C) x (3C, 3C) product over khw's layout,
    with the gate, in float32: against the plain version (2e-5: the same
    float32 math, summed in another order) and JAX's ``_fused_fusion_pallas``
    in interpret mode (1e-4, ``test_torch_ops.py``'s bar)."""
    from sisr_tpu.ops.pallas.fusion_ops import _fused_fusion_pallas
    from sisr_tpu_torch.ops.kernels.fusion_ops import (fused_fusion_reference,
                                                       fusion_pools_reference, pack_params)

    a, b, raws = _fusion_args(shape, 13)
    ta, tb, traws = _t(a), _t(b), _nest(raws, _t)
    got = fused_fusion_emulation(ta, tb, fusion_pools_reference(ta, tb),
                                 pack_params(traws, shape[-1], torch.float32))
    _close(got, fused_fusion_reference(ta, tb, traws), 2e-5, 2e-5)
    if shape[1] % 8 == 0:        # JAX's row tiles need H % 8 == 0
        ref = _fused_fusion_pallas(jnp.asarray(a), jnp.asarray(b), _nest(raws, jnp.asarray),
                                   interpret=True)
        _close(got, ref, 1e-4, 1e-4)


@pytest.mark.parametrize("shape", [(2, 16, 8, 12), (1, 16, 48, 12)])
def test_fusion_maps_bf16_rounding_stays_within_the_plain_bf16_error(shape):
    """With the kernel's bfloat16 rounding points (the pools, p27, h_att and
    w_att as the product's inputs, khw and k1blk, out), the emulation stays
    as close to the float32 plain version as twice the plain bfloat16
    version does (the bar the card tests hold the kernel to)."""
    from sisr_tpu_torch.ops.kernels.fusion_ops import (fused_fusion_reference,
                                                       fusion_pools_reference, pack_params)

    a, b, raws = _fusion_args(shape, 14)
    b16 = torch.bfloat16
    ta, tb = _t(a).to(b16), _t(b).to(b16)
    traws = _nest(raws, lambda x: _t(x).to(b16).float())
    truth = fused_fusion_reference(ta.float(), tb.float(), traws)
    e_plain = float((fused_fusion_reference(ta, tb, _nest(raws, lambda x: _t(x).to(b16)))
                     .float() - truth).abs().max())
    got = fused_fusion_emulation(ta, tb, fusion_pools_reference(ta, tb),
                                 pack_params(traws, shape[-1], b16), rnd=_rbf)
    e_kernel = float((got.float() - truth).abs().max())
    scale = max(1.0, float(truth.abs().max()))
    assert e_kernel <= max(2.0 * e_plain, 4 * 2.0 ** -8 * scale), (e_kernel, e_plain)
