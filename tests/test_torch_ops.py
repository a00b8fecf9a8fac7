"""The port's primitives and kernels' plain versions vs their JAX twins.

Inputs come from numpy with a seed and go through both packages; each JAX
Pallas function runs as its own tests run it, in interpret mode on the CPU.
The CUDA kernels themselves run only on a card: ``test_torch_kernels.py``
and ``chip_smoke.py`` hold them against these plain versions.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "sisr_tpu")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(ref, dtype=np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list((REPO / "sisr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_port_imports_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("shape,window", [((1, 12, 20, 3), (8, 8)),
                                          ((2, 5, 7, 4), (4, 16)),
                                          ((1, 16, 16, 2), (8, 8))])
def test_pad_to_multiple_matches_jax(shape, window):
    from sisr_tpu.ops.windows import pad_to_multiple as pad_jax
    from sisr_tpu_torch.ops.windows import pad_to_multiple

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    _close(pad_to_multiple(_t(x), window), pad_jax(jnp.asarray(x), window), 0, 0)


def test_pixel_shuffle_matches_jax_and_torch():
    """The phase-major shuffle is nn.PixelShuffle (and the JAX package's
    pixel_shuffle) once the channels are reordered from torch's
    ``c*r*r + i*r + j`` to ``(j*r + i)*C + c``."""
    from sisr_tpu.ops.pixel_shuffle import pixel_shuffle as ps_jax
    from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle_phase_major

    r, c = 2, 3
    x = np.random.default_rng(1).normal(size=(2, 3, 5, c * r * r)).astype(np.float32)
    order = [ch * r * r + i * r + j for j in range(r) for i in range(r) for ch in range(c)]
    got = pixel_shuffle_phase_major(_t(x[..., order]), r)
    _close(got, ps_jax(jnp.asarray(x), r), 0, 0)
    # channel order of nn.PixelShuffle on the NCHW view
    ref = torch.nn.functional.pixel_shuffle(_t(x).permute(0, 3, 1, 2), r)
    _close(got, ref.permute(0, 2, 3, 1), 0, 0)


def test_conv_patches_and_sca_match_jax():
    from sisr_tpu.ops.pallas import scc_block as jx
    from sisr_tpu_torch.ops.kernels import scc_block as pt

    rng = np.random.default_rng(2)
    c = 20
    x = rng.normal(size=(2, 6, 10, c)).astype(np.float32)
    m = rng.normal(size=(2, 6, 10)).astype(np.float32)
    _close(pt._conv_patches(_t(m)), jx._conv_patches(jnp.asarray(m)), 0, 0)
    args = [rng.normal(size=s).astype(np.float32) * 0.3
            for s in ((9, c), (c,), (9, c), (c,), (2, 1, 1, c), (2, 1, 1, c))]
    _close(pt.sca_reference(_t(x), *map(_t, args)),
           jx.sca_reference(jnp.asarray(x), *map(jnp.asarray, args)),
           1e-5, 1e-5)
    # threaded channel-pool maps replace the in-place pools
    cm = (m, m * 0.5)
    _close(pt.sca_reference(_t(x), *map(_t, args), *map(_t, cm)),
           jx.sca_reference(jnp.asarray(x), *map(jnp.asarray, args),
                            *map(jnp.asarray, cm)), 1e-5, 1e-5)


@pytest.mark.parametrize("win,base,heads,c", [(16, 8, 2, 24), (4, 8, 2, 20),
                                              (12, 4, 3, 18)])
def test_scc_normal_form_builders_match_jax(win, base, heads, c):
    from sisr_tpu.ops.pallas import scc_attention as jx
    from sisr_tpu_torch.ops.kernels import scc_attention as pt

    rng = np.random.default_rng(3)
    d = c // (2 * heads)
    bh = min(win, base)
    rh = win // bh
    k1, k2 = rng.normal(size=(2, d, d)).astype(np.float32)
    b1, b2 = rng.normal(size=(2, d)).astype(np.float32)
    for got, ref in zip(pt.blockdiag_kgen(_t(k1), _t(b1), _t(k2), _t(b2), heads),
                        jx.blockdiag_kgen(*map(jnp.asarray, (k1, b1, k2, b2)),
                                          heads)):
        _close(got, ref, 0, 0)
    pk = rng.normal(size=(rh * rh, 1)).astype(np.float32)
    pbias = rng.normal(size=(1,)).astype(np.float32)
    for got, ref in zip(
            pt.pooling_matrix(_t(pk), _t(pbias), win, win, bh, bh, torch.float32),
            jx.pooling_matrix(jnp.asarray(pk), jnp.asarray(pbias), win, win,
                              bh, bh, jnp.float32)):
        _close(got, ref, 0, 0)
    for got, ref in zip(pt._pool_structure(win, win, bh, bh),
                        jx._pool_structure(win, win, bh, bh)):
        np.testing.assert_array_equal(got, ref)
    _close(pt.head_mask(heads, bh * bh, c // 2, torch.float32),
           jx.head_mask(heads, bh * bh, c // 2, jnp.float32), 0, 0)


@pytest.mark.parametrize("shape", [(1, 9, 11, 6), (1, 8, 12, 16), (2, 16, 20, 24),
                                   (1, 32, 36, 120)])
def test_dwconv_reference_matches_jax(shape):
    """The plain version (``dwconv5x5`` on the CPU) against JAX's reference
    (1e-5) and its Pallas kernel in interpret mode (test_pallas_ops.py:13's
    shapes and tolerance, 1e-4)."""
    from sisr_tpu.ops.pallas.dwconv import _dwconv_pallas, depthwise_conv_reference as jx
    from sisr_tpu_torch.ops.kernels.dwconv import depthwise_conv_reference, dwconv5x5

    rng = np.random.default_rng(4)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in (shape, (5, 5, shape[-1]), (shape[-1],)))
    got = dwconv5x5(_t(x), _t(w), _t(b))
    np.testing.assert_array_equal(got.numpy(),
                                  depthwise_conv_reference(_t(x), _t(w), _t(b)).numpy())
    _close(got, jx(*map(jnp.asarray, (x, w, b))), 1e-5, 1e-5)
    _close(got, _dwconv_pallas(*map(jnp.asarray, (x, w, b)), interpret=True), 1e-4, 1e-4)


@pytest.mark.parametrize("shape", [(1, 8, 12, 16), (2, 16, 20, 24), (1, 7, 5, 6)])
def test_dwconv_gradients_match_jax_custom_vjp(shape):
    """dx (the forward on dy with the flipped filter, as the backward
    kernel computes it), dw and db against JAX's ``dwconv5x5`` custom_vjp
    with ``use_pallas=False``."""
    import jax
    from sisr_tpu.ops.pallas.dwconv import dwconv5x5 as jx
    from sisr_tpu_torch.ops.kernels.dwconv import (DWCONV5X5, depthwise_conv_reference,
                                                   dwconv_vjp)

    rng = np.random.default_rng(5)
    x, w, b, dy = (rng.normal(size=s).astype(np.float32)
                   for s in (shape, (5, 5, shape[-1]), (shape[-1],), shape))
    _, vjp = jax.vjp(lambda *a: jx(*a, False), *map(jnp.asarray, (x, w, b)))
    refs = vjp(jnp.asarray(dy))
    gots = dwconv_vjp(depthwise_conv_reference, (_t(x), _t(w), _t(b)), (True,) * 3, (_t(dy),))
    for got, ref in zip(gots, refs):
        _close(got, ref, 1e-4, 1e-4)
    # the same through the Function, the plain version standing in for the kernel
    ins = [_t(a).requires_grad_() for a in (x, w, b)]
    out = DWCONV5X5.with_kernel(depthwise_conv_reference)(*ins)
    for got, ref in zip(torch.autograd.grad(out, ins, _t(dy)), refs):
        _close(got, ref, 1e-4, 1e-4)


# --- kernel 1: conv3x3 ------------------------------------------------------

@pytest.mark.parametrize("cin,cout,act,with_res", [
    (180, 180, "none", True),      # RHTB residual conv
    (180, 180, "none", False),     # conv_after_body
    (180, 64, "leaky", False),     # conv_before_upsample
    (64, 256, "leaky2", False),    # conv_up1 / conv_up2 (phase-folded)
    (64, 64, "leaky2", False),     # conv_hr
    (64, 3, "none", False),        # conv_last
])
def test_conv3x3_plain_matches_pallas(cin, cout, act, with_res):
    from sisr_tpu.ops.pallas.conv3x3 import _conv3x3_pallas, conv3x3_reference
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3

    rng = np.random.default_rng(5)
    shape = (1, 8, 6, cin)
    y = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    res = (rng.normal(size=shape[:3] + (cout,)).astype(np.float32)
           if with_res else None)
    got = conv3x3(_t(y), None if res is None else _t(res), _t(k), _t(b), act)
    jargs = (jnp.asarray(y), None if res is None else jnp.asarray(res),
             jnp.asarray(k), jnp.asarray(b), act)
    _close(got, _conv3x3_pallas(*jargs, interpret=True), 1e-4, 1e-4)
    _close(got, conv3x3_reference(*jargs), 1e-4, 1e-4)


# --- kernel 2: HTB tail -----------------------------------------------------

def _tail_args(h, w, c, ch, b=1, pad=(0, 0), seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32) * 0.3
    return (mk(b, h + pad[0], w + pad[1], c), mk(b, h, w, c),
            mk(c) + 1.0, mk(c), mk(c, ch), mk(ch), mk(5, 5, ch), mk(ch),
            mk(ch, c), mk(c), mk(c) + 1.0, mk(c))


@pytest.mark.parametrize("h,w,c,ch", [(8, 12, 16, 24), (12, 20, 10, 20),
                                      (16, 8, 24, 48), (4, 8, 12, 24),
                                      (32, 8, 12, 24)])
def test_htb_tail_plain_matches_pallas(h, w, c, ch):
    from sisr_tpu.ops.pallas.ffn import _htb_tail_pipe
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail

    args = _tail_args(h, w, c, ch)
    got = htb_tail(*map(_t, args))
    ref = _htb_tail_pipe(*map(jnp.asarray, args), interpret=True)
    _close(got, ref, 1e-4, 1e-4)


@pytest.mark.parametrize("pad", [(0, 0), (8, 0), (8, 8)])
def test_htb_tail_stats_plain_matches_pallas(pad):
    """Stats variant, including a window-padded attn taller (and wider)
    than the shortcut: only its first H rows / W columns count."""
    from sisr_tpu.ops.pallas.ffn import htb_tail_stats as jx
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail, htb_tail_stats

    args = _tail_args(16, 8, 16, 32, b=2, pad=pad, seed=7)
    out, stats = htb_tail_stats(*map(_t, args))
    ref_out, ref_stats = jx(*map(jnp.asarray, args), False, interpret=True)
    _close(out, ref_out, 1e-4, 1e-4)
    for got, ref in zip(stats, ref_stats):
        _close(got, ref, 1e-4, 1e-4)
    _close(htb_tail(*map(_t, args)), ref_out, 1e-4, 1e-4)


# --- kernel 3: SCC block ----------------------------------------------------

def _scc_args(win, base, heads, c, nw, with_sca, b=1, seed=0):
    """numpy inputs of scc_block, normal-form params built by the JAX
    package (the builders are held equal above)."""
    from sisr_tpu.ops.pallas.scc_attention import (blockdiag_kgen, head_mask,
                                                   pooling_matrix)

    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32) * 0.3
    d = c // (2 * heads)
    bh = min(win, base)
    rh = win // bh
    x = mk(b, nw * win, nw * win, c)
    sca = ((mk(9, c), mk(c), mk(9, c), mk(c), mk(b, 1, 1, c), mk(b, 1, 1, c))
           if with_sca else None)
    w1, w2, bb = blockdiag_kgen(*map(jnp.asarray, (mk(d, d), mk(d), mk(d, d),
                                                   mk(d))), heads)
    pmat, pb = pooling_matrix(jnp.asarray(mk(rh * rh, 1)), jnp.asarray(mk(1)),
                              win, win, bh, bh, jnp.float32)
    mask = head_mask(heads, bh * bh, c // 2, jnp.float32)
    rest = [np.asarray(a) for a in (w1, w2, bb, pmat, pb, mask)]
    return (x, sca, *rest, mk(win * win, heads * bh * bh), mk(c, c), mk(c),
            heads, (win, win))


@pytest.mark.parametrize("mode", ["band", "window"])
@pytest.mark.parametrize("win,base,heads,c,with_sca", [
    (8, 8, 2, 20, True), (8, 8, 2, 20, False), (16, 8, 2, 24, True),
    (32, 8, 1, 16, True),
    (4, 8, 2, 20, True), (4, 8, 2, 20, False),
    (4, 8, 2, 40, True), (8, 8, 2, 136, False)])
def test_scc_block_plain_matches_pallas(win, base, heads, c, with_sca, mode,
                                        monkeypatch):
    """Both TPU bodies: the row-of-windows one ("band") and the per-window
    grid ("window"), as test_pallas_ops.py selects them."""
    from sisr_tpu.ops.pallas.scc_block import _scc_block_pallas
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    monkeypatch.setenv("SISR_SCC_MODE", mode)

    args = _scc_args(win, base, heads, c, 1 if win >= 32 else 2, with_sca)
    jx_args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    if with_sca:
        jx_args[1] = tuple(map(jnp.asarray, args[1]))
    pt_args = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    if with_sca:
        pt_args[1] = tuple(map(_t, args[1]))
    got = scc_block(*pt_args)
    ref = _scc_block_pallas(*jx_args, interpret=True)
    _close(got, ref, 2e-3, 2e-3)


def test_pixel_shuffle_phase_major_matches_jax():
    from sisr_tpu.ops.pixel_shuffle import pixel_shuffle_phase_major as ps_jax
    from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle_phase_major

    x = np.random.default_rng(8).normal(size=(2, 3, 5, 4 * 6)).astype(np.float32)
    _close(pixel_shuffle_phase_major(_t(x), 2), ps_jax(jnp.asarray(x), 2), 0, 0)


# --- kernel 5: conv3x3 over the phase-major shuffle of a packed input ---------

@pytest.mark.parametrize("act", ["leaky2", "none"])
@pytest.mark.parametrize("h2,w2,f", [(8, 16, 8), (16, 32, 12), (4, 300, 8)])
def test_conv3x3_shuffled_plain_matches_pallas(h2, w2, f, act):
    from sisr_tpu.ops.pallas.conv3x3 import _conv3x3_shuffled_pallas
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled

    rng = np.random.default_rng(5)
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    yp, k, b = mk(1, h2, w2, 4 * f), mk(3, 3, f, f), mk(f)
    got = conv3x3_shuffled(_t(yp), _t(k), _t(b), act)
    ref = _conv3x3_shuffled_pallas(*map(jnp.asarray, (yp, k, b)), act, interpret=True)
    _close(got, ref, 1e-5, 1e-5)


# --- kernel 6: conv_hr + conv_last over the shuffle --------------------------

@pytest.mark.parametrize("h2,w2,f,cout", [(8, 16, 8, 3), (16, 32, 12, 3),
                                          (24, 300, 8, 3), (4, 300, 8, 5)])
def test_conv3x3_shuffled_tail_plain_matches_pallas(h2, w2, f, cout):
    from sisr_tpu.ops.pallas.conv3x3 import _conv3x3_shuffled_tail_pallas
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled_tail

    rng = np.random.default_rng(6)
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    yp, k1, b1, k2, b2 = mk(1, h2, w2, 4 * f), mk(3, 3, f, f), mk(f), mk(3, 3, f, cout), mk(cout)
    got = conv3x3_shuffled_tail(_t(yp), _t(k1), _t(b1), "leaky2", _t(k2), _t(b2))
    ref = _conv3x3_shuffled_tail_pallas(jnp.asarray(yp), jnp.asarray(k1), jnp.asarray(b1),
                                        "leaky2", jnp.asarray(k2), jnp.asarray(b2),
                                        interpret=True)
    assert got.shape == ref.shape == (1, 2 * h2, 2 * w2, cout)
    _close(got, ref, 1e-5, 1e-5)


# --- kernel 7: the same tail with its output packed 16 pixels to a row -------

@pytest.mark.parametrize("h2,w2,f,cout", [(8, 16, 64, 3), (24, 64, 64, 3), (8, 40, 64, 5)])
def test_conv3x3_shuffled_tail_packed_plain_matches_pallas(h2, w2, f, cout):
    from sisr_tpu.ops.pallas.conv3x3 import (_conv3x3_shuffled_tail_packed_pallas,
                                             tail_pack_group as jx_group)
    from sisr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_shuffled_tail_packed,
                                                    tail_pack_group)

    assert tail_pack_group() == jx_group() == 16
    rng = np.random.default_rng(7)
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    yp, k1, b1, k2, b2 = mk(1, h2, w2, 4 * f), mk(3, 3, f, f), mk(f), mk(3, 3, f, cout), mk(cout)
    got = conv3x3_shuffled_tail_packed(_t(yp), _t(k1), _t(b1), "leaky2", _t(k2), _t(b2))
    ref = _conv3x3_shuffled_tail_packed_pallas(jnp.asarray(yp), jnp.asarray(k1),
                                               jnp.asarray(b1), "leaky2", jnp.asarray(k2),
                                               jnp.asarray(b2), interpret=True)
    assert got.shape == ref.shape == (1, 2 * h2, 2 * w2 // 16, 16 * cout)
    _close(got, ref, 1e-5, 1e-5)


# --- kernel 10: the whole degenerate-window HTB -------------------------------

def _htb_fused_args(win=4, heads=2, c=20, ch=40, nw=3, nh=4, b=1, with_sca=True, seed=7):
    """test_pallas_ops.py's _htb_fused_args in numpy (the normal-form
    params built by the JAX package)."""
    from sisr_tpu.ops.pallas.scc_attention import blockdiag_kgen, head_mask, pooling_matrix

    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32) * 0.3
    d = c // (2 * heads)
    x = mk(b, nh * win, nw * win, c)
    sca = (mk(9, c), mk(c), mk(9, c), mk(c), mk(b, 1, 1, c), mk(b, 1, 1, c)) if with_sca else None
    w1, w2, bb = blockdiag_kgen(*map(jnp.asarray, (mk(d, d), mk(d), mk(d, d), mk(d))), heads)
    pmat, pb = pooling_matrix(jnp.asarray(mk(1, 1)), jnp.asarray(mk(1)), win, win, win, win,
                              jnp.float32)
    mask = head_mask(heads, win * win, c // 2, jnp.float32)
    scc = (x, sca, *[np.asarray(a) for a in (w1, w2, bb, pmat, pb, mask)],
           mk(win * win, heads * win * win), mk(c, c), mk(c), heads, (win, win))
    ffn = (mk(c) + 1.0, mk(c), mk(c, ch), mk(ch), mk(5, 5, ch), mk(ch), mk(ch, c), mk(c),
           mk(c) + 1.0, mk(c))
    return scc + ffn


def _both(args):
    """(JAX arguments, port arguments) of a numpy argument tuple."""
    conv = lambda f: [f(a) if isinstance(a, np.ndarray) else
                      (tuple(map(f, a)) if isinstance(a, tuple) and a and
                       isinstance(a[0], np.ndarray) else a) for a in args]
    return conv(jnp.asarray), conv(_t)


@pytest.mark.parametrize("win,heads,c,ch,with_sca,nh", [
    (4, 2, 20, 40, True, 4), (4, 2, 48, 96, True, 3), (8, 2, 20, 40, True, 2),
    (4, 2, 20, 40, False, 3)])
def test_htb_fused_plain_matches_pallas(win, heads, c, ch, with_sca, nh):
    """test_pallas_ops.py's cases and tolerance (3e-3)."""
    from sisr_tpu.ops.pallas.htb_block import htb_fused as jx
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused, htb_fused_reference

    jx_args, pt_args = _both(_htb_fused_args(win=win, heads=heads, c=c, ch=ch,
                                             with_sca=with_sca, nh=nh))
    ref = jx(*jx_args, interpret=True)
    got = htb_fused(*pt_args)
    _close(got, ref, 3e-3, 3e-3)
    np.testing.assert_array_equal(got.numpy(), htb_fused_reference(*pt_args).numpy())


def test_htb_fused_stats_plain_matches_pallas():
    from sisr_tpu.ops.pallas.htb_block import htb_fused as jx
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused

    jx_args, pt_args = _both(_htb_fused_args(win=4, heads=2, c=24, ch=48, nh=4, nw=8, b=2))
    ref_out, ref_stats = jx(*jx_args, emit_stats=True, interpret=True)
    out, stats = htb_fused(*pt_args, emit_stats=True)
    _close(out, ref_out, 3e-3, 3e-3)
    for got, ref in zip(stats, ref_stats):
        _close(got, ref, 3e-3, 3e-3)


def test_htb_fused_plain_takes_threaded_stats_as_pallas():
    """sca carrying (cmean, cmax) maps at positions 6-7, shifted off x's own
    pools so that using them shows."""
    from sisr_tpu.ops.pallas.htb_block import htb_fused as jx
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused

    args = list(_htb_fused_args(win=4, heads=2, c=20, ch=40, nh=4))
    x = args[0]
    args[1] = args[1] + (x.mean(-1) + 0.1, x.max(-1) - 0.1)
    jx_args, pt_args = _both(tuple(args))
    base = htb_fused(*_both(_htb_fused_args(win=4, heads=2, c=20, ch=40, nh=4))[1])
    got = htb_fused(*pt_args)
    _close(got, jx(*jx_args, interpret=True), 3e-3, 3e-3)
    assert float((got - base).abs().max()) > 1e-3


# --- kernels 8-9: the Fusion gate ---------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 12, 20), (1, 16, 640, 12), (1, 16, 576, 12)])
def test_fusion_pools_plain_matches_pallas(shape):
    from sisr_tpu.ops.pallas.fusion_ops import _fusion_pools_pallas
    from sisr_tpu_torch.ops.kernels.fusion_ops import fusion_pools

    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    gots = fusion_pools(_t(a), _t(b))
    refs = _fusion_pools_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    for got, ref in zip(gots, refs):
        assert tuple(got.shape) == ref.shape
        _close(got, ref, 1e-5, 1e-5)


def _ua_raws(rng, c):
    mk = lambda *s: rng.normal(size=s).astype(np.float32) * 0.3
    return tuple(((mk(3, 3, 2, 1), mk(1)), (mk(3, 3, 2, 1), mk(1)),
                  (mk(3, 3, 2, 1), mk(1)), (mk(3, 3, c, c), mk(c))) for _ in range(3))


def _nest(raws, fn):
    return tuple(tuple((fn(k), fn(b)) for k, b in ua) for ua in raws)


@pytest.mark.parametrize("shape", [(2, 16, 8, 12), (1, 16, 48, 12)])
def test_fused_fusion_plain_matches_pallas(shape):
    from sisr_tpu.ops.pallas.fusion_ops import _fused_fusion_pallas
    from sisr_tpu_torch.ops.kernels.fusion_ops import fused_fusion, pack_params

    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    raws = _nest(_ua_raws(rng, shape[-1]), _t)
    got = fused_fusion(_t(a), _t(b), raws, pack_params(raws, shape[-1], torch.float32))
    ref = _fused_fusion_pallas(jnp.asarray(a), jnp.asarray(b),
                               _nest(raws, lambda t: jnp.asarray(t.numpy())), interpret=True)
    _close(got, ref, 1e-4, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusion_pack_params_match_jax(dtype):
    """The gate kernel's packed weights, rounded as JAX rounds them."""
    from sisr_tpu.ops.pallas.fusion_ops import _pack_params
    from sisr_tpu_torch.ops.kernels.fusion_ops import pack_params

    c = 12
    raws = _ua_raws(np.random.default_rng(9), c)
    got = pack_params(_nest(raws, _t), c, getattr(torch, dtype))
    ref = _pack_params(_nest(raws, jnp.asarray), c, getattr(jnp, dtype))
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape and str(g.dtype).endswith(str(r.dtype))
        _close(g.float(), np.asarray(r, dtype=np.float32), 1e-6, 1e-6)


# --- the autograd Functions around the kernels --------------------------------

def _function_cases():
    """name -> (the module's KernelFunction, its public plain function, the
    numpy arguments): every Function, the plain version standing in for
    its kernel."""
    from sisr_tpu_torch.ops.kernels import conv3x3 as cv, dwconv, ffn, fusion_ops as fo
    from sisr_tpu_torch.ops.kernels import scc_block as sb

    rng = np.random.default_rng(11)
    mk = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    f = 6
    conv = (mk(2, 6, 7, 5), None, mk(3, 3, 5, 4), mk(4), "leaky")
    cases = {
        "conv3x3": (cv.CONV3X3, cv.conv3x3_reference, conv),
        "conv3x3 +res": (cv.CONV3X3, cv.conv3x3_reference, conv[:1] + (mk(2, 6, 7, 4),)
                         + conv[2:]),
        "conv3x3_shuffled": (cv.CONV3X3_SHUFFLED, cv.conv3x3_shuffled_reference,
                             (mk(2, 3, 4, 4 * f), mk(3, 3, f, 5), mk(5), "leaky2")),
        "conv3x3_shuffled_tail": (cv.SHUFFLED_TAIL, cv.conv3x3_shuffled_tail_reference,
                                  (mk(1, 3, 8, 4 * f), mk(3, 3, f, f), mk(f), "leaky2",
                                   mk(3, 3, f, 3), mk(3))),
        "conv3x3_shuffled_tail_packed": (
            cv.SHUFFLED_TAIL_PACKED, cv.conv3x3_shuffled_tail_packed_reference,
            (mk(1, 3, 8, 4 * f), mk(3, 3, f, f), mk(f), "leaky2", mk(3, 3, f, 3), mk(3))),
        # attn window-padded 4 rows below the shortcut
        "htb_tail": (ffn.HTB_TAIL, ffn._tail_plain, _tail_args(8, 6, 8, 16, b=2, pad=(4, 0),
                                                               seed=12)),
        "dwconv5x5": (dwconv.DWCONV5X5, dwconv.depthwise_conv_reference,
                      (mk(2, 6, 7, 8), mk(5, 5, 8), mk(8))),
        "fusion_pools": (fo.FUSION_POOLS, fo.fusion_pools_reference, (mk(2, 5, 6, 8),
                                                                       mk(2, 5, 6, 8))),
    }
    for with_sca in (True, False):
        cases[f"scc_block {'+' if with_sca else '-'}sca"] = (
            sb.SCC_BLOCK, sb.scc_block_reference,
            _scc_args(8, 8, 2, 20, 2, with_sca, b=2, seed=13))
    raws = _ua_raws(rng, 8)
    cases["fused_fusion"] = (fo.FUSED_FUSION, lambda a, b, r, p: fo.fused_fusion_reference(a, b, r),
                             (mk(2, 5, 6, 8), mk(2, 5, 6, 8), raws, None))
    return cases


FUNCTIONS = ["conv3x3", "conv3x3 +res", "conv3x3_shuffled", "conv3x3_shuffled_tail",
             "conv3x3_shuffled_tail_packed", "htb_tail", "scc_block +sca", "scc_block -sca",
             "fusion_pools", "fused_fusion", "dwconv5x5"]


def _torch_args(args, requires_grad):
    """numpy arguments (nested in tuples) as float32 tensors."""
    def conv(a):
        if isinstance(a, np.ndarray):
            return _t(a).requires_grad_(requires_grad and a.dtype == np.float32)
        if isinstance(a, tuple) and a and not isinstance(a[0], (int, str)):
            return tuple(conv(v) for v in a)
        return a
    return [conv(a) for a in args]


def _leaves(args):
    if isinstance(args, torch.Tensor):
        return [args] if args.requires_grad else []
    if isinstance(args, (tuple, list)):
        return [t for a in args for t in _leaves(a)]
    return []


@pytest.mark.parametrize("name", FUNCTIONS)
def test_kernel_function_gradients_match_plain_autograd(name):
    """Each KernelFunction, with the plain version standing in for its
    kernel, gives the gradients plain autograd gives, within 1e-6: its
    inputs saved, the plain version recomputed and differentiated in the
    backward (dwconv5x5: its own dx/dw/db), nested tuples flattened and
    rebuilt, None and non-tensor arguments passed over."""
    fn, plain, args = _function_cases()[name]
    fn = fn.with_kernel(plain)
    got_args, ref_args = _torch_args(args, True), _torch_args(args, True)
    got, ref = fn(*got_args), plain(*ref_args)
    outs = lambda o: [o] if isinstance(o, torch.Tensor) else list(o)
    assert all(g.grad_fn is not None for g in outs(got))
    seeds = [torch.from_numpy(np.random.default_rng(14 + i).standard_normal(tuple(o.shape))
                              .astype(np.float32)) for i, o in enumerate(outs(ref))]
    for g, r in zip(outs(got), outs(ref)):
        np.testing.assert_array_equal(g.detach().numpy(), r.detach().numpy())
    wrt_got, wrt_ref = _leaves(got_args), _leaves(ref_args)
    assert len(wrt_got) == len(wrt_ref) > 0
    g_got = torch.autograd.grad(outs(got), wrt_got, seeds, allow_unused=True)
    g_ref = torch.autograd.grad(outs(ref), wrt_ref, seeds, allow_unused=True)
    for a, b in zip(g_got, g_ref):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, 1e-6, 1e-6)
    # no input needing a gradient: the kernel runs bare, no graph
    with torch.no_grad():
        assert all(o.grad_fn is None for o in outs(fn(*_torch_args(args, False))))
