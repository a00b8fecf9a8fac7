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


def test_dwconv_reference_matches_jax():
    from sisr_tpu.ops.pallas.dwconv import depthwise_conv_reference as jx
    from sisr_tpu_torch.ops.kernels.dwconv import depthwise_conv_reference

    rng = np.random.default_rng(4)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((1, 9, 11, 6), (5, 5, 6), (6,)))
    _close(depthwise_conv_reference(_t(x), _t(w), _t(b)),
           jx(*map(jnp.asarray, (x, w, b))), 1e-5, 1e-5)


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
