"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch (``tests/conftest.py`` imports JAX; leave it out):

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q

The plain versions are held equal to the JAX package in
``test_torch_ops.py``; ``chip_smoke.py`` repeats these checks at the
flagship's shapes.
"""

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
    from sisr_tpu_torch.utils.precision import exact_mode

    with exact_mode():
        got, ref = fn(*args), fn(*args, reference=True)
        truth = fn(*_upcast(list(args)), reference=True)
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

    calls = []
    monkeypatch.setattr(mod, "conv3x3_reference",
                        lambda *a, **k: calls.append(1) or torch.zeros(1))
    y = torch.zeros(1, 4, 4, 4, device=cuda_device)
    k = torch.zeros(3, 3, 4, 4, device=cuda_device)
    b = torch.zeros(4, device=cuda_device)
    before = build.launches["conv3x3"]
    mod.conv3x3(y, None, k, b)
    assert build.launches["conv3x3"] == before + 1 and not calls
    mod.conv3x3(y, None, k, b, reference=True)
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
    fn = lambda yp, k1, b1, k2, b2, reference=False: conv3x3_shuffled_tail(
        yp, k1, b1, "leaky2", k2, b2, reference=reference)
    out = _check(fn, (yp, k1, b1, k2, b2), 1e-4)
    assert tuple(out.shape) == (2, 2 * h2, 2 * w2, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 12, 20), (1, 9, 70, 180), (1, 5, 3, 300)])
def test_fusion_pools_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    from sisr_tpu_torch.ops.kernels.fusion_ops import fusion_pools

    rng = np.random.default_rng(6)
    a, b = _on(cuda_device, dtype, _rand(rng, *shape, scale=1.0), _rand(rng, *shape, scale=1.0))
    cp3, hp3, wp3 = _check(fusion_pools, (a, b), 1e-5)
    assert cp3.dtype == wp3.dtype == dtype and hp3.dtype == torch.float32
    # the max slots hold stored values: exact
    ref = fusion_pools(a, b, reference=True)
    for got, want in zip((cp3, hp3, wp3), ref):
        torch.testing.assert_close(got[:, 1::2], want[:, 1::2], atol=0, rtol=0)


def _ua_raws(rng, c, device):
    mk = lambda *s, scale=0.3: torch.from_numpy(_rand(rng, *s, scale=scale)).to(device)
    return tuple(((mk(3, 3, 2, 1), mk(1)), (mk(3, 3, 2, 1), mk(1)), (mk(3, 3, 2, 1), mk(1)),
                  (mk(3, 3, c, c, scale=(9 * c) ** -0.5), mk(c))) for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 8, 12), (1, 16, 48, 12), (1, 24, 20, 180),
                                   (1, 1, 5, 8)])
def test_fused_fusion_kernels_match_plain_on_card(cuda_device, dtype, shape):
    """Pools, maps and gate against the Fusion module's math, including a
    one-row image (both row corrections on one row)."""
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.ops.kernels.fusion_ops import fused_fusion, pack_params

    rng = np.random.default_rng(7)
    a, b = _on(cuda_device, dtype, _rand(rng, *shape, scale=1.0), _rand(rng, *shape, scale=1.0))
    raws = _ua_raws(rng, shape[-1], cuda_device)
    packed = pack_params(raws, shape[-1], dtype)
    before = dict(build.launches)
    _check(lambda a, b, reference=False: fused_fusion(a, b, raws, packed, reference), (a, b),
           1e-4)
    assert build.launches["fused_fusion"] == before["fused_fusion"] + 1
    assert build.launches["fusion_pools"] == before["fusion_pools"] + 1
