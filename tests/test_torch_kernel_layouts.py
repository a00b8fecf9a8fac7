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
    """``wgmma.cuh`` is what ``gen_wgmma.py`` writes (one wrapper per width
    of ``conv3x3.WGMMA_WIDTHS``)."""
    import importlib.util

    from sisr_tpu_torch.ops.kernels.conv3x3 import WGMMA_WIDTHS

    spec = importlib.util.spec_from_file_location("gen_wgmma", CSRC / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert tuple(gen.WIDTHS) == WGMMA_WIDTHS
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
