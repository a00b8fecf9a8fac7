"""The port's library ops off the model path against the JAX package on the
CPU: ``models/arch_util.py`` (with ``pixel_unshuffle``),
``ops/stylegan_ops.py`` and ``ops/deform.py``, at the shapes and cases of
``test_aux_ops.py`` and ``test_deform.py``; parameters cross through
``models/jax_port.py``.  Bars: 1e-5 absolute (float32 on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_aux_ops import _upfirdn2d_oracle
from test_deform import _attn_oracle, _oracle

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load(module, variables):
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    sd = state_dict_from_jax(variables)
    module.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return module


def _x(seed, shape=(1, 8, 8, 16)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("res_scale", [1.0, 0.5])
def test_residual_block_matches_jax(res_scale):
    from sisr_tpu.models.arch_util import ResidualBlockNoBN as JaxBlock
    from sisr_tpu_torch.models.arch_util import ResidualBlockNoBN

    x = _x(2)
    jm = JaxBlock(num_feat=16, res_scale=res_scale)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    got = _load(ResidualBlockNoBN(16, res_scale), v)(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=1e-5, rtol=0)


def test_residual_block_zero_scale_is_identity():
    from sisr_tpu_torch.models.arch_util import ResidualBlockNoBN

    x = _t(_x(3))
    torch.testing.assert_close(ResidualBlockNoBN(16, res_scale=0.0)(x), x, atol=0, rtol=0)


def test_make_layer_matches_jax():
    from sisr_tpu.models.arch_util import ResidualBlockNoBN as JaxBlock, make_layer as jax_make
    from sisr_tpu_torch.models.arch_util import ResidualBlockNoBN, make_layer

    x = _x(4)
    jm = jax_make(JaxBlock, 2, num_feat=16)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    stack = _load(make_layer(ResidualBlockNoBN, 2, num_feat=16), v)
    assert [name for name, _ in stack.named_children()] == ["block_0", "block_1"]
    np.testing.assert_allclose(stack(_t(x)).detach().numpy(),
                               np.asarray(jm.apply(v, jnp.asarray(x))), atol=1e-5, rtol=0)


def test_residual_block_init_matches_jax():
    """kaiming-normal x 0.1 kernels (std within 10% of a fresh JAX init's),
    zero biases."""
    from sisr_tpu.models.arch_util import ResidualBlockNoBN as JaxBlock
    from sisr_tpu_torch.models.arch_util import ResidualBlockNoBN

    v = JaxBlock(num_feat=64).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 64)))["params"]
    torch.manual_seed(0)
    block = ResidualBlockNoBN(64)
    for name in ("conv1", "conv2"):
        want = float(np.std(np.asarray(v[name]["kernel"])))
        got = float(getattr(block, name).weight.detach().std())
        assert abs(got / want - 1) < 0.1, (name, got, want)
        assert not getattr(block, name).bias.any()


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_upsample_matches_jax(scale):
    from sisr_tpu.models.arch_util import Upsample as JaxUpsample
    from sisr_tpu_torch.models.arch_util import Upsample

    x = _x(5)
    jm = JaxUpsample(scale=scale, num_feat=16)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    got = _load(Upsample(scale, 16), v)(_t(x)).detach().numpy()
    assert got.shape == (1, 8 * scale, 8 * scale, 16)
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=1e-5, rtol=0)


def test_upsample_refuses_other_scales():
    from sisr_tpu_torch.models.arch_util import Upsample

    with pytest.raises(ValueError):
        Upsample(5, 16)


def test_pixel_unshuffle_matches_jax_and_inverts_the_shuffle():
    from sisr_tpu.ops.pixel_shuffle import pixel_unshuffle as jax_unshuffle
    from sisr_tpu_torch.models.arch_util import pixel_shuffle, pixel_unshuffle

    x = _x(6, (2, 8, 12, 5))
    got = pixel_unshuffle(_t(x), 2)
    assert got.shape == (2, 4, 6, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_unshuffle(jnp.asarray(x), 2)))
    torch.testing.assert_close(pixel_shuffle(got, 2), _t(x), atol=0, rtol=0)
    y = _t(_x(7, (1, 3, 4, 18)))
    torch.testing.assert_close(pixel_unshuffle(pixel_shuffle(y, 3), 3), y, atol=0, rtol=0)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)),
                                         (1, 2, (2, 2)), (2, 2, (3, 2))])
def test_upfirdn2d_matches_jax(up, down, pad):
    from sisr_tpu.ops.stylegan_ops import upfirdn2d as jax_upfirdn2d
    from sisr_tpu_torch.ops.stylegan_ops import upfirdn2d

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    kernel = rng.normal(size=(4, 4)).astype(np.float32)     # asymmetric: catches flips
    got = upfirdn2d(_t(x), _t(kernel), up=up, down=down, pad=pad).numpy()
    want = np.asarray(jax_upfirdn2d(jnp.asarray(x), jnp.asarray(kernel), up=up, down=down,
                                    pad=pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _upfirdn2d_oracle(x, kernel, up, down, *pad),
                               atol=1e-5, rtol=1e-5)


def test_fused_bias_leaky_relu_matches_jax():
    from sisr_tpu.ops.stylegan_ops import fused_bias_leaky_relu as jax_fused
    from sisr_tpu_torch.ops.stylegan_ops import fused_bias_leaky_relu

    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 4, 4, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    np.testing.assert_allclose(fused_bias_leaky_relu(_t(x), _t(b)).numpy(),
                               np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(b))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("stride,padding,dilation,dg,mod", [
    (1, 1, 1, 1, True),      # v2
    (2, 1, 1, 1, False),     # v1
    (1, 2, 2, 2, True),
])
def test_deform_conv2d_matches_jax(stride, padding, dilation, dg, mod):
    from sisr_tpu.ops.deform import deform_conv2d as jax_deform
    from sisr_tpu_torch.ops.deform import deform_conv2d

    rng = np.random.default_rng(3)
    b, h, w, cin, cout, kh = 2, 7, 6, 4, 5, 3
    x = rng.standard_normal((b, h, w, cin), np.float32)
    weight = rng.standard_normal((kh, kh, cin, cout), np.float32) * 0.3
    bias = rng.standard_normal((cout,), np.float32)
    hout = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wout = (w + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    offset = rng.standard_normal((b, hout, wout, 2 * dg * kh * kh), np.float32) * 1.5
    mask = rng.random((b, hout, wout, dg * kh * kh), np.float32) if mod else None
    kw = dict(stride=stride, padding=padding, dilation=dilation, deformable_groups=dg)
    got = deform_conv2d(_t(x), _t(offset), _t(weight), _t(bias),
                        None if mask is None else _t(mask), **kw).numpy()
    want = np.asarray(jax_deform(jnp.asarray(x), jnp.asarray(offset), jnp.asarray(weight),
                                 jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
                                 **kw))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _oracle(x, offset, weight, bias, mask, stride, padding,
                                            dilation, dg), atol=2e-4, rtol=2e-4)


def test_deform_conv2d_zero_offset_is_plain_conv():
    import torch.nn.functional as F
    from sisr_tpu_torch.ops.deform import deform_conv2d

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 9, 6), np.float32)
    weight = rng.standard_normal((3, 3, 6, 4), np.float32) * 0.2
    got = deform_conv2d(_t(x), torch.zeros(1, 8, 9, 18), _t(weight), mask=torch.ones(1, 8, 9, 9))
    want = F.conv2d(_t(x).permute(0, 3, 1, 2), _t(weight).permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("clip,heads,dg", [(2, 2, 2), (1, 1, 1)])
def test_deform_attn_matches_jax(clip, heads, dg):
    from sisr_tpu.ops.deform import deform_attn as jax_attn
    from sisr_tpu_torch.ops.deform import deform_attn

    rng = np.random.default_rng(11)
    b, h, w, c = 1, 5, 6, 8
    q = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kv = rng.standard_normal((b, clip, h, w, 2 * c)).astype(np.float32)
    off = (rng.standard_normal((b, clip, h, w, dg * 9 * 2)) * 1.5).astype(np.float32)
    kw = dict(window=(3, 3), attention_heads=heads, deformable_groups=dg)
    got = deform_attn(_t(q), _t(kv), _t(off), **kw).numpy()
    want = np.asarray(jax_attn(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(off), **kw))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _attn_oracle(q, kv, off, 3, 3, 1, 1, heads, dg),
                               atol=1e-4, rtol=1e-4)
