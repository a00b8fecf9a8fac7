"""The port's other shallow conv and heads, and its initialisation.

- Under ``torch.manual_seed(1234)`` the port's ``HiTSIR`` is the
  reference's initial state dict (``hit_sir_*.npz``'s ``sd__*``, recorded
  by tools/make_goldens.py with its trunc-normal drawn as normal then
  clamp): every tensor bit for bit.
- The reference's goldens of the plain-conv, pixel-shuffle heads
  (``hit_sir_tiny_plain``: pixelshuffledirect x4, no MSCE, no CASA, no
  Fusion; ``hit_sir_tiny_ps_x2``: pixelshuffle x2) at
  test_torch_golden.py's bars: max abs < 1e-3, rms < 5e-5.
- Every head against the JAX model on the CPU from JAX's own initial
  parameters (``state_dict_from_jax``), at the same bars; ``pixel_shuffle``
  equal to JAX's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from test_model_parity import CASES

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"

BASE = dict(is_channel_spatial_attn=True, embed_dim=20, depths=(2,), num_heads=(2,),
            base_win_size=(4, 4), mlp_ratio=2.0, hier_win_ratios=(1, 2))
HEADS = {
    "pixelshuffle_x4": dict(BASE, is_mult_size_conv_feat_extract=False, is_fusion=True,
                            upsampler="pixelshuffle", upscale=4),
    "pixelshuffle_x2": dict(BASE, is_mult_size_conv_feat_extract=True, is_fusion=False,
                            upsampler="pixelshuffle", upscale=2),
    "pixelshuffledirect_x4": dict(BASE, is_mult_size_conv_feat_extract=False,
                                  is_fusion=False, upsampler="pixelshuffledirect", upscale=4),
    "denoise": dict(BASE, is_mult_size_conv_feat_extract=False, is_fusion=True,
                    upsampler="", upscale=1),
    "nearest_conv_no_msce": dict(BASE, is_mult_size_conv_feat_extract=False, is_fusion=True,
                                 upsampler="nearest+conv", upscale=4),
}


def _errs(got, ref):
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    return float(err.max()), float(np.sqrt(np.mean(err ** 2)))


def _golden(name):
    blob = np.load(GOLDEN / f"hit_sir_{name}.npz")
    return blob, {k[len("sd__"):]: blob[k] for k in blob.files if k.startswith("sd__")}


@pytest.mark.parametrize("name", ["tiny_full", "tiny_plain", "tiny_ps_x2"])
def test_init_matches_reference_state_dict(name):
    """Every tensor of the seeded initial state dict equals the
    reference's, in its order; the Linear biases are 0."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    _, ref = _golden(name)
    torch.manual_seed(1234)
    model = HiTSIR(**CASES[name])
    got = model.state_dict()
    assert list(got) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    linears = [m for m in model.modules() if isinstance(m, nn.Linear)]
    assert linears and all(not m.bias.any() for m in linears)


@pytest.mark.parametrize("name", ["tiny_plain", "tiny_ps_x2"])
def test_heads_match_reference_golden(name):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    blob, sd = _golden(name)
    model = HiTSIR(**CASES[name]).eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    with torch.inference_mode():
        y = model(torch.from_numpy(blob["input"].transpose(0, 2, 3, 1).copy()))
    max_err, rms = _errs(y.numpy().transpose(0, 3, 1, 2), blob["output"])
    assert max_err < 1e-3, f"max abs err {max_err:.3e}"
    assert rms < 5e-5, f"rms err {rms:.3e}"


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax(name):
    """The whole forward against JAX's from JAX's initial parameters."""
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    cfg = HEADS[name]
    x = np.random.default_rng(21).random((2, 12, 16, 3), dtype=np.float32)
    jmodel = JaxHiTSIR(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(x))
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = HiTSIR(**cfg).eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_dict_from_jax(variables).items()}, strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    s = cfg["upscale"]
    assert got.shape == (2, 12 * s, 16 * s, 3)
    max_err, rms = _errs(got, ref)
    assert max_err < 1e-3, f"max abs err {max_err:.3e}"
    assert rms < 5e-5, f"rms err {rms:.3e}"


def test_head_parameter_names_and_stage():
    """The heads' parameters carry the reference's names (``upsample.{0,2}``,
    ``conv_before_upsample.0``, ``conv_last``), and only the nearest+conv
    head takes ``stage``."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    names = {n: [k for k in HiTSIR(**cfg).state_dict() if not k.startswith(("layers.",
                                                                             "fusion."))]
             for n, cfg in HEADS.items()}
    assert [k for k in names["pixelshuffle_x4"] if k.startswith("upsample")] == [
        "upsample.0.weight", "upsample.0.bias", "upsample.2.weight", "upsample.2.bias"]
    assert "conv_before_upsample.0.weight" in names["pixelshuffle_x2"]
    assert "conv_last.weight" not in names["pixelshuffledirect_x4"]
    assert names["denoise"][-2:] == ["conv_last.weight", "conv_last.bias"]
    assert names["nearest_conv_no_msce"][:2] == ["conv_first.weight", "conv_first.bias"]
    model = HiTSIR(**HEADS["pixelshuffle_x2"])
    with pytest.raises(ValueError, match="nearest\\+conv"):
        model(torch.zeros(1, 8, 8, 3), stage="features")


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_pixel_shuffle_matches_jax(factor):
    from sisr_tpu.ops.pixel_shuffle import pixel_shuffle as jax_pixel_shuffle
    from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle

    x = np.random.default_rng(factor).random((2, 3, 5, 2 * factor * factor), dtype=np.float32)
    got = pixel_shuffle(torch.from_numpy(x), factor).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pixel_shuffle(jnp.asarray(x), factor)))
    # and torch's own NCHW shuffle
    ref = nn.functional.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), factor)
    np.testing.assert_array_equal(got, ref.permute(0, 2, 3, 1).numpy())
