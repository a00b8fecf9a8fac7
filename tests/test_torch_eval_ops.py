"""The port's eval ops (color, metrics, resize) and bookkeeping utilities
against the JAX package and the reference's goldens, on the CPU.

Tolerances: color 1e-6; host metrics 1e-10 relative to JAX's numpy
functions, and ``tests/test_aux_ops.py``'s bars against the MATLAB-parity
golden; the tensor metrics 1e-5 against ``psnr_jax``/``ssim_jax``; resize
1e-5 against JAX and ``tests/golden/imresize.npz``; nearest and bilinear
1e-6.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# --------------------------------------------------------------------------
# color
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tensor", "numpy"])
@pytest.mark.parametrize("name", ["rgb_to_y", "normalize_rgb", "denormalize_rgb"])
def test_color_matches_jax(name, kind):
    import sisr_tpu.ops.color as jc
    import sisr_tpu_torch.ops.color as pc

    x = _rand((2, 5, 7, 3), 0)
    got = getattr(pc, name)(torch.from_numpy(x) if kind == "tensor" else x)
    assert isinstance(got, torch.Tensor if kind == "tensor" else np.ndarray)
    ref = np.asarray(getattr(jc, name)(jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-6, rtol=0)


def test_rgb_to_y_channel_axis():
    from sisr_tpu.ops.color import rgb_to_y as y_jax
    from sisr_tpu_torch.ops.color import rgb_to_y

    x = _rand((2, 3, 6, 5), 1)  # NCHW
    np.testing.assert_allclose(rgb_to_y(torch.from_numpy(x), channel_axis=1).numpy(),
                               np.asarray(y_jax(jnp.asarray(x), channel_axis=1)),
                               atol=1e-6, rtol=0)


def test_model_mean_is_the_color_constant():
    from sisr_tpu.ops.color import IMAGENET_ISH_RGB_MEAN as jax_mean
    from sisr_tpu_torch.ops.color import IMAGENET_ISH_RGB_MEAN

    assert IMAGENET_ISH_RGB_MEAN == jax_mean


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def _pair(seed, shape=(37, 45), noise=0.05):
    a = _rand(shape, seed)
    b = np.clip(a + noise * np.random.default_rng(seed + 100).standard_normal(shape), 0, 1)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("seed,noise", [(0, 0.05), (1, 0.2), (2, 0.01)])
def test_psnr_matches_jax(seed, noise):
    from sisr_tpu.ops.metrics import psnr as psnr_jax_np
    from sisr_tpu_torch.ops.metrics import psnr

    a, b = _pair(seed, noise=noise)
    np.testing.assert_allclose(psnr(a, b), psnr_jax_np(a, b), rtol=1e-10)
    assert psnr(a, a) == float("inf")


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("seed,noise", [(0, 0.05), (1, 0.2)])
def test_ssim_matches_jax(seed, noise, gaussian):
    from sisr_tpu.ops.metrics import ssim as ssim_jax_np
    from sisr_tpu_torch.ops.metrics import ssim

    a, b = _pair(seed, noise=noise)
    np.testing.assert_allclose(ssim(a, b, gaussian_weights=gaussian),
                               ssim_jax_np(a, b, gaussian_weights=gaussian), rtol=1e-10)
    # a leading singleton channel is accepted, as in JAX
    np.testing.assert_allclose(ssim(a[None], b[None], gaussian_weights=gaussian),
                               ssim(a, b, gaussian_weights=gaussian), rtol=0)


def test_ssim_rejects_color_images():
    from sisr_tpu_torch.ops.metrics import ssim

    with pytest.raises(ValueError):
        ssim(_rand((8, 8, 3), 0), _rand((8, 8, 3), 1))


@pytest.mark.parametrize("name", ["noisy", "shifted", "blurred"])
def test_metrics_match_matlab_golden(name):
    """Gaussian SSIM and PSNR against KAIR's MATLAB-parity calculate_ssim
    (tests/golden/metrics_matlab.npz), at tests/test_aux_ops.py's bars."""
    from sisr_tpu_torch.ops.metrics import psnr, ssim

    z = np.load(GOLDEN / "metrics_matlab.npz")
    a = z["a"].astype(np.float64)
    b = z[f"b_{name}"].astype(np.float64)
    np.testing.assert_allclose(ssim(a, b, 1.0, gaussian_weights=True),
                               float(z[f"ssim_{name}"]), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(psnr(a, b, 1.0), float(z[f"psnr_{name}"]),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("shape", [(37, 45), (64, 30)])
def test_tensor_metrics_match_jax(shape, gaussian):
    from sisr_tpu.ops.metrics import psnr_jax, ssim_jax
    from sisr_tpu_torch.ops.metrics import psnr_torch, ssim_torch

    a, b = _pair(3, shape)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(psnr_torch(ta, tb)),
                               float(psnr_jax(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(ssim_torch(ta, tb, gaussian_weights=gaussian)),
        float(ssim_jax(jnp.asarray(a), jnp.asarray(b), gaussian_weights=gaussian)),
        atol=1e-5, rtol=1e-5)


def test_tensor_ssim_equals_host_ssim():
    """'valid' filtering equals the reflect filter + border crop."""
    from sisr_tpu_torch.ops.metrics import ssim, ssim_torch

    a, b = _pair(4)
    for gaussian in (False, True):
        np.testing.assert_allclose(
            float(ssim_torch(torch.from_numpy(a), torch.from_numpy(b),
                             gaussian_weights=gaussian)),
            ssim(a, b, gaussian_weights=gaussian), atol=1e-5)


# --------------------------------------------------------------------------
# resize
# --------------------------------------------------------------------------

RESIZE_KEYS = ["scale_0.25", "scale_0.5", "scale_0.3", "scale_2.0", "scale_1.7",
               "scale_4.0", "scale_0.25_noaa"]


@pytest.mark.parametrize("key", RESIZE_KEYS)
def test_imresize_matches_golden_and_jax(key):
    from sisr_tpu.ops.resize import imresize_matlab as resize_jax
    from sisr_tpu.ops.resize import imresize_matlab_np as resize_jax_np
    from sisr_tpu_torch.ops.resize import imresize_matlab, imresize_matlab_np

    blob = np.load(GOLDEN / "imresize.npz")
    img = blob["input"].transpose(1, 2, 0)  # CHW -> HWC
    scale = float(key.split("_")[1])
    antialias = not key.endswith("noaa")
    ref = blob[key].transpose(1, 2, 0)

    out_np = imresize_matlab_np(img, scale, antialias)
    assert out_np.shape == ref.shape and out_np.dtype == np.float32
    np.testing.assert_allclose(out_np, ref, atol=1e-5)
    np.testing.assert_allclose(out_np, resize_jax_np(img, scale, antialias), atol=1e-5)

    out_t = imresize_matlab(torch.from_numpy(img), scale, antialias).numpy()
    np.testing.assert_allclose(out_t, ref, atol=1e-5)
    np.testing.assert_allclose(
        out_t, np.asarray(resize_jax(jnp.asarray(img), scale, antialias)), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 13, 17, 3), (13, 17)])
def test_imresize_batched_and_2d_match_jax(shape):
    from sisr_tpu.ops.resize import imresize_matlab as resize_jax
    from sisr_tpu_torch.ops.resize import imresize_matlab, imresize_matlab_np

    x = _rand(shape, 5)
    got = imresize_matlab(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_allclose(got, np.asarray(resize_jax(jnp.asarray(x), 0.5)), atol=1e-5)
    if len(shape) == 2:
        np.testing.assert_allclose(imresize_matlab_np(x, 0.5), got, atol=1e-5)


def test_nearest_upsample_matches_jax_and_torch():
    from sisr_tpu.ops.resize import nearest_upsample as up_jax
    from sisr_tpu_torch.ops.resize import nearest_upsample

    x = _rand((2, 5, 7, 3), 6)
    got = nearest_upsample(torch.from_numpy(x), 2).numpy()
    np.testing.assert_allclose(got, np.asarray(up_jax(jnp.asarray(x), 2)), atol=1e-6)
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(), atol=1e-6)


@pytest.mark.parametrize("out_hw", [(12, 10), (9, 13)])
def test_bilinear_resize_matches_jax_and_torch(out_hw):
    from sisr_tpu.ops.resize import bilinear_resize as bil_jax
    from sisr_tpu_torch.ops.resize import bilinear_resize

    x = _rand((2, 6, 5, 4), 7)
    got = bilinear_resize(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, np.asarray(bil_jax(jnp.asarray(x), *out_hw)),
                               atol=1e-6)
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=out_hw, mode="bilinear",
        align_corners=False)
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(), atol=1e-6)


# --------------------------------------------------------------------------
# meters and profiling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num,digit", [(0.1234, 18), (2e-05, 25), (1.0050000000000002e-05, 25),
                                       ("训练时长:4.2445", 25), (15.436072563662652, 18),
                                       (1.0, 18)])
def test_format_str_matches_jax(num, digit):
    from sisr_tpu.utils.meters import format_str as fmt_jax
    from sisr_tpu_torch.utils.meters import format_str

    assert format_str(num, digit) == fmt_jax(num, digit)
    # a decimal (not exponent) form parses back to the same float: resume
    # reads the metric columns back; the lr column's exponents are padded
    # into other numbers, as the reference pads them, and are never parsed
    if not isinstance(num, str) and "e" not in str(num):
        assert float(format_str(num, digit)) == num


def test_average_meter_matches_jax():
    from sisr_tpu.utils.meters import AverageMeter as MeterJax
    from sisr_tpu_torch.utils.meters import AverageMeter

    a, b = AverageMeter(), MeterJax()
    for v, n in [(0.5, 2), (0.25, 1), (1.5, 3)]:
        a.update(v, n)
        b.update(v, n)
    assert (a.val, a.sum, a.count, a.avg) == (b.val, b.sum, b.count, b.avg)
    a.reset()
    assert (a.sum, a.count, a.avg) == (0.0, 0, 0.0)


def test_step_timer_and_trace(tmp_path):
    from sisr_tpu_torch.utils.profiling import StepTimer, device_time, trace

    timer = StepTimer(window=2)
    for _ in range(3):
        timer.start()
        assert timer.stop() >= 0
    assert len(timer._times) == 2 and timer.mean >= 0
    with trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert (tmp_path / "trace.json").exists()
    assert len(prof.key_averages()) > 0
    with pytest.raises(RuntimeError):   # device timing needs a card
        device_time(lambda: None)
