"""Image quality metrics: PSNR and SSIM (port of ``sisr_tpu/ops/metrics.py``).

Matches the metric semantics the reference gets from skimage
(experiments/experiment.py:459-468 eval, :603-613 test):

* ``psnr(a, b, data_range=1)``  == skimage.metrics.peak_signal_noise_ratio
* ``ssim(a, b, data_range=1)``  == skimage.metrics.structural_similarity with
  default settings (7x7 uniform window, sample covariance), and with
  ``gaussian_weights=True`` (11x11 gaussian, sigma 1.5) as used in test mode.

Implemented from the Wang et al. SSIM definition + the skimage parameter
conventions (win_size, cov_norm = N/(N-1), border crop of win_size//2).
``psnr``/``ssim`` run on the host in numpy (float64); ``psnr_torch``/
``ssim_torch`` run on a tensor's device in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import ndimage


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * math.log10((data_range ** 2) / mse))


def _ssim_filter_np(x: np.ndarray, win_size: int, gaussian: bool, sigma: float):
    if gaussian:
        return ndimage.gaussian_filter(x, sigma=sigma, truncate=3.5, mode="reflect")
    return ndimage.uniform_filter(x, size=win_size, mode="reflect")


def ssim(
    a: np.ndarray,
    b: np.ndarray,
    data_range: float = 1.0,
    gaussian_weights: bool = False,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Structural similarity of two 2-D (grayscale) images."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.ndim == 3 and a.shape[0] == 1:
        a, b = a[0], b[0]
    if a.ndim != 2:
        raise ValueError("ssim expects single-channel 2-D images")

    sigma = 1.5
    if gaussian_weights:
        win_size = 2 * int(3.5 * sigma + 0.5) + 1  # 11
    else:
        win_size = 7
    n = win_size ** a.ndim
    cov_norm = n / (n - 1)  # sample covariance correction (skimage parity)

    filt = lambda x: _ssim_filter_np(x, win_size, gaussian_weights, sigma)
    ux, uy = filt(a), filt(b)
    uxx, uyy, uxy = filt(a * a), filt(b * b), filt(a * b)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))

    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


# ---------------------------------------------------------------------------
# tensor variants (on the tensor's device)
# ---------------------------------------------------------------------------

def psnr_torch(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean(torch.square(a.float() - b.float()))
    return 10.0 * torch.log10((data_range ** 2) / mse)


def _gaussian_kernel1d(sigma: float, truncate: float = 3.5) -> np.ndarray:
    r = int(truncate * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _valid_filter(x: torch.Tensor, taps) -> torch.Tensor:
    """Separable 'valid' correlation of a 2-D map with the 1-D ``taps``, as
    a weighted sum of shifted slices (float32 FMAs on any device; a
    convolution would run in TF32 on the card)."""
    k = len(taps)
    h, w = x.shape
    rows = sum(float(t) * x[i:h - k + 1 + i] for i, t in enumerate(taps))
    return sum(float(t) * rows[:, i:w - k + 1 + i] for i, t in enumerate(taps))


def ssim_torch(
    a: torch.Tensor,
    b: torch.Tensor,
    data_range: float = 1.0,
    gaussian_weights: bool = False,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """SSIM of 2-D images on their device.  Uses 'valid' filtering, which
    equals the reflect-filter + border-crop combination on the interior
    (identical mean)."""
    a = a.float()
    b = b.float()
    sigma = 1.5
    if gaussian_weights:
        win_size = 2 * int(3.5 * sigma + 0.5) + 1
        taps = np.float32(_gaussian_kernel1d(sigma))
    else:
        win_size = 7
        taps = np.full((win_size,), 1.0 / win_size, dtype=np.float32)

    def filt(x):
        return _valid_filter(x, taps)

    n = win_size ** 2
    cov_norm = n / (n - 1)
    ux, uy = filt(a), filt(b)
    vx = cov_norm * (filt(a * a) - ux * ux)
    vy = cov_norm * (filt(b * b) - uy * uy)
    vxy = cov_norm * (filt(a * b) - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.mean()
