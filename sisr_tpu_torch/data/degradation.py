"""Blind-SR degradation pipeline (BSRGAN recipe); a copy of
``sisr_tpu/data/degradation.py`` with the same draws in the same order, so
that a seeded pair is bit-identical to the JAX package's.

Host-side synthesis of realistic low-quality training inputs, with
distribution-level parity to the pipeline the reference imports from KAIR
(参考资料/KAIR_master/utils/utils_blindsr.py:431-518 ``degradation_bsrgan``):

  * optional pre-downsample to sf=2 (prob 0.25 when sf=4)
  * a random shuffle of 7 stages with the constraint that the rescale stage
    (idx 2) precedes the final-downsample stage (idx 3):
      0,1: Gaussian blur (anisotropic rotated / isotropic, random size+width)
      2:   with prob .75, random-interp downscale by a factor U[1, 2*sf];
           otherwise shifted-kernel blur + nearest ::sf decimation
      3:   resize to exactly 1/sf of the pre-stage-2 size
      4:   Gaussian noise — color (p>.6) / grayscale (p<.4) / channel-correlated
      5:   JPEG recompress, prob 0.9, quality U[30, 95]
      6:   camera ISP hook (unused — no ISP model ships with the reference)
  * a final unconditional JPEG recompress
  * an aligned random (lq_patchsize, sf*lq_patchsize) crop

Exact stochastic replay of the reference is impossible (it consumes Python's
global RNG in shuffled order); this implementation takes explicit RNGs so
workers are reproducible and tests can pin randomness.

Resampling, filtering and JPEG coding run through cv2 on the host, as in
the JAX package; everything else is vectorized numpy/scipy.
"""

from __future__ import annotations

import random as _random
from typing import Optional, Tuple

import cv2
import numpy as np
from scipy import ndimage

from sisr_tpu_torch.ops.resize import imresize_matlab_np

# cv2 interpolation codes drawn from: LINEAR(1), CUBIC(2), AREA(3)
_CV2_INTERPS = (cv2.INTER_LINEAR, cv2.INTER_CUBIC, cv2.INTER_AREA)


def gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """Isotropic Gaussian kernel, MATLAB fspecial('gaussian') semantics."""
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half:half + 1, -half:half + 1]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    k[k < np.finfo(float).eps * k.max()] = 0
    s = k.sum()
    return k / s if s != 0 else k


def _gaussian_1d(size: int, sigma: float) -> np.ndarray:
    """1-D factor of ``gaussian_kernel`` (the 2-D kernel is its normalized
    outer product up to fspecial's eps-threshold, i.e. to ~1e-16 relative)."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    s = g.sum()
    return g / s if s != 0 else g


def _sep_blur(img: np.ndarray, ky: np.ndarray, kx: np.ndarray) -> np.ndarray:
    """Separable convolution: equals ``_conv_blur(img, np.outer(ky, kx))``.

    sepFilter2D correlates, so each 1-D kernel is flipped for convolution.
    """
    return cv2.sepFilter2D(
        img, -1, kx[::-1].astype(np.float32).copy(),
        ky[::-1].astype(np.float32).copy(),
        borderType=cv2.BORDER_REFLECT_101)


def anisotropic_gaussian_kernel(size: int, theta: float, l1: float, l2: float) -> np.ndarray:
    """Rotated anisotropic Gaussian kernel with eigenvalues (l1, l2)."""
    c, s = np.cos(theta), np.sin(theta)
    v = np.array([c, s])
    basis = np.array([[v[0], v[1]], [v[1], -v[0]]])
    cov = basis @ np.diag([l1, l2]) @ np.linalg.inv(basis)
    icov = np.linalg.inv(cov)

    half = size / 2.0 + 0.5
    y, x = np.mgrid[0:size, 0:size]
    dx = x - half + 1
    dy = y - half + 1
    d = np.stack([dx, dy], axis=-1)
    expo = -0.5 * np.einsum("...i,ij,...j->...", d, icov, d)
    k = np.exp(expo) / (2 * np.pi * np.sqrt(np.linalg.det(cov)))
    return k / k.sum()


def shifted_downsample_kernel(size: int, sigma: float, sf: int) -> np.ndarray:
    """Gaussian kernel bilinearly shifted by (sf-1)/2 px so that ::sf nearest
    decimation stays grid-aligned with the HR image."""
    k = gaussian_kernel(size, sigma)
    shift = (sf - 1) * 0.5
    coords = np.arange(size, dtype=np.float64)
    src = np.clip(coords + shift, 0, size - 1)
    i0 = np.floor(src).astype(int)
    i1 = np.minimum(i0 + 1, size - 1)
    f = src - i0
    k = k[i0, :] * (1 - f)[:, None] + k[i1, :] * f[:, None]
    k = k[:, i0] * (1 - f)[None, :] + k[:, i1] * f[None, :]
    return k / k.sum()


def _shifted_downsample_1d(size: int, sigma: float, sf: int) -> np.ndarray:
    """1-D factor of ``shifted_downsample_kernel`` (the bilinear shift acts
    per axis, so the 2-D kernel is the normalized outer product)."""
    g = _gaussian_1d(size, sigma)
    shift = (sf - 1) * 0.5
    coords = np.arange(size, dtype=np.float64)
    src = np.clip(coords + shift, 0, size - 1)
    i0 = np.floor(src).astype(int)
    i1 = np.minimum(i0 + 1, size - 1)
    f = src - i0
    g = g[i0] * (1 - f) + g[i1] * f
    return g / g.sum()


def _conv_blur(img: np.ndarray, kernel: np.ndarray, mode: str = "mirror") -> np.ndarray:
    """2-D convolution of an HWC image with one kernel per all channels.

    Routed through cv2.filter2D (SIMD + DFT for large kernels): numerically
    equivalent (~1e-7 max diff, float32 accumulation / DFT path) to
    ``ndimage.convolve(img, kernel[:, :, None], mode="mirror")`` — filter2D
    computes correlation, so the kernel is flipped, and BORDER_REFLECT_101 is
    ndimage's 'mirror' — but 6-16x faster (the blur stages were 68% of the
    56 ms/sample pipeline cost under scipy).
    """
    if mode != "mirror":
        return ndimage.convolve(img, kernel[:, :, None], mode=mode)
    kf = cv2.flip(np.ascontiguousarray(kernel, dtype=np.float32), -1)
    return cv2.filter2D(img, -1, kf, borderType=cv2.BORDER_REFLECT_101)


def add_blur(img: np.ndarray, sf: int, rng: _random.Random) -> np.ndarray:
    wd_aniso = 4.0 + sf
    wd_iso = 2.0 + 0.2 * sf
    ksize = 2 * rng.randint(2, 11) + 3
    if rng.random() < 0.5:
        k = anisotropic_gaussian_kernel(
            ksize, rng.random() * np.pi, wd_aniso * rng.random(), wd_aniso * rng.random())
        return _conv_blur(img, k)
    g = _gaussian_1d(ksize, wd_iso * rng.random())
    return _sep_blur(img, g, g)


def _correlated_noise(nrng: np.random.Generator, shape2d, cov: np.ndarray) -> np.ndarray:
    """N(0, cov) channel-correlated field via the SVD factor (the same
    factorization np.random's svd-method multivariate_normal uses, drawn in
    float32 — ~10x faster than the per-call multivariate_normal machinery)."""
    u, s, vt = np.linalg.svd(cov)
    factor = (np.sqrt(s)[:, None] * vt).astype(np.float32)
    z = nrng.standard_normal((*shape2d, 3), dtype=np.float32)
    return z @ factor


def add_gaussian_noise(img: np.ndarray, rng: _random.Random, nrng: np.random.Generator,
                       level_lo: int = 2, level_hi: int = 25) -> np.ndarray:
    level = rng.randint(level_lo, level_hi)
    branch = nrng.random()
    if branch > 0.6:  # color noise
        img = img + nrng.standard_normal(img.shape, dtype=np.float32) * (level / 255.0)
    elif branch < 0.4:  # grayscale noise
        img = img + (nrng.standard_normal((*img.shape[:2], 1), dtype=np.float32)
                     * (level / 255.0))
    else:  # channel-correlated noise
        scale = level_hi / 255.0
        d = np.diag(nrng.random(3))
        # random orthonormal basis
        u, _ = np.linalg.qr(nrng.random((3, 3)))
        cov = np.abs(scale ** 2 * (u.T @ d @ u))
        img = img + _correlated_noise(nrng, img.shape[:2], cov)
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img: np.ndarray, rng: _random.Random) -> np.ndarray:
    quality = rng.randint(30, 95)
    bgr = cv2.cvtColor((img.clip(0, 1) * 255.0).round().astype(np.uint8),
                       cv2.COLOR_RGB2BGR)
    ok, enc = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    if not ok:
        raise RuntimeError("cv2 could not encode a JPEG")
    dec = cv2.imdecode(enc, 1)
    return cv2.cvtColor(dec, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def paired_random_crop(lq: np.ndarray, hq: np.ndarray, sf: int, lq_patchsize: int,
                       rng: _random.Random) -> Tuple[np.ndarray, np.ndarray]:
    h, w = lq.shape[:2]
    top = rng.randint(0, h - lq_patchsize)
    left = rng.randint(0, w - lq_patchsize)
    lq = lq[top:top + lq_patchsize, left:left + lq_patchsize, :]
    hq = hq[top * sf:(top + lq_patchsize) * sf, left * sf:(left + lq_patchsize) * sf, :]
    return lq, hq


def degradation_bsrgan(
    img: np.ndarray,
    sf: int = 4,
    lq_patchsize: int = 72,
    isp_model=None,
    rng: Optional[_random.Random] = None,
    nrng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """HWC [0,1] HR image -> (lq patch, hq patch).

    lq is (lq_patchsize, lq_patchsize, C); hq is sf x that.
    """
    rng = rng or _random
    nrng = nrng or np.random.default_rng()
    jpeg_prob, scale2_prob = 0.9, 0.25
    sf_ori = sf

    h1, w1 = img.shape[:2]
    img = np.asarray(img, dtype=np.float32)[: h1 - h1 % sf, : w1 - w1 % sf, :].copy()
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"image ({h1}x{w1}) too small for lq_patchsize {lq_patchsize}")

    hq = img.copy()

    if sf == 4 and rng.random() < scale2_prob:
        if nrng.random() < 0.5:
            img = cv2.resize(img, (w // 2, h // 2), interpolation=rng.choice(_CV2_INTERPS))
        else:
            img = imresize_matlab_np(img, 0.5, antialias=True)
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    order = rng.sample(range(7), 7)
    i_rescale, i_down = order.index(2), order.index(3)
    if i_rescale > i_down:  # final downsample must come after the rescale
        order[i_rescale], order[i_down] = order[i_down], order[i_rescale]

    pre_w, pre_h = img.shape[1], img.shape[0]
    for stage in order:
        if stage in (0, 1):
            img = add_blur(img, sf, rng)
        elif stage == 2:
            pre_w, pre_h = img.shape[1], img.shape[0]
            if rng.random() < 0.75:
                sf1 = rng.uniform(1, 2 * sf)
                img = cv2.resize(img, (int(img.shape[1] / sf1), int(img.shape[0] / sf1)),
                                 interpolation=rng.choice(_CV2_INTERPS))
            else:
                g = _shifted_downsample_1d(25, rng.uniform(0.1, 0.6 * sf), sf)
                img = _sep_blur(img, g, g)
                img = img[::sf, ::sf, :]
            img = np.clip(img, 0.0, 1.0)
        elif stage == 3:
            img = cv2.resize(img, (int(pre_w / sf), int(pre_h / sf)),
                             interpolation=rng.choice(_CV2_INTERPS))
            img = np.clip(img, 0.0, 1.0)
        elif stage == 4:
            img = add_gaussian_noise(img, rng, nrng)
        elif stage == 5:
            if rng.random() < jpeg_prob:
                img = add_jpeg_noise(img, rng)
        elif stage == 6:
            if isp_model is not None and rng.random() < 0.25:
                img, hq = isp_model(img.copy(), hq)

    img = add_jpeg_noise(img, rng)
    return paired_random_crop(img, hq, sf_ori, lq_patchsize, rng)


def add_resize(img: np.ndarray, sf: int, rng: _random.Random,
               nrng: np.random.Generator) -> np.ndarray:
    """Random-interp rescale (KAIR utils_blindsr.py:348-360): up U[1,2] with
    prob .2, down U[0.5/sf, 1] with prob .7, identity otherwise."""
    rnum = nrng.random()
    if rnum > 0.8:
        sf1 = rng.uniform(1, 2)
    elif rnum < 0.7:
        sf1 = rng.uniform(0.5 / sf, 1)
    else:
        sf1 = 1.0
    img = cv2.resize(img, (int(sf1 * img.shape[1]), int(sf1 * img.shape[0])),
                     interpolation=rng.choice(_CV2_INTERPS))
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise(img: np.ndarray, rng: _random.Random,
                      nrng: np.random.Generator) -> np.ndarray:
    """Shot noise at a random exposure 10^U[2,4] (utils_blindsr.py:398-408)."""
    img = np.clip((img * 255.0).round(), 0, 255) / 255.0
    vals = 10 ** (2 * rng.random() + 2.0)
    if rng.random() < 0.5:
        img = nrng.poisson(img * vals).astype(np.float32) / vals
    else:
        gray = img[..., :3] @ np.asarray([0.299, 0.587, 0.114])
        gray = np.clip((gray * 255.0).round(), 0, 255) / 255.0
        img = img + (nrng.poisson(gray * vals).astype(np.float32) / vals
                     - gray)[:, :, None]
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def add_speckle_noise(img: np.ndarray, rng: _random.Random,
                      nrng: np.random.Generator,
                      level_lo: int = 2, level_hi: int = 25) -> np.ndarray:
    """Multiplicative Gaussian noise (utils_blindsr.py:380-395)."""
    level = rng.randint(level_lo, level_hi)
    img = np.clip(img, 0.0, 1.0)
    branch = rng.random()
    if branch > 0.6:
        img = img + img * (nrng.standard_normal(img.shape, dtype=np.float32)
                           * (level / 255.0))
    elif branch < 0.4:
        img = img + img * (nrng.standard_normal((*img.shape[:2], 1), dtype=np.float32)
                           * (level / 255.0))
    else:
        scale = level_hi / 255.0
        d = np.diag(nrng.random(3))
        u, _ = np.linalg.qr(nrng.random((3, 3)))
        cov = np.abs(scale ** 2 * (u.T @ d @ u))
        img = img + img * _correlated_noise(nrng, img.shape[:2], cov)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def add_sharpening(img: np.ndarray, weight: float = 0.5, radius: int = 50,
                   threshold: int = 10) -> np.ndarray:
    """USM sharpening (utils_blindsr.py:308-331, borrowed from Real-ESRGAN)."""
    if radius % 2 == 0:
        radius += 1
    blur = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def degradation_bsrgan_plus(
    img: np.ndarray,
    sf: int = 4,
    shuffle_prob: float = 0.5,
    use_sharp: bool = False,
    lq_patchsize: int = 64,
    isp_model=None,
    rng: Optional[_random.Random] = None,
    nrng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extended BSRGAN+Real-ESRGAN degradation (utils_blindsr.py:521-605):
    13 stages (blur/resize/gauss/poisson/speckle/isp twice + mid JPEG), fully
    shuffled with prob ``shuffle_prob`` else locally shuffled noise groups;
    final 1/sf resize + JPEG + aligned crop.  Unused by the flagship app
    (which calls ``degradation_bsrgan``) — provided for library parity."""
    rng = rng or _random
    nrng = nrng or np.random.default_rng()

    h1, w1 = img.shape[:2]
    img = img.copy()[:h1 - h1 % sf, :w1 - w1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}x{w1}) is too small")

    if use_sharp:
        img = add_sharpening(img)
    hq = img.copy()

    if rng.random() < shuffle_prob:
        order = rng.sample(range(13), 13)
    else:
        order = list(range(13))
        order[2:6] = rng.sample(order[2:6], 4)
        order[9:13] = rng.sample(order[9:13], 4)

    poisson_prob = speckle_prob = isp_prob = 0.1
    for i in order:
        if i in (0, 7):
            img = add_blur(img, sf, rng)
        elif i in (1, 8):
            img = add_resize(img, sf, rng, nrng)
        elif i in (2, 9):
            img = add_gaussian_noise(img, rng, nrng, 2, 25)
        elif i in (3, 10):
            if rng.random() < poisson_prob:
                img = add_poisson_noise(img, rng, nrng)
        elif i in (4, 11):
            if rng.random() < speckle_prob:
                img = add_speckle_noise(img, rng, nrng)
        elif i in (5, 12):
            if isp_model is not None and rng.random() < isp_prob:
                img, hq = isp_model(img.copy(), hq)
        elif i == 6:
            img = add_jpeg_noise(img, rng)

    img = cv2.resize(img, (int(hq.shape[1] / sf), int(hq.shape[0] / sf)),
                     interpolation=rng.choice(_CV2_INTERPS))
    img = add_jpeg_noise(img, rng)
    return paired_random_crop(img, hq, sf, lq_patchsize, rng)
