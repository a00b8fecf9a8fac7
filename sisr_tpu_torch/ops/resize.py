"""Resampling primitives (port of ``sisr_tpu/ops/resize.py``).

``imresize_matlab`` reproduces MATLAB's ``imresize`` (bicubic kernel,
antialiasing on downscale), the de-facto standard resampler of the SR
literature.  The reference implements it with per-row Python loops
(reference utils/utils.py:399-570, KAIR utils_image.imresize_np); here the
resample is separable: per axis a gather of the taps (``index_select``) and
their weighted sum.  Weights and indices depend only on (in_length,
out_length), so they are computed once in numpy and cached.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def _cubic(x: np.ndarray) -> np.ndarray:
    """Keys bicubic kernel, a = -0.5 (MATLAB's 'cubic')."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    ) * ((ax > 1) & (ax <= 2))


@lru_cache(maxsize=256)
def _resize_plan(in_length: int, out_length: int, scale: float, antialias: bool):
    """Per-axis gather indices + weights for MATLAB-style bicubic resampling.

    Returns (indices, weights) with shapes (out_length, taps); indices map
    into the *unpadded* input via symmetric (reflect-with-edge) extension.
    The cached arrays are shared: callers must not write to them.
    """
    kernel_width = 4.0
    if scale < 1 and antialias:
        kernel_width = 4.0 / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    # Map output coords to input space so that pixel centres align.
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    taps = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(taps)[None, :]  # 1-based
    dist = u[:, None] - indices
    if scale < 1 and antialias:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # Drop all-zero boundary taps (mirrors the reference's narrow()s).
    if not math.isclose((weights[:, 0] == 0).sum(), 0, rel_tol=1e-6):
        indices = indices[:, 1:]
        weights = weights[:, 1:]
    if not math.isclose((weights[:, -1] == 0).sum(), 0, rel_tol=1e-6):
        indices = indices[:, :-1]
        weights = weights[:, :-1]

    # 1-based -> 0-based, then fold out-of-range taps back in via
    # symmetric-with-edge reflection (equivalent to the reference's explicit
    # padded copy at utils/utils.py:442-453).
    idx = indices.astype(np.int64) - 1
    idx = np.where(idx < 0, -1 - idx, idx)
    idx = np.where(idx >= in_length, 2 * in_length - 1 - idx, idx)
    idx = np.clip(idx, 0, in_length - 1)
    return idx, np.ascontiguousarray(weights)


def _resample_axis(x: torch.Tensor, axis: int, out_length: int, scale: float,
                   antialias: bool) -> torch.Tensor:
    idx, w = _resize_plan(x.shape[axis], out_length, scale, antialias)
    index = torch.as_tensor(idx, device=x.device)
    weights = torch.as_tensor(w, dtype=x.dtype, device=x.device)
    shape = [1] * x.ndim
    shape[axis] = out_length
    out = None
    for t in range(idx.shape[1]):
        term = x.index_select(axis, index[:, t]) * weights[:, t].reshape(shape)
        out = term if out is None else out + term
    return out


def imresize_matlab(img: torch.Tensor, scale: float, antialias: bool = True,
                    h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """MATLAB-exact bicubic resize of an NHWC / HWC / HW image stack.

    Matches the reference's ``imresize`` (utils/utils.py:399-491) to float32
    round-off.  Output spatial dims are ``ceil(in * scale)``.
    """
    if img.ndim == 2:
        h_axis, w_axis = 0, 1
    h_axis = h_axis % img.ndim
    w_axis = w_axis % img.ndim
    out_h = math.ceil(img.shape[h_axis] * scale)
    out_w = math.ceil(img.shape[w_axis] * scale)
    img = _resample_axis(img, h_axis, out_h, scale, antialias)
    img = _resample_axis(img, w_axis, out_w, scale, antialias)
    return img


def imresize_matlab_np(img: np.ndarray, scale: float, antialias: bool = True) -> np.ndarray:
    """Host (numpy) MATLAB bicubic for the data pipeline. HWC or HW, float."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    out_h = math.ceil(img.shape[0] * scale)
    out_w = math.ceil(img.shape[1] * scale)

    idx_h, w_h = _resize_plan(img.shape[0], out_h, scale, antialias)
    idx_w, w_w = _resize_plan(img.shape[1], out_w, scale, antialias)

    # accumulate per tap in float64, without materializing the
    # (out, taps, W, C) temporary of a gather-then-einsum
    x = img.astype(np.float64, copy=False)
    acc_h = np.zeros((out_h,) + x.shape[1:], dtype=np.float64)
    for t in range(idx_h.shape[1]):
        acc_h += w_h[:, t, None, None] * x[idx_h[:, t]]
    acc_w = np.zeros((out_h, out_w, x.shape[2]), dtype=np.float64)
    for t in range(idx_w.shape[1]):
        acc_w += w_w[None, :, t, None] * acc_h[:, idx_w[:, t]]
    x = acc_w.astype(np.float32)
    return x[:, :, 0] if squeeze else x


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour xfactor upsample of NHWC (torch F.interpolate parity)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NHWC, align_corners=False (torch parity).

    Used by the UNet discriminator's x2 upsampling path
    (reference KAIR network_discriminator.py:106-137).
    """
    b, h, w, c = x.shape

    def plan(n_in: int, n_out: int):
        u = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(u).astype(np.int64)
        frac = u - i0
        i0c = np.clip(i0, 0, n_in - 1)
        i1c = np.clip(i0 + 1, 0, n_in - 1)
        return (torch.as_tensor(i0c, device=x.device), torch.as_tensor(i1c, device=x.device),
                torch.as_tensor(frac.astype(np.float32), dtype=x.dtype, device=x.device))

    h0, h1, fh = plan(h, out_h)
    w0, w1, fw = plan(w, out_w)
    fh = fh[None, :, None, None]
    fw = fw[None, None, :, None]

    top = x[:, h0, :, :] * (1 - fh) + x[:, h1, :, :] * fh
    return top[:, :, w0, :] * (1 - fw) + top[:, :, w1, :] * fw
