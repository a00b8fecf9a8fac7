"""Softmax attention in square windows over an NHWC map: HAT's window
attention (shifted or not) and its overlapping cross-attention.

``win_attn(qkv, bias, heads, window, shift, key_window)`` takes the qkv
Linear's output (B, Hp, Wp, 3C), channels [q | k | v], each (head, d), on a
map whose sides divide ``window``, and returns softmax(q k^T d^-0.5 + bias
(+ mask)) v per (window, head) as (B, Hp, Wp, C), un-shifted and
un-partitioned, ready for the output projection:

- ``key_window == window``: the keys are the query window's own pixels.
  With ``shift`` > 0 the map is rolled by -shift first and the result rolled
  back (Swin's cyclic shift), and a query and a key in different regions of
  the rolled map get -100 (the regions cut each axis at -window and
  -shift).
- ``key_window > window``: the keys of the window at (i, j) are the
  ``key_window``-square around it, (key_window - window) / 2 pixels beyond
  each side (``nn.Unfold(key_window, stride=window, padding=...)`` of the k
  and v maps); keys beyond the map are zeros, read as zeros (a logit of
  the bias alone, a value of 0), not masked.

``bias`` is float32 (heads, window^2, key_window^2), made by the caller
from its position table.  The plain version ``win_attn_reference`` forms
the scores in float32 from the inputs, rounds the probabilities to the
input's type before the product with v (as the kernel does) and runs a
chunk of windows at a time.  ``win_attn`` runs it for a CPU tensor and the
kernel ``csrc/win_attn.cu`` for a CUDA one; the gradient is the plain
version's vjp (``autograd.KernelFunction``).  This replaces no TPU kernel:
the JAX package has no softmax window attention; see the source's note.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.autograd import KernelFunction
from sisr_tpu_torch.utils.constants import device_constant

# logit added where a query and a key lie in different regions of the
# rolled map (Swin's and HAT's attention mask)
MASK_VALUE = -100.0
# score elements of one chunk of the plain version (float32: 512 MiB)
CHUNK_ELEMS = 1 << 27
# what csrc/win_attn.cu takes: an even head size up to 32, and the
# (window, key_window) pairs compiled in, HAT's (16, its own or the 24 square)
MAX_HEAD_DIM = 32
KERNEL_WINDOWS = ((16, 16), (16, 24))


def shift_regions(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """(windows, window^2) region id of every pixel of every window of the
    map rolled by -shift, windows row-major: 3 * row region + column
    region, each axis cut at -window and -shift."""
    def axis(n):
        r = np.zeros(n, dtype=np.int64)
        r[n - window:] = 1
        r[n - shift:] = 2
        return r
    reg = axis(hp)[:, None] * 3 + axis(wp)[None, :]
    nh, nw = hp // window, wp // window
    return reg.reshape(nh, window, nw, window).transpose(0, 2, 1, 3).reshape(
        nh * nw, window * window)


def _windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/window * W/window, window^2, C), windows
    row-major within each image."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _unwindows(x: torch.Tensor, window: int, b: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``_windows``."""
    c = x.shape[-1]
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _overlap_windows(x: torch.Tensor, window: int, key_window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/window * W/window, key_window^2, C): the
    key_window-square around each window, zero beyond the map."""
    b, h, w, c = x.shape
    o = (key_window - window) // 2
    xp = torch.nn.functional.pad(x, (0, 0, o, o, o, o))
    xw = xp.unfold(1, key_window, window).unfold(2, key_window, window)  # b, nh, nw, c, k, k
    return xw.permute(0, 1, 2, 4, 5, 3).reshape(-1, key_window * key_window, c)


def _check_shapes(qkv, bias, heads: int, window: int, shift: int, key_window: int):
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % heads:
        raise ValueError(f"win_attn: {c3} channels are not 3 x heads ({heads}) x d")
    if hp % window or wp % window:
        raise ValueError(f"win_attn: the map {hp}x{wp} does not divide window {window}")
    if key_window < window or (key_window - window) % 2:
        raise ValueError(f"win_attn: key window {key_window} around window {window}")
    if shift and key_window != window:
        raise ValueError("win_attn: a shift needs key_window == window")
    if not 0 <= shift < window:
        raise ValueError(f"win_attn: shift {shift} outside [0, {window})")
    want = (heads, window * window, key_window * key_window)
    if tuple(bias.shape) != want:
        raise ValueError(f"win_attn: bias {tuple(bias.shape)} is not {want}")
    return b, hp, wp, c


def win_attn_reference(qkv: torch.Tensor, bias: torch.Tensor, heads: int, window: int,
                       shift: int = 0, key_window: int = 0) -> torch.Tensor:
    """Plain version: (B, Hp, Wp, 3C), float32 (heads, N, M) -> (B, Hp, Wp, C)."""
    key_window = key_window or window
    b, hp, wp, c = _check_shapes(qkv, bias, heads, window, shift, key_window)
    d, dt = c // heads, qkv.dtype
    if shift:
        qkv = torch.roll(qkv, (-shift, -shift), (1, 2))
    q, k, v = qkv.split(c, dim=-1)
    qw = _windows(q, window)
    if key_window == window:
        kw, vw = _windows(k, window), _windows(v, window)
    else:
        kw, vw = (_overlap_windows(t, window, key_window) for t in (k, v))
    nwin, n = qw.shape[:2]
    m = kw.shape[1]
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)
    qw, kw, vw = split(qw), split(kw), split(vw)
    regions = None
    if shift:
        regions = device_constant(shift_regions, (hp, wp, window, shift), torch.long,
                                  qkv.device)
    per_image = regions.shape[0] if regions is not None else 1
    step = max(1, CHUNK_ELEMS // (heads * n * m))
    outs = []
    for s in range(0, nwin, step):
        e = min(nwin, s + step)
        scores = (qw[s:e].float() @ kw[s:e].float().transpose(-1, -2)) * d ** -0.5 + bias
        if regions is not None:
            r = regions[torch.arange(s, e, device=qkv.device) % per_image]
            scores = scores + torch.where(r[:, :, None] != r[:, None, :], MASK_VALUE,
                                          0.0)[:, None]
        p = torch.softmax(scores, dim=-1).to(dt)
        outs.append((p @ vw[s:e]).transpose(1, 2).reshape(e - s, n, c))
    out = _unwindows(torch.cat(outs) if len(outs) > 1 else outs[0], window, b, hp, wp)
    if shift:
        out = torch.roll(out, (shift, shift), (1, 2))
    return out


def _win_attn_cuda(qkv, bias, heads: int, window: int, shift: int, key_window: int):
    b, hp, wp, c = _check_shapes(qkv, bias, heads, window, shift, key_window)
    d = c // heads
    if d > MAX_HEAD_DIM or d % 2 or (window, key_window) not in KERNEL_WINDOWS:
        raise ValueError(f"win_attn: the kernel takes an even head size up to "
                         f"{MAX_HEAD_DIM} (got {d}) and windows {KERNEL_WINDOWS} "
                         f"(got {(window, key_window)})")
    build.check_cuda("win_attn", qkv.device, qkv.dtype, qkv=qkv)
    build.check_cuda("win_attn", bias.device, torch.float32, bias=bias)
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    fn = build.library("win_attn").win_attn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    code = build.launch(fn, qkv.device, build.DTYPE_CODES[qkv.dtype], build.ptr(qkv),
                        build.ptr(bias), build.ptr(out), b, hp, wp, c, heads, window,
                        key_window, shift, float(d) ** -0.5)
    build.raise_on_error("win_attn", code)
    return out


@build.launched("win_attn")
def _kernel(qkv, bias, heads: int, window: int, shift: int = 0, key_window: int = 0):
    """The kernel with the plain version's signature."""
    return _win_attn_cuda(qkv, build.as_arg(bias, torch.float32), heads, window, shift,
                          key_window or window)


WIN_ATTN = KernelFunction("win_attn", _kernel, win_attn_reference)


def win_attn(qkv, bias, heads: int, window: int, shift: int = 0, key_window: int = 0,
             reference: bool = False) -> torch.Tensor:
    """Window attention over the qkv map (module docstring).  A CPU tensor
    runs the plain version; a CUDA tensor the kernel unless
    ``reference=True``."""
    if reference or qkv.device.type == "cpu":
        return win_attn_reference(qkv, bias, heads, window, shift, key_window)
    return WIN_ATTN(qkv, bias, heads, window, shift, key_window)
