"""Softmax attention in windows over an NHWC map: HAT's window attention
(shifted or not) and its overlapping cross-attention, and DAT's rectangle
windows in two branches over a zero-padded map.

``win_attn(qkv, bias, heads, window, shift, key_window, branches, align)``
takes the qkv Linear's output (B, H, W, 3C), channels [q | k | v], each
(head, d), and returns softmax(q k^T d^-0.5 + bias (+ mask)) v per
(window, head) as (B, H, W, C), un-shifted and un-partitioned, ready for
the output projection.  ``window`` and ``shift`` are an int (square) or
(rows, columns):

- ``align`` 0: the map's sides divide the window (HAT pads by reflection
  before).  ``align`` > 0: the map is taken as zero-padded at the bottom
  and right to multiples of ``align`` (DAT's 32); a key in the padding is a
  zero read as a zero (a logit of the bias alone, a value of 0), not
  masked, and the output is cropped back to H x W.
- ``key_window`` 0 (or the window): the keys are the query window's own
  pixels.  With a shift the (padded) map is rolled by -shift first and the
  result rolled back (Swin's cyclic shift), and a query and a key in
  different regions of the rolled map get -100 (the regions cut each axis
  at -window and -shift, region id 3 * row region + column region).
- ``key_window > window`` (square, no shift): the keys of the window at
  (i, j) are the ``key_window``-square around it, (key_window - window) / 2
  pixels beyond each side (``nn.Unfold(key_window, stride=window,
  padding=...)`` of the k and v maps); keys beyond the map are zeros, read
  as zeros, not masked.
- ``branches`` 2 (DAT's): ``heads`` per branch; the first branch's heads
  take channels [0, C/2) of each of q, k and v in ``window`` with
  ``shift``, the second's channels [C/2, C) in the transposed window with
  the transposed shift; each writes its own half of the output.

``bias`` is float32 (branches x heads, N, M), both branches' heads in
turn, made by the caller from its position table or position MLP.  The plain version
``win_attn_reference`` forms the scores in float32 from the inputs, rounds
the probabilities to the input's type before the product with v (as the
kernel does) and runs a chunk of windows at a time.  ``win_attn`` runs it
for a CPU tensor and the kernel ``csrc/win_attn.cu`` for a CUDA one, in one
launch for both branches, which reads q, k and v in place and writes the
output in place (no pad, roll, partition or cat copy); the gradient is the
plain version's vjp (``autograd.KernelFunction``).  This replaces no TPU
kernel: the JAX package has no softmax window attention; see the source's
note.
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
# (window, key window, branches) that the models call: HAT's 16 with its own
# keys or the 24 square, DAT's 8 x 32 with its own keys in two branches
MAX_HEAD_DIM = 32
KERNEL_WINDOWS = (((16, 16), 0, 1), ((16, 16), 24, 1), ((8, 32), 0, 2))


def _pair(v) -> tuple:
    return (int(v), int(v)) if isinstance(v, (int, np.integer)) else tuple(int(x) for x in v)


def shift_regions(hp: int, wp: int, window, shift) -> np.ndarray:
    """(windows, N) region id of every pixel of every window of the map
    rolled by -shift, windows row-major: 3 * row region + column region,
    each axis cut at -window and -shift of that axis."""
    (wh, ww), (sh, sw) = _pair(window), _pair(shift)

    def axis(n, w, s):
        r = np.zeros(n, dtype=np.int64)
        r[n - w:] = 1
        r[n - s:] = 2
        return r
    reg = axis(hp, wh, sh)[:, None] * 3 + axis(wp, ww, sw)[None, :]
    nh, nw = hp // wh, wp // ww
    return reg.reshape(nh, wh, nw, ww).transpose(0, 2, 1, 3).reshape(nh * nw, wh * ww)


def _windows(x: torch.Tensor, window) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/wh * W/ww, wh * ww, C), windows row-major
    within each image."""
    wh, ww = _pair(window)
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, c)


def _unwindows(x: torch.Tensor, window, b: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``_windows``."""
    wh, ww = _pair(window)
    c = x.shape[-1]
    x = x.reshape(b, h // wh, w // ww, wh, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _overlap_windows(x: torch.Tensor, window: int, key_window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/window * W/window, key_window^2, C): the
    key_window-square around each window, zero beyond the map."""
    b, h, w, c = x.shape
    o = (key_window - window) // 2
    xp = torch.nn.functional.pad(x, (0, 0, o, o, o, o))
    xw = xp.unfold(1, key_window, window).unfold(2, key_window, window)  # b, nh, nw, c, k, k
    return xw.permute(0, 1, 2, 4, 5, 3).reshape(-1, key_window * key_window, c)


def padded_size(h: int, w: int, align: int) -> tuple:
    """(H, W) rounded up to multiples of ``align`` (0: as they are)."""
    if not align:
        return h, w
    return -(-h // align) * align, -(-w // align) * align


def branch_windows(window, shift, branches: int):
    """[(window, shift)] of each branch: the second transposed."""
    (wh, ww), (sh, sw) = _pair(window), _pair(shift)
    return [((wh, ww), (sh, sw)), ((ww, wh), (sw, sh))][:branches]


def _check_shapes(qkv, bias, heads: int, window, shift, key_window: int, branches: int,
                  align: int):
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    (wh, ww), (sh, sw) = _pair(window), _pair(shift)
    if c3 % 3 or c % (heads * branches):
        raise ValueError(f"win_attn: {c3} channels are not 3 x {branches} branches x heads "
                         f"({heads}) x d")
    if branches not in (1, 2):
        raise ValueError(f"win_attn: {branches} branches (1 or 2)")
    hp, wp = padded_size(h, w, align)
    for (bh, bw), _ in branch_windows(window, shift, branches):
        if hp % bh or wp % bw:
            raise ValueError(f"win_attn: the map {hp}x{wp} does not divide window {bh}x{bw}")
    if key_window and key_window != wh:
        if wh != ww or key_window < wh or (key_window - wh) % 2:
            raise ValueError(f"win_attn: key window {key_window} around window {wh}x{ww}")
        if sh or sw or branches != 1 or align:
            raise ValueError("win_attn: overlapping keys take no shift, branch or padding")
    if not (0 <= sh < wh and 0 <= sw < ww):
        raise ValueError(f"win_attn: shift {(sh, sw)} outside the window {(wh, ww)}")
    kw = key_window or wh
    m = kw * kw if key_window and key_window != wh else wh * ww
    want = (heads * branches, wh * ww, m)
    if tuple(bias.shape) != want:
        raise ValueError(f"win_attn: bias {tuple(bias.shape)} is not {want}")
    return b, h, w, c


def _attend(qkv, bias, heads: int, window, shift, key_window: int) -> torch.Tensor:
    """One branch on a map whose sides divide its window: (B, Hp, Wp, 3C)
    -> (B, Hp, Wp, C)."""
    (wh, ww), (sh, sw) = _pair(window), _pair(shift)
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    d, dt = c // heads, qkv.dtype
    shifted = bool(sh or sw)
    if shifted:
        qkv = torch.roll(qkv, (-sh, -sw), (1, 2))
    q, k, v = qkv.split(c, dim=-1)
    qw = _windows(q, (wh, ww))
    if not key_window or key_window == wh:
        kw, vw = _windows(k, (wh, ww)), _windows(v, (wh, ww))
    else:
        kw, vw = (_overlap_windows(t, wh, key_window) for t in (k, v))
    nwin, n = qw.shape[:2]
    m = kw.shape[1]
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)
    qw, kw, vw = split(qw), split(kw), split(vw)
    regions = None
    if shifted:
        regions = device_constant(shift_regions, (hp, wp, (wh, ww), (sh, sw)), torch.long,
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
    out = _unwindows(torch.cat(outs) if len(outs) > 1 else outs[0], (wh, ww), b, hp, wp)
    if shifted:
        out = torch.roll(out, (sh, sw), (1, 2))
    return out


def win_attn_reference(qkv: torch.Tensor, bias: torch.Tensor, heads: int, window,
                       shift=0, key_window: int = 0, branches: int = 1,
                       align: int = 0) -> torch.Tensor:
    """Plain version: (B, H, W, 3C), float32 bias -> (B, H, W, C) (module
    docstring): each branch's channels padded with zeros, rolled,
    partitioned, attended and put back."""
    b, h, w, c = _check_shapes(qkv, bias, heads, window, shift, key_window, branches, align)
    hp, wp = padded_size(h, w, align)
    cb = c // branches
    bias = bias.reshape(branches, heads, *bias.shape[-2:])
    outs = []
    for i, (win, sft) in enumerate(branch_windows(window, shift, branches)):
        part = qkv if branches == 1 else torch.cat(
            [qkv[..., j * c + i * cb:j * c + (i + 1) * cb] for j in range(3)], -1)
        if (hp, wp) != (h, w):
            part = torch.nn.functional.pad(part, (0, 0, 0, wp - w, 0, hp - h))
        outs.append(_attend(part, bias[i], heads, win, sft, key_window)[:, :h, :w])
    return outs[0] if branches == 1 else torch.cat(outs, -1)


def _win_attn_cuda(qkv, bias, heads: int, window, shift, key_window: int, branches: int,
                   align: int):
    b, h, w, c = _check_shapes(qkv, bias, heads, window, shift, key_window, branches, align)
    (wh, ww), (sh, sw) = _pair(window), _pair(shift)
    wk = 0 if key_window in (0, wh) else key_window
    d = c // (heads * branches)
    if d > MAX_HEAD_DIM or d % 2 or ((wh, ww), wk, branches) not in KERNEL_WINDOWS:
        raise ValueError(f"win_attn: the kernel takes an even head size up to "
                         f"{MAX_HEAD_DIM} (got {d}) and (window, key window, branches) "
                         f"{KERNEL_WINDOWS} (got {((wh, ww), wk, branches)})")
    build.check_cuda("win_attn", qkv.device, qkv.dtype, qkv=qkv)
    build.check_cuda("win_attn", bias.device, torch.float32, bias=bias)
    hp, wp = padded_size(h, w, align)
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    fn = build.entry("win_attn", "win_attn_launch", ctypes.c_int,
                     [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                     + [ctypes.c_float, ctypes.c_void_p])
    code = build.launch(fn, qkv.device, build.DTYPE_CODES[qkv.dtype], build.ptr(qkv),
                        build.ptr(bias), build.ptr(out), b, h, w, hp, wp, c,
                        heads * branches, branches, wh, ww, wk, sh, sw, float(d) ** -0.5)
    build.raise_on_error("win_attn", code)
    return out


@build.launched("win_attn")
def _kernel(qkv, bias, heads: int, window, shift=0, key_window: int = 0, branches: int = 1,
            align: int = 0):
    """The kernel with the plain version's signature."""
    return _win_attn_cuda(qkv, build.as_arg(bias, torch.float32), heads, window, shift,
                          key_window, branches, align)


# win_attn(qkv, bias, heads, window, shift=0, key_window=0, branches=1,
# align=0): window attention over the qkv map (module docstring)
win_attn = WIN_ATTN = KernelFunction("win_attn", _kernel,
                                     lambda *args: win_attn_reference(*args), card_only=True)
