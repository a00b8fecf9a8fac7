"""Fused HTB tail: LN1 + residual + ConvFFN + LN2 + residual.

Port of ``sisr_tpu/ops/pallas/ffn.py::_htb_tail_pipe`` (and its stats
variant): the post-attention part of every HierarchicalTransformerBlock,

    x   = shortcut + LN1(attn)
    h   = gelu(x @ W1 + b1)
    h2  = h + gelu(dwconv5x5(h) + dwb)
    y   = h2 @ W2 + b2
    out = x + LN2(y)

The plain version is ``htb_tail_reference``; the CUDA kernel is
``csrc/htb_tail.cu``.  ``htb_tail_stats`` also returns the next block's
SCA input statistics (``stats_reference``).  ``attn`` may be the
window-padded SCC output, taller or wider than ``shortcut``: only rows
[0, H) and columns [0, W) are read.

In bfloat16 at the model's widths (``wgmma_path``) fc1 and fc2 run on
``wgmma`` over W1 and W2 packed once per weight tensor (``pack_w1``,
``pack_w2``), and the rows go in bands (``band_rows``) so that h of one
band stays within 256 MiB; there ``htb_tail_stats``'s per-channel max
comes out of the kernel as the image's, its sum as one partial a slot
(``totals_buffers``), added up here in a fixed order so that the bits are
the same on every run, however the blocks are scheduled.

``htb_tail``'s gradient is the JAX ``custom_vjp``'s (``ffn.py:493-521``):
the vjp of the plain composition recomputed from the saved inputs, with
its 5x5 depthwise conv as ``dwconv5x5`` (the dwconv kernel and its
backward kernel on the card).  ``htb_tail_stats`` has no backward in the
JAX package (the model threads stats in evaluation only): on a CUDA tensor
it refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.autograd import KernelFunction, needs_grad, runs_plain
from sisr_tpu_torch.ops.kernels.dwconv import depthwise_conv_reference, dwconv5x5

K = 5
# the earlier kernels' output tile (csrc/htb_tail.cu TH x TW), and the rows
# of the wgmma path's bands a multiple of it
_TILE = 8
_MAX_C = 192
# h of one band of the wgmma path: the 1080p frame's 1088 rows go in 6
# bands of 192 (271 MB of h each) instead of one (1.5 GB)
_BAND_BYTES = 256 << 20
# the wgmma path's packed widths: W1 as two halves of the hidden channels
# (180 each, rows padded to 184) over C padded to 192; W2 as C padded to
# 184 rows over Ch padded to 384 (csrc/htb_tail.cu, namespace wgt)
_HALF_ROWS, _K1, _K2 = 184, 192, 384


def wgmma_path(dtype, c: int, ch: int) -> bool:
    """Whether ``csrc/htb_tail.cu`` runs this shape on its wgmma path
    (``wgt::takes``): bfloat16 at the model's widths, C = 180, Ch = 360.
    Other widths, and float32, take the earlier kernels."""
    return dtype == torch.bfloat16 and c == 180 and ch == 360


def pack_w1(w1: torch.Tensor) -> torch.Tensor:
    """(C, Ch) -> (368, 192): row 184 g + n holds hidden channel (Ch/2) g + n's
    weights, K-major over C; zero in the padding."""
    c, ch = w1.shape
    half = ch // 2
    out = w1.new_zeros((2 * _HALF_ROWS, _K1))
    out[:half, :c] = w1[:, :half].t()
    out[_HALF_ROWS:_HALF_ROWS + half, :c] = w1[:, half:].t()
    return out


def pack_w2(w2: torch.Tensor) -> torch.Tensor:
    """(Ch, C) -> (184, 384): row n holds output channel n's weights, K-major
    over the hidden channels; zero in the padding."""
    ch, c = w2.shape
    out = w2.new_zeros((_HALF_ROWS, _K2))
    out[:c, :ch] = w2.t()
    return out


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the trailing axis with float32 statistics and the
    clamped fast variance ``max(0, E[x^2] - E[x]^2)``; result in x.dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def htb_tail_reference(attn, shortcut, ln1_s, ln1_b, w1, b1, dw, dwb,
                       w2, b2, ln2_s, ln2_b, dwconv=depthwise_conv_reference):
    """Plain version.  attn/shortcut: (B, H, W, C); w1: (C, Ch);
    dw: (5, 5, Ch); w2: (Ch, C).  ``dwconv`` computes the depthwise conv:
    the plain one by default, ``dwconv5x5`` in the backward."""
    dt = attn.dtype
    x = shortcut + layer_norm(attn, ln1_s, ln1_b)
    h = F.gelu(x @ w1.to(dt) + b1.to(dt))
    h2 = h + F.gelu(dwconv(h, dw.to(dt), dwb.to(dt)))
    y = h2 @ w2.to(dt) + b2.to(dt)
    return x + layer_norm(y, ln2_s, ln2_b)


def stats_reference(out):
    """(cmean (B,H,W), cmax (B,H,W), ssum (B,C), smax (B,C)), all float32:
    the channel mean/max maps feed the next block's SCA patch build, the
    spatial sum/max its squeeze-excite pools."""
    of = out.to(torch.float32)
    return of.mean(-1), of.amax(-1), of.sum((1, 2)), of.amax((1, 2))


def _tail_buffers(b, h, w, c, ch, dt, dev, stats: bool, totals: bool = False):
    """Device buffers of h = gelu(fc1) for every row, which passes between
    the two launches, and the statistics (cmean, cmax, and the per-tile
    partials psum, pmax of the earlier kernels or, with ``totals``, the
    wgmma tail's ``totals_buffers``), all None without ``stats``."""
    hbuf = torch.empty((b, h, w, ch), dtype=dt, device=dev)
    if not stats:
        return hbuf, (None,) * 4
    f32 = torch.float32
    maps = tuple(torch.empty((b, h, w), dtype=f32, device=dev) for _ in range(2))
    if totals:
        return hbuf, maps + totals_buffers(b, c, dev)
    parts = (b, -(-h // _TILE) * -(-w // _TILE), c)
    return hbuf, maps + tuple(torch.empty(parts, dtype=f32, device=dev) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def totals_buffers(b: int, c: int, dev):
    """The wgmma tail's per-channel statistics: zeroed slots of the sums,
    (2 x SMs, B, C), one for each consumer warpgroup of each persistent
    block, which ``stats_totals`` adds up in a fixed order (float atomics would
    add them in the order the blocks finish, which changes from run to
    run), and the (B, C) maxima."""
    f32 = torch.float32
    return (torch.zeros((2 * _sms(torch.device(dev)), b, c), dtype=f32, device=dev),
            torch.empty((b, c), dtype=f32, device=dev))


def stats_totals(stats):
    """(cmean, cmax, ssum, smax) of the wgmma tail's statistics buffers."""
    cmean, cmax, slots, smax = stats
    return cmean, cmax, slots.sum(0), smax


def band_rows(b: int, h: int, w: int, ch: int) -> int:
    """Rows of a band of the wgmma path: all of them, or as many (a multiple
    of 8) as keep h of one band within ``_BAND_BYTES``."""
    rows = _BAND_BYTES // max(1, 2 * b * w * ch)
    return max(_TILE, min(-(-h // _TILE) * _TILE, rows // _TILE * _TILE))


def tail_tiles(b: int, rows: int, w: int) -> int:
    """8x16 output tiles of the wgmma path's tail over ``rows`` rows of
    ``b`` images (``csrc/htb_tail_wg.cuh`` TH x TW)."""
    return b * -(-rows // _TILE) * -(-w // (2 * _TILE))


def tail_plan(b: int, h: int, w: int, ch: int, sms: int) -> list:
    """The wgmma path's tail launches over an h x w map, as ``wgt::launch``
    walks its bands of ``band_rows`` rows: one (r0, r1, tiles, blocks) a
    band, the blocks persistent, one an SM or one a tile where the band has
    fewer tiles (``wgt::tail_grid``)."""
    band = band_rows(b, h, w, ch)
    plan = []
    for r0 in range(0, h, band):
        r1 = min(h, r0 + band)
        tiles = tail_tiles(b, r1 - r0, w)
        plan.append((r0, r1, tiles, min(tiles, sms)))
    return plan


def _wgmma_buffers(b, h, w, c, ch, dt, dev, stats: bool, band: int):
    """The wgmma path's buffers: h of one band and its halo, x of one band,
    and the statistics (cmean, cmax, and the image's per-channel totals)."""
    hbuf = torch.empty((b, min(h, band + 4), w, ch), dtype=dt, device=dev)
    xbuf = torch.empty((b, min(h, band), w, c), dtype=dt, device=dev)
    if not stats:
        return hbuf, xbuf, (None,) * 4
    f32 = torch.float32
    maps = tuple(torch.empty((b, h, w), dtype=f32, device=dev) for _ in range(2))
    return hbuf, xbuf, maps + totals_buffers(b, c, dev)


@build.launched("htb_tail")
def _htb_tail_cuda(attn, shortcut, weights, stats: bool):
    b, h, w, c = shortcut.shape
    ch = weights[2].shape[1]
    dt = shortcut.dtype
    weights = [build.as_arg(t, dt) for t in weights]
    if attn.shape[0] != b or attn.shape[3] != c or attn.shape[1] < h \
            or attn.shape[2] < w:
        raise ValueError(f"htb_tail: attn {tuple(attn.shape)} does not cover "
                         f"shortcut {tuple(shortcut.shape)}")
    if c > _MAX_C:
        raise ValueError(f"htb_tail: C={c} > {_MAX_C}")
    shapes = ((c,), (c,), (c, ch), (ch,), (K, K, ch), (ch,), (ch, c), (c,),
              (c,), (c,))
    for t, s in zip(weights, shapes):
        if tuple(t.shape) != s:
            raise ValueError(f"htb_tail: weight {tuple(t.shape)} != {s}")
    build.check_cuda("htb_tail", shortcut.device, dt, attn=attn,
                     shortcut=shortcut,
                     **{f"w{i}": t for i, t in enumerate(weights)})
    dev = shortcut.device
    out = torch.empty_like(shortcut)
    packed = wgmma_path(dt, c, ch)
    # the wgmma path: W1 and W2 packed once per weight tensor; rows in bands
    w1p, w2p, xbuf, band = None, None, None, 0
    if packed:
        w1, w2 = weights[2], weights[6]
        w1p = build.cached(w1, "_htb_w1_pack", (w1,), lambda: pack_w1(w1))
        w2p = build.cached(w2, "_htb_w2_pack", (w2,), lambda: pack_w2(w2))
        band = band_rows(b, h, w, ch)
        hbuf, xbuf, (cmean, cmax, psum, pmax) = _wgmma_buffers(b, h, w, c, ch, dt, dev,
                                                               stats, band)
    else:
        hbuf, (cmean, cmax, psum, pmax) = _tail_buffers(b, h, w, c, ch, dt, dev, stats)
    fn = build.entry("htb_tail", "htb_tail_launch", ctypes.c_int,
                     [ctypes.c_int] + [ctypes.c_void_p] * 21 + [ctypes.c_longlong] * 2
                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    code = build.launch(fn, dev,
                        build.DTYPE_CODES[dt], build.ptr(attn), build.ptr(shortcut),
                        *[build.ptr(t) for t in weights], build.ptr(out),
                        build.ptr(cmean), build.ptr(cmax), build.ptr(psum),
                        build.ptr(pmax), build.ptr(hbuf), build.ptr(w1p), build.ptr(w2p),
                        build.ptr(xbuf), attn.stride(0), attn.stride(1),
                        b, h, w, c, ch, band)
    build.raise_on_error("htb_tail", code)
    if not stats:
        return out
    build.launches["htb_tail_stats"] += 1
    if packed:          # the kernel's slots and maxima
        return out, stats_totals((cmean, cmax, psum, pmax))
    return out, (cmean, cmax, psum.sum(dim=1), pmax.amax(dim=1))


def _tail_plain(attn, shortcut, *weights):
    """``htb_tail_reference`` on the rows and columns of ``attn`` the tail
    reads, its depthwise conv ``dwconv5x5`` (in the backward on a card:
    the dwconv kernel and its backward kernel)."""
    h, w = shortcut.shape[1:3]
    return htb_tail_reference(attn[:, :h, :w], shortcut, *weights, dwconv=dwconv5x5)


# htb_tail(attn, shortcut, ln1_s, ln1_b, w1, b1, dw, dwb, w2, b2, ln2_s,
# ln2_b): the fused HTB tail (module docstring), the kernel for a CUDA
# tensor, the plain version otherwise
htb_tail = HTB_TAIL = KernelFunction(
    "htb_tail",
    lambda attn, shortcut, *weights: _htb_tail_cuda(attn, shortcut, weights, stats=False),
    lambda *args: _tail_plain(*args), card_only=True)


def htb_tail_stats(attn, shortcut, ln1_s, ln1_b, w1, b1, dw, dwb, w2, b2,
                   ln2_s, ln2_b):
    """``htb_tail`` that also returns the next block's SCA statistics:
    (out, (cmean, cmax, ssum, smax)), as ``stats_reference(out)``.  The
    kernel has no backward: on a CUDA tensor, inputs that need a gradient
    raise."""
    weights = (ln1_s, ln1_b, w1, b1, dw, dwb, w2, b2, ln2_s, ln2_b)
    if runs_plain(shortcut):
        out = _tail_plain(attn, shortcut, *weights)
        return out, stats_reference(out)
    if needs_grad(attn, shortcut, weights):
        raise RuntimeError("htb_tail_stats has no backward: train through htb_tail "
                           "(the model's forward with deterministic=False)")
    return _htb_tail_cuda(attn, shortcut, weights, stats=True)
