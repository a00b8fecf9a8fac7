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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.dwconv import depthwise_conv_reference

K = 5
# the kernel's output tile (csrc/htb_tail.cu TH x TW)
_TILE = 8
_MAX_C = 192


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
                       w2, b2, ln2_s, ln2_b):
    """Plain version.  attn/shortcut: (B, H, W, C); w1: (C, Ch);
    dw: (5, 5, Ch); w2: (Ch, C)."""
    dt = attn.dtype
    x = shortcut + layer_norm(attn, ln1_s, ln1_b)
    h = F.gelu(x @ w1.to(dt) + b1.to(dt))
    h2 = h + F.gelu(depthwise_conv_reference(h, dw.to(dt), dwb.to(dt)))
    y = h2 @ w2.to(dt) + b2.to(dt)
    return x + layer_norm(y, ln2_s, ln2_b)


def stats_reference(out):
    """(cmean (B,H,W), cmax (B,H,W), ssum (B,C), smax (B,C)), all float32:
    the channel mean/max maps feed the next block's SCA patch build, the
    spatial sum/max its squeeze-excite pools."""
    of = out.to(torch.float32)
    return of.mean(-1), of.amax(-1), of.sum((1, 2)), of.amax((1, 2))


def _tail_buffers(b, h, w, c, ch, dt, dev, stats: bool):
    """The tail stage's device buffers: h = gelu(fc1), which passes between
    the two launches, and the statistics (cmean, cmax, and the per-tile
    partials psum, pmax), all None without ``stats``."""
    hbuf = torch.empty((b, h, w, ch), dtype=dt, device=dev)
    if not stats:
        return hbuf, (None,) * 4
    f32 = torch.float32
    tiles = -(-h // _TILE) * -(-w // _TILE)
    return hbuf, (torch.empty((b, h, w), dtype=f32, device=dev),
                  torch.empty((b, h, w), dtype=f32, device=dev),
                  torch.empty((b, tiles, c), dtype=f32, device=dev),
                  torch.empty((b, tiles, c), dtype=f32, device=dev))


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
    hbuf, (cmean, cmax, psum, pmax) = _tail_buffers(b, h, w, c, ch, dt, dev, stats)
    lib = build.library("htb_tail")
    fn = lib.htb_tail_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 18
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    code = fn(build.DTYPE_CODES[dt], build.ptr(attn), build.ptr(shortcut),
              *[build.ptr(t) for t in weights], build.ptr(out),
              build.ptr(cmean), build.ptr(cmax), build.ptr(psum),
              build.ptr(pmax), build.ptr(hbuf), attn.stride(0), attn.stride(1),
              b, h, w, c, ch, build.stream(dev))
    build.raise_on_error("htb_tail", code)
    build.launches["htb_tail"] += 1
    if not stats:
        return out
    build.launches["htb_tail_stats"] += 1
    return out, (cmean, cmax, psum.sum(dim=1), pmax.amax(dim=1))


def htb_tail(attn, shortcut, ln1_s, ln1_b, w1, b1, dw, dwb, w2, b2,
             ln2_s, ln2_b, reference: bool = False):
    """Fused HTB tail; see the module docstring.  A CPU tensor runs the
    plain version; a CUDA tensor the kernel unless ``reference=True``."""
    weights = (ln1_s, ln1_b, w1, b1, dw, dwb, w2, b2, ln2_s, ln2_b)
    h, w = shortcut.shape[1:3]
    if reference or shortcut.device.type == "cpu":
        return htb_tail_reference(attn[:, :h, :w], shortcut, *weights)
    return _htb_tail_cuda(attn, shortcut, weights, stats=False)


def htb_tail_stats(attn, shortcut, ln1_s, ln1_b, w1, b1, dw, dwb, w2, b2,
                   ln2_s, ln2_b, reference: bool = False):
    """``htb_tail`` that also returns the next block's SCA statistics:
    (out, (cmean, cmax, ssum, smax)), as ``stats_reference(out)``."""
    weights = (ln1_s, ln1_b, w1, b1, dw, dwb, w2, b2, ln2_s, ln2_b)
    h, w = shortcut.shape[1:3]
    if reference or shortcut.device.type == "cpu":
        out = htb_tail_reference(attn[:, :h, :w], shortcut, *weights)
        return out, stats_reference(out)
    return _htb_tail_cuda(attn, shortcut, weights, stats=True)
