"""5x5 depthwise conv + bias, NHWC, stride 1, zero same-padding.

Port of ``sisr_tpu/ops/pallas/dwconv.py``: ``dwconv5x5`` over the plain
version ``depthwise_conv_reference`` and the CUDA kernel ``csrc/dwconv.cu``.
Its backward is the JAX ``custom_vjp``'s: dx is the same kernel on dy with
the filter flipped in both spatial axes and no bias (one launch: the kernel
reads the filter flipped, ``flip=True``, and takes a null bias); dw and db
are plain float32 reductions.  The model's forward runs the conv inside the
HTB-tail kernel (``ffn.py``); training runs this one in the tail's
backward.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.autograd import KernelFunction

K = 5


def depthwise_conv_reference(x: torch.Tensor, w: torch.Tensor, b=None,
                             flip: bool = False) -> torch.Tensor:
    """x (B, H, W, C), w (5, 5, C), b (C,) or None -> (B, H, W, C).
    ``flip``: tap (i, j) reads w[4 - i, 4 - j], the filter flipped in both
    spatial axes (the kernel's flag of the same name)."""
    c = x.shape[-1]
    if flip:
        w = w.flip((0, 1))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1),
                 padding=K // 2, groups=c).permute(0, 2, 3, 1)
    return y if b is None else y + b


def _dwconv_cuda(x, w, b, flip: bool):
    bsz, h, wd, c = x.shape
    if tuple(w.shape) != (K, K, c) or (b is not None and tuple(b.shape) != (c,)):
        raise ValueError(f"dwconv5x5: w {tuple(w.shape)} / b "
                         f"{None if b is None else tuple(b.shape)} do not fit C={c}")
    build.check_cuda("dwconv5x5", x.device, x.dtype, x=x, w=w, b=b)
    y = torch.empty_like(x)
    fn = build.library("dwconv").dwconv5x5_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    code = fn(build.DTYPE_CODES[x.dtype], build.ptr(x), build.ptr(w), build.ptr(b),
              build.ptr(y), bsz, h, wd, c, int(flip), build.stream(x.device))
    build.raise_on_error("dwconv5x5", code)
    build.launches["dwconv5x5"] += 1
    return y


def _kernel(x, w, b=None, flip: bool = False):
    """The kernel with the plain version's signature."""
    dt = x.dtype
    return _dwconv_cuda(x, build.as_arg(w, dt), build.as_arg(b, dt), flip)


def dwconv_vjp(kernel, leaves, need, grads):
    """(dx, dw, db) as the JAX ``_dwconv_bwd``: dx = kernel(dy, w, no bias,
    flip=True), one call of ``kernel`` (the kernel or the plain version);
    dw[i, j, c] = sum over (b, y, x) of xpad[b, y+i, x+j, c] * dy[b, y, x, c]
    and db, in float32, cast to w's and dy's types."""
    x, w, _ = leaves
    (dy,) = grads
    dx = dw = db = None
    if need[0]:
        dx = kernel(dy.contiguous(), w, None, True)
    if need[1]:
        f32 = torch.float32
        h, wd = dy.shape[1:3]
        xp = F.pad(x.to(f32), (0, 0, K // 2, K // 2, K // 2, K // 2))
        dyf = dy.to(f32)
        dw = torch.stack([(xp[:, i:i + h, j:j + wd] * dyf).sum(dim=(0, 1, 2))
                          for i in range(K) for j in range(K)])
        dw = dw.reshape(K, K, -1).to(w.dtype)
    if need[2]:
        db = dy.sum(dim=(0, 1, 2), dtype=torch.float32).to(dy.dtype)
    return dx, dw, db


DWCONV5X5 = KernelFunction(_kernel, depthwise_conv_reference, vjp=dwconv_vjp)


def dwconv5x5(x, w, b, reference: bool = False):
    """5x5 depthwise conv + bias: x (B, H, W, C), w (5, 5, C), b (C,).  A
    CPU tensor runs the plain version; a CUDA tensor the kernel (and the
    kernel again for dx in backward) unless ``reference=True``."""
    if reference or x.device.type == "cpu":
        return depthwise_conv_reference(x, w, b)
    return DWCONV5X5(x, w, b)
