"""The bundled CUDA ops of the reference's StyleGAN2-class toolkits, in
plain PyTorch (port of ``sisr_tpu/ops/stylegan_ops.py``).  None is
reachable from the SR application; they are library surface:

* fused bias + LeakyReLU (BasicSR fused_act/src/fused_bias_act.cpp);
* upfirdn2d (BasicSR upfirdn2d/src/upfirdn2d.cpp): upsample, FIR filter,
  downsample, as one depthwise convolution over the zero-stuffed input.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def fused_bias_leaky_relu(x: torch.Tensor, bias: torch.Tensor,
                          negative_slope: float = 0.2,
                          scale: float = 2.0 ** 0.5) -> torch.Tensor:
    """LeakyReLU(x + bias) * scale on NHWC input (bias over channels)."""
    return F.leaky_relu(x + bias, negative_slope) * scale


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Upsample by ``up`` (``up - 1`` zeros AFTER each sample), FIR-filter with
    the 2-D ``kernel`` (depthwise, a true convolution: the kernel flipped,
    as BasicSR's op, basicsr/ops/upfirdn2d/upfirdn2d.py:162-192), pad
    ``pad`` on both sides of each axis, downsample by ``down``.  NHWC."""
    b, h, w, c = x.shape
    kh, kw = kernel.shape
    xs = x.new_zeros((b, h * up, w * up, c))
    xs[:, ::up, ::up] = x
    pad0, pad1 = pad
    xs = F.pad(xs.permute(0, 3, 1, 2), (pad0, pad1, pad0, pad1))
    weight = kernel.flip((0, 1)).to(x.dtype).expand(c, 1, kh, kw)
    return F.conv2d(xs, weight, stride=down, groups=c).permute(0, 2, 3, 1)
