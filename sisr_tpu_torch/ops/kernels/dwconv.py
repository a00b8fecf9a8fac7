"""5x5 depthwise conv + bias, NHWC, zero same-padding: the plain version of
``sisr_tpu/ops/pallas/dwconv.py::depthwise_conv_reference``.  The model
runs it inside the HTB-tail kernel (``ffn.py``), never on its own."""

from __future__ import annotations

import torch
import torch.nn.functional as F

K = 5


def depthwise_conv_reference(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), w (5, 5, C), b (C,) -> (B, H, W, C)."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1),
                 padding=K // 2, groups=c)
    return y.permute(0, 2, 3, 1) + b
