"""Pixel shuffle on NHWC with torch channel ordering (reference
models/hit_sir_pro.py:1024-1062)."""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W, C*r^2) -> (B, H*r, W*r, C); channel ``c*r*r + i*r + j`` goes
    to spatial offset (i, j) of output channel ``c``, as ``nn.PixelShuffle``."""
    b, h, w, crr = x.shape
    c = crr // (factor * factor)
    x = x.reshape(b, h, w, c, factor, factor)
    x = x.permute(0, 1, 4, 2, 5, 3)  # b, h, r_i, w, r_j, c
    return x.reshape(b, h * factor, w * factor, c)
