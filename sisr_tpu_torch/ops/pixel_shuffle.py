"""Pixel shuffle on NHWC: torch's channel order (the pixel-shuffle heads)
and the packed x4 head's phase-major order."""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W, C*r^2) -> (B, H*r, W*r, C) in torch ``nn.PixelShuffle``'s
    channel order: channel ``c*r*r + i*r + j`` goes to spatial offset
    (i, j) of output channel ``c`` (reference models/hit_sir_pro.py:1024-1062)."""
    b, h, w, crr = x.shape
    c = crr // (factor * factor)
    x = x.reshape(b, h, w, c, factor, factor)
    x = x.permute(0, 1, 4, 2, 5, 3)            # b, h, r_i, w, r_j, c
    return x.reshape(b, h * factor, w * factor, c)


def pixel_shuffle_phase_major(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W, r^2*C) -> (B, H*r, W*r, C) with column-phase-major
    channels: channel ``(j*r + i)*C + c`` goes to spatial offset (i, j) of
    output channel ``c``.  The layout of the packed x4 head, whose convs
    read it without materializing the shuffle."""
    b, h, w, rrc = x.shape
    c = rrc // (factor * factor)
    x = x.reshape(b, h, w, factor, factor, c)  # b, h, w, r_j, r_i, c
    x = x.permute(0, 1, 4, 2, 3, 5)            # b, h, r_i, w, r_j, c
    return x.reshape(b, h * factor, w * factor, c)
