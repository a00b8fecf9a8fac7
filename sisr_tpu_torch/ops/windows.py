"""Reflect padding on NHWC maps (reference models/hit_sir_pro.py:664-674).

Padding is an index gather, so it agrees with ``numpy.pad`` for any pad
width, including pads wider than the map (where ``F.pad`` refuses).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sisr_tpu_torch.utils.constants import device_constant


def pad_index(n: int, total: int, mode: str = "reflect") -> torch.Tensor:
    """Source rows of a length-``n`` axis padded at its end to ``total``,
    as ``numpy.pad`` picks them: ``reflect`` excludes the edge sample,
    ``symmetric`` repeats it."""
    i = torch.arange(total)
    if mode == "reflect":
        if n == 1:
            return torch.zeros(total, dtype=torch.long)
        period = 2 * n - 2
        j = i % period
        return torch.where(j < n, j, period - j)
    if mode == "symmetric":
        j = i % (2 * n)
        return torch.where(j < n, j, 2 * n - 1 - j)
    raise ValueError(f"unknown pad mode {mode!r}")


def pad_hw(x: torch.Tensor, pad_h: int, pad_w: int,
           mode: str = "reflect", axes: Tuple[int, int] = (1, 2)) -> torch.Tensor:
    """Pad the bottom/right of the two spatial ``axes`` of ``x``."""
    ah, aw = axes
    h, w = x.shape[ah], x.shape[aw]
    if pad_h:
        x = x.index_select(ah, device_constant(pad_index, (h, h + pad_h, mode),
                                               torch.long, x.device))
    if pad_w:
        x = x.index_select(aw, device_constant(pad_index, (w, w + pad_w, mode),
                                               torch.long, x.device))
    return x


def pad_to_multiple(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Reflect-pad the bottom/right of (B, H, W, C) so H, W divide the window."""
    _, h, w, _ = x.shape
    pad_h = (window[0] - h % window[0]) % window[0]
    pad_w = (window[1] - w % window[1]) % window[1]
    return pad_hw(x, pad_h, pad_w)
