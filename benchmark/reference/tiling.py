"""Overlap tiling of one image, as the program's tiled entry plans it: a
frozen copy of the plan (tiles of ``tile`` at stride ``tile - overlap``,
the last snapped to the border; an image smaller than a tile padded at its
bottom and right, reflect or else symmetric) and the plain average of the
overlapping tiles' outputs."""

from __future__ import annotations

from typing import Callable, List

import torch


def tile_positions(length: int, tile: int, overlap: int) -> List[int]:
    if length <= tile:
        return [0]
    starts = list(range(0, length - tile, tile - overlap))
    starts.append(length - tile)
    return starts


def _pad_index(n: int, total: int, reflect: bool, device) -> torch.Tensor:
    i = torch.arange(total, device=device)
    if reflect:
        j = i % (2 * n - 2)
        return torch.where(j < n, j, 2 * n - 2 - j)
    j = i % (2 * n)
    return torch.where(j < n, j, 2 * n - 1 - j)


def tiled(fn: Callable, img: torch.Tensor, scale: int, tile: int, overlap: int) -> torch.Tensor:
    """fn: (1, t, t, 3) -> (1, t*scale, t*scale, 3); img (H, W, 3)."""
    h, w = img.shape[:2]
    ph, pw = max(0, tile - h), max(0, tile - w)
    if ph or pw:
        reflect = ph < h and pw < w
        if ph:
            img = img.index_select(0, _pad_index(h, h + ph, reflect, img.device))
        if pw:
            img = img.index_select(1, _pad_index(w, w + pw, reflect, img.device))
    hh, ww = img.shape[:2]
    out = torch.zeros(hh * scale, ww * scale, 3, dtype=torch.float32, device=img.device)
    count = torch.zeros(hh * scale, ww * scale, 1, dtype=torch.float32, device=img.device)
    for y in tile_positions(hh, tile, overlap):
        for x in tile_positions(ww, tile, overlap):
            sr = fn(img[None, y:y + tile, x:x + tile])[0]
            out[y * scale:(y + tile) * scale, x * scale:(x + tile) * scale] += sr
            count[y * scale:(y + tile) * scale, x * scale:(x + tile) * scale] += 1.0
    return (out / count)[:h * scale, :w * scale]
