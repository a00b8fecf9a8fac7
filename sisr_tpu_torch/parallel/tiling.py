"""Overlap-tiled arbitrary-resolution inference (port of
``sisr_tpu/parallel/tiling.py::TiledSR``).

Tiles start at ``tile_positions`` (stride ``tile - overlap``, the last one
snapped to the border), run through the model ``chunk`` at a time, and are
accumulated into a canvas; the canvas is divided by a weight map that counts
how many tiles cover each output pixel.  A tile of 192 is the lcm of the
4..64 window ladder, so no attention block pads inside a tile.  Images
smaller than the tile are padded up (reflect, or symmetric for tiny
inputs), run, and cropped.
"""

from __future__ import annotations

from typing import Callable, List, Tuple, Union

import numpy as np
import torch

from sisr_tpu_torch.ops.windows import pad_hw


def tile_positions(length: int, tile: int, overlap: int) -> List[int]:
    """Start offsets covering [0, length) with `tile`-sized windows."""
    if length <= tile:
        return [0]
    stride = tile - overlap
    starts = list(range(0, length - tile, stride))
    starts.append(length - tile)
    return starts


class TiledSR:
    """Callable running ``model_apply`` over overlapping tiles of one image.

    model_apply: (k, th, tw, 3) NHWC tensor -> (k, th*s, tw*s, 3).
    ``tile`` is an int (square tiles) or an (th, tw) pair.
    """

    def __init__(self, model_apply: Callable, scale: int,
                 tile: Union[int, Tuple[int, int]] = 192,
                 overlap: int = 16, chunk: int = 1,
                 out_dtype: torch.dtype = torch.float32):
        self.model_apply = model_apply
        self.scale = scale
        self.tile_h, self.tile_w = ((tile, tile) if isinstance(tile, int)
                                    else (int(tile[0]), int(tile[1])))
        self.overlap = overlap
        self.chunk = chunk
        self.out_dtype = out_dtype

    def _positions(self, h: int, w: int) -> np.ndarray:
        pos = np.asarray([(y, x)
                          for y in tile_positions(h, self.tile_h, self.overlap)
                          for x in tile_positions(w, self.tile_w, self.overlap)],
                         dtype=np.int64)
        # pad to a chunk multiple by repeating the last tile; the weight map
        # counts duplicates so the overlap average stays exact
        pad = (-len(pos)) % self.chunk
        if pad:
            pos = np.concatenate([pos, np.repeat(pos[-1:], pad, axis=0)])
        return pos

    def _weight_map(self, h: int, w: int, pos: np.ndarray) -> np.ndarray:
        s, th, tw = self.scale, self.tile_h, self.tile_w
        wmap = np.zeros((h * s, w * s, 1), dtype=np.float32)
        for y, x in pos:
            wmap[y * s:(y + th) * s, x * s:(x + tw) * s] += 1.0
        return 1.0 / wmap

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """img: (H, W, 3) in [0,1] -> (H*scale, W*scale, 3) in out_dtype."""
        h, w = img.shape[:2]
        ph = max(0, self.tile_h - h)
        pw = max(0, self.tile_w - w)
        if ph or pw:
            # reflect needs pad < dim; symmetric for tiny inputs
            mode = "reflect" if (ph < h and pw < w) else "symmetric"
            img = pad_hw(img, ph, pw, mode, axes=(0, 1))
        hh, ww = img.shape[:2]
        s, th, tw = self.scale, self.tile_h, self.tile_w
        pos = self._positions(hh, ww)
        inv_w = torch.as_tensor(self._weight_map(hh, ww, pos), device=img.device)
        out = torch.zeros((hh * s, ww * s, 3), dtype=self.out_dtype,
                          device=img.device)
        for yx in pos.reshape(-1, self.chunk, 2):
            patches = torch.stack([img[y:y + th, x:x + tw] for y, x in yx])
            sr = self.model_apply(patches).to(self.out_dtype)
            for i, (y, x) in enumerate(yx):
                out[y * s:(y + th) * s, x * s:(x + tw) * s] += sr[i]
        out = out * inv_w
        if ph or pw:
            out = out[: h * s, : w * s]
        return out
