"""Overlap-tiled arbitrary-resolution inference, and the whole-image
forward with the x4 head streamed over feature-row bands (ports of
``sisr_tpu/parallel/tiling.py::TiledSR`` and ``::BandedHeadSR``).

Tiles start at ``tile_positions`` (stride ``tile - overlap``, the last one
snapped to the border), run through the model ``chunk`` at a time, and are
accumulated into a canvas; the canvas is divided by a weight map that counts
how many tiles cover each output pixel.  A tile of 192 is the lcm of the
4..64 window ladder, so no attention block pads inside a tile.  Images
smaller than the tile are padded up (reflect, or symmetric for tiny
inputs), run, and cropped.  ``BandedHeadSR`` is described in its class.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Tuple, Union

import numpy as np
import torch

from sisr_tpu_torch.ops.kernels.conv3x3 import tail_pack_group
from sisr_tpu_torch.ops.windows import pad_hw


def tile_positions(length: int, tile: int, overlap: int) -> List[int]:
    """Start offsets covering [0, length) with `tile`-sized windows."""
    if length <= tile:
        return [0]
    stride = tile - overlap
    starts = list(range(0, length - tile, stride))
    starts.append(length - tile)
    return starts


def _pad_bottom_right(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(H, W, C) padded by ph rows and pw columns: reflect, or symmetric
    where reflect cannot (a pad not smaller than the side)."""
    if not (ph or pw):
        return img
    h, w = img.shape[:2]
    mode = "reflect" if (ph < h and pw < w) else "symmetric"
    return pad_hw(img, ph, pw, mode, axes=(0, 1))


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
        img = _pad_bottom_right(img, ph, pw)
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


class BandedHeadSR:
    """Whole-image forward with the x4 head streamed over feature-row bands.

    The body runs whole (``stage='features'``); the nearest+conv head
    (``stage='head'``) runs over bands of ``band_rows`` feature rows plus a
    ``HALO`` of 2 on each side, the head's receptive radius (3x3 convs at
    scales 1, 2, 4, 4), so the result equals the whole forward.  Image
    borders land on band edges (the first and last band take no halo past
    them): the head zero-pads its 2x and 4x maps there.  Three forms:

    - one call, when h <= band_rows + 4;
    - stacked: the 4-multiple divisor of h in [band_rows/2, 2*band_rows]
      nearest the target (ties to the larger) tiles [0, h) exactly, and the
      kept bands are concatenated;
    - canvas: otherwise kept regions start every band_rows rows, the last
      snapped to h - band_rows (as ``tile_positions``), and overwrite a
      canvas where they overlap.

    Where 4*w is a multiple of 16 the head writes its packed layout
    (``conv3x3_shuffled_tail_packed``), reshaped to the frame at the end.
    ``align`` reflect-pads the input to multiples of itself first (the
    output is cropped back).  JAX's ``SISR_HEAD_PACK`` and
    ``SISR_HEAD_UNROLL`` (the ``lax.scan`` unroll) have no meaning in eager
    PyTorch and are left out; the head always packs where it can.
    """

    HALO = 2

    def __init__(self, model, band_rows: int = 120,
                 out_dtype: torch.dtype = torch.float32, align: int = 0):
        if band_rows % 4:
            raise ValueError(f"band_rows must be a multiple of 4, got {band_rows}")
        self.model = model
        self.band_rows = band_rows
        self.out_dtype = out_dtype
        self.align = align
        self._packed = None

    def _head_model(self, packed: bool):
        """The model itself, or a shallow copy sharing its modules with
        ``head_packed`` set (JAX's ``model.clone(head_packed=True)``)."""
        if not packed or self.model.head_packed:
            return self.model
        if self._packed is None:
            self._packed = copy.copy(self.model)
            self._packed.head_packed = True
        return self._packed

    def plan(self, h: int, w: int):
        """(form, kept-region height, [(band start, kept start), ...],
        packed) for an (aligned) h x w input."""
        halo, tb = self.HALO, self.band_rows
        packed = (self.model.upscale * w) % tail_pack_group() == 0
        if h <= tb + 2 * halo:
            return "single", h, [(0, 0)], packed
        divs = [d for d in range(4, h - 2 * halo + 1, 4)
                if h % d == 0 and tb // 2 <= d <= 2 * tb]
        if divs:
            tbe = min(divs, key=lambda d: (abs(d - tb), -d))
            kbs, form = list(range(0, h, tbe)), "stacked"
        else:
            tbe = tb
            kbs, form = list(range(0, h - tb, tb)) + [h - tb], "canvas"
        rows = tbe + 2 * halo
        return form, tbe, [(min(max(kb - halo, 0), h - rows), kb) for kb in kbs], packed

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """img (H, W, 3) in [0,1] -> (H*scale, W*scale, 3) in out_dtype."""
        h, w = img.shape[:2]
        ph = (-h) % self.align if self.align else 0
        pw = (-w) % self.align if self.align else 0
        img = _pad_bottom_right(img, ph, pw)
        hh, ww = img.shape[:2]
        s, halo = self.model.upscale, self.HALO
        form, tbe, pos, packed = self.plan(hh, ww)
        hmodel = self._head_model(packed)
        feat = self.model(img[None], stage="features")
        if form == "single":
            out = hmodel(feat, stage="head")[0].to(self.out_dtype)
        else:
            rows = tbe + 2 * halo
            kept = []
            for st, kb in pos:
                sr = hmodel(feat[:, st:st + rows], stage="head")
                kept.append((kb, sr[0, s * (kb - st):s * (kb - st + tbe)].to(self.out_dtype)))
            if form == "stacked":
                out = torch.cat([k for _, k in kept])
            else:
                out = torch.empty((s * hh,) + tuple(kept[0][1].shape[1:]),
                                  dtype=self.out_dtype, device=feat.device)
                for kb, k in kept:
                    out[s * kb:s * (kb + tbe)] = k
        # the packed rows (W/16, 16*C) are the frame's rows in the same order
        out = out.reshape(s * hh, s * ww, -1)
        return out[:s * h, :s * w]
