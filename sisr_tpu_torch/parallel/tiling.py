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

Both have a ``sharded_call`` over a ``parallel/mesh.py::Mesh`` (JAX's
``shard_map`` forms): each rank runs its share of the tiles or head bands
into a local canvas, one ``all_reduce`` sums the canvases, and every rank
returns the whole image.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Tuple, Union

import numpy as np
import torch

from sisr_tpu_torch.ops.kernels.autograd import replayed_forwards
from sisr_tpu_torch.ops.kernels.conv3x3 import tail_pack_group
from sisr_tpu_torch.ops.windows import pad_hw
from sisr_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from sisr_tpu_torch.utils.profiling import span


def tile_positions(length: int, tile: int, overlap: int) -> List[int]:
    """Start offsets covering [0, length) with `tile`-sized windows."""
    if length <= tile:
        return [0]
    stride = tile - overlap
    starts = list(range(0, length - tile, stride))
    starts.append(length - tile)
    return starts


def _axis_size(mesh: Mesh, axis: str) -> int:
    """The mesh's size along ``axis``, its one axis (JAX's ``mesh.shape[axis]``)."""
    if axis != mesh.axis_name:
        raise KeyError(f"the mesh's axis is {mesh.axis_name!r}, not {axis!r}")
    return mesh.size


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
    ``tile`` is an int (square tiles) or an (th, tw) pair.  A request runs
    inside a ``sisr.tiler`` span, each ``model_apply`` call inside a
    ``sisr.tiler.model`` span and inside ``replayed_forwards()``: every tile
    has one input signature, so the port's models capture their forward as a
    CUDA graph at the second tile and replay it from the third on
    (``ops/kernels/autograd.py::replayed_forward``).
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

    def _canvas(self, img: torch.Tensor, pos: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """The tiles at ``pos`` (a chunk multiple) run and summed into a
        zero ``dtype`` canvas of the whole output."""
        s, th, tw = self.scale, self.tile_h, self.tile_w
        hh, ww = img.shape[:2]
        out = torch.zeros((hh * s, ww * s, 3), dtype=dtype, device=img.device)
        for yx in pos.reshape(-1, self.chunk, 2):
            patches = torch.stack([img[y:y + th, x:x + tw] for y, x in yx])
            with span("tiler.model"), replayed_forwards():
                sr = self.model_apply(patches)
            sr = sr.to(dtype)
            for i, (y, x) in enumerate(yx):
                out[y * s:(y + th) * s, x * s:(x + tw) * s] += sr[i]
        return out

    def _padded(self, img: torch.Tensor):
        h, w = img.shape[:2]
        ph, pw = max(0, self.tile_h - h), max(0, self.tile_w - w)
        return _pad_bottom_right(img, ph, pw), h, w

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """img: (H, W, 3) in [0,1] -> (H*scale, W*scale, 3) in out_dtype."""
        with span("tiler"):
            img, h, w = self._padded(img)
            hh, ww = img.shape[:2]
            pos = self._positions(hh, ww)
            inv_w = torch.as_tensor(self._weight_map(hh, ww, pos), device=img.device)
            out = self._canvas(img, pos, self.out_dtype) * inv_w
            return out[: h * self.scale, : w * self.scale]

    def sharded_positions(self, h: int, w: int, n_dev: int) -> np.ndarray:
        """The tile positions padded to a multiple of ``n_dev * chunk`` by
        repeating the last tile; rank r takes the r-th of ``n_dev`` equal
        runs (JAX ``_build_sharded``)."""
        pos = self._positions(h, w)
        per = -(-len(pos) // (n_dev * self.chunk)) * self.chunk
        pad = per * n_dev - len(pos)
        if pad:
            pos = np.concatenate([pos, np.repeat(pos[-1:], pad, axis=0)])
        return pos

    def sharded_call(self, img: torch.Tensor, mesh: Mesh, axis: str = "tile") -> torch.Tensor:
        """Tile-sharded inference: each rank runs its run of
        ``sharded_positions`` into a local float32 canvas, one all_reduce
        sums them, and the sum is divided by the weight map, which counts
        the repeated tiles.  (H, W, 3) -> (H*scale, W*scale, 3), whole on
        every rank, in float32 as ``__call__``'s (its ``out_dtype`` canvas
        times the float32 weight map)."""
        n_dev = _axis_size(mesh, axis)
        with span("tiler"):
            img, h, w = self._padded(img)
            hh, ww = img.shape[:2]
            pos = self.sharded_positions(hh, ww, n_dev)
            per = len(pos) // n_dev
            inv_w = torch.as_tensor(self._weight_map(hh, ww, pos), device=img.device)
            out = self._canvas(img, pos[mesh.rank * per:(mesh.rank + 1) * per], torch.float32)
            out = all_reduce_sum(mesh, out) * inv_w
            return out[: h * self.scale, : w * self.scale]


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
    output is cropped back).  ``sharded_call`` splits the bands over a
    mesh's ranks on a plan of its own (``sharded_plan``).  JAX's ``SISR_HEAD_PACK`` and
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

    def sharded_plan(self, h: int, n_dev: int):
        """(kept-region height, band rows, [(band start, kept start,
        valid), ...]) of ``sharded_call`` for an h-row feature map (h a
        multiple of 4) over ``n_dev`` ranks (JAX ``_build_sharded``): the
        largest 4-multiple divisor of h no larger than ``band_rows``, so the
        kept regions tile [0, h) with no overlap, and band 0 repeated with
        ``valid`` 0 to fill ``n_dev`` equal runs."""
        if h % 4:
            raise ValueError(f"the sharded banded head needs a 4-multiple feature height, "
                             f"got {h}")
        halo = self.HALO
        tbe = max(d for d in range(4, h + 1, 4) if h % d == 0 and d <= max(self.band_rows, 4))
        rows = min(tbe + 2 * halo, h)
        kbs = list(range(0, h, tbe))
        per = -(-len(kbs) // n_dev)
        pos = [(min(max(kb - halo, 0), h - rows), kb, 1) for kb in kbs]
        pos += [(pos[0][0], pos[0][1], 0)] * (per * n_dev - len(pos))
        return tbe, rows, pos

    def sharded_call(self, img: torch.Tensor, mesh: Mesh, axis: str = "band") -> torch.Tensor:
        """Band-sharded whole-image SR, (H, W, 3) -> (H*scale, W*scale, 3)
        in out_dtype, whole on every rank.  The input is aligned to
        ``max(align, 4)``; the body runs whole on every rank (its output
        feeds every band); rank r runs the r-th run of ``sharded_plan``'s
        bands into a local canvas, a pad slot's band times its zero
        ``valid``; one all_reduce sums the canvases, whose kept regions are
        disjoint, so the sum is exact."""
        n_dev = _axis_size(mesh, axis)
        h, w = img.shape[:2]
        align = max(self.align, 4)
        img = _pad_bottom_right(img, (-h) % align, (-w) % align)
        hh, ww = img.shape[:2]
        s = self.model.upscale
        tbe, rows, pos = self.sharded_plan(hh, n_dev)
        per = len(pos) // n_dev
        hmodel = self._head_model((s * ww) % tail_pack_group() == 0)
        feat = self.model(img[None], stage="features")
        canvas = None
        for st, kb, valid in pos[mesh.rank * per:(mesh.rank + 1) * per]:
            sr = hmodel(feat[:, st:st + rows], stage="head")
            kept = sr[0, s * (kb - st):s * (kb - st + tbe)].to(self.out_dtype) * valid
            if canvas is None:
                canvas = torch.zeros((s * hh,) + tuple(kept.shape[1:]), dtype=self.out_dtype,
                                     device=feat.device)
            canvas[s * kb:s * (kb + tbe)] += kept
        out = all_reduce_sum(mesh, canvas).reshape(s * hh, s * ww, -1)
        return out[:s * h, :s * w]
