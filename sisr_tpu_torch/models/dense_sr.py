"""Residual-dense super-resolution model for the ``DenseModelConfig``
surface (port of ``sisr_tpu/models/dense_sr.py``; the reference ships the
config but no model):

  shallow extract (MultipleSizeConvExtract or 3x3 conv) ->
  groups of dense blocks with optional long skips ->
  optional SpatialChannelAttention ->
  deep/shallow Fusion gate (its two CUDA kernels on a card) ->
  x`scale` pixel-shuffle reconstruction.

Activations are NHWC in [0, 1]; the convs are plain ``F.conv2d``, as JAX
computes them outside its kernels.  The parameters are drawn from flax's
defaults (``arch_util.flax_init_``), so a fresh model starts where the JAX
package's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sisr_tpu_torch.models.arch_util import conv_nhwc, flax_init_
from sisr_tpu_torch.models.hit_sir_pro import (Fusion, MultipleSizeConvExtract,
                                               SpatialChannelAttention)
from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle


class DenseBlock(nn.Module):
    """Growth-concat dense block with local feature fusion + residual."""

    def __init__(self, channels: int, growth: int = 32, layers: int = 4):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"conv{i}", nn.Conv2d(channels + i * growth, growth, 3, padding=1))
        self.lff = nn.Conv2d(channels + layers * growth, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(self.layers):
            h = conv_nhwc(torch.cat(feats, dim=-1), getattr(self, f"conv{i}"))
            feats.append(F.leaky_relu(h, 0.2))
        return x + 0.2 * conv_nhwc(torch.cat(feats, dim=-1), self.lff)


class DenseSR(nn.Module):
    """RDN-style x``scale`` SR; NHWC input in [0, 1].  ``forward`` takes the
    port's ``reference`` (the Fusion gate's plain version on a card),
    ``deterministic`` and ``generator`` (no layer draws random numbers)."""

    def __init__(self, is_sa_attn: bool = False, is_fusion: bool = False,
                 is_mult_size_conv_feat_extract: bool = False,
                 num_blocks: Sequence[int] = (4, 4), skip_blocks: Optional[Sequence[int]] = None,
                 middle_channels: int = 64, in_channel: int = 3, scale: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = middle_channels
        self.num_blocks = tuple(num_blocks)
        self.skip_blocks = tuple(skip_blocks or ())
        self.scale = scale
        self.dtype = dtype
        self.conv_first = (MultipleSizeConvExtract(in_channel, c) if is_mult_size_conv_feat_extract
                           else nn.Conv2d(in_channel, c, 3, padding=1))
        for gi, blocks in enumerate(self.num_blocks):
            for bi in range(blocks):
                self.add_module(f"group{gi}_block{bi}", DenseBlock(c))
        self.gff1 = nn.Conv2d(c * len(self.num_blocks), c, 1)
        self.gff2 = nn.Conv2d(c, c, 3, padding=1)
        self.sa_attn = SpatialChannelAttention(c) if is_sa_attn else None
        self.fusion = Fusion(c) if is_fusion else None
        self.upsample = nn.Conv2d(c, scale * scale * in_channel, 3, padding=1)
        flax_init_(self)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        if isinstance(self.conv_first, MultipleSizeConvExtract):
            shallow = self.conv_first(x, dt)
        else:
            shallow = conv_nhwc(x, self.conv_first)

        feat, group_outputs = shallow, []
        for gi, blocks in enumerate(self.num_blocks):
            for bi in range(blocks):
                feat = getattr(self, f"group{gi}_block{bi}")(feat)
            group_outputs.append(feat)
            if gi in self.skip_blocks:
                feat = feat + shallow       # long skip at the configured groups

        # global feature fusion over the group outputs
        feat = conv_nhwc(conv_nhwc(torch.cat(group_outputs, dim=-1), self.gff1), self.gff2)
        if self.sa_attn is not None:
            feat = self.sa_attn(feat)
        feat = self.fusion(feat, shallow) if self.fusion is not None else feat + shallow
        return pixel_shuffle(conv_nhwc(feat, self.upsample), self.scale)
