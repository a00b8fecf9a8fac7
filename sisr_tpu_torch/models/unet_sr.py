"""UNet super-resolution model for the ``UNetModelConfig`` surface (port
of ``sisr_tpu/models/unet_sr.py``; the reference ships the config but no
model):

  shallow conv -> encoder (res blocks + optional self-attention, 2x down per
  stage) -> bottleneck -> decoder with skip concats -> x4 pixel-shuffle head,
  plus a global nearest-upsampled residual so the net learns the detail.

Activations are NHWC in [0, 1].  The layers are flax's as the JAX package
uses them, in plain PyTorch (JAX runs no kernel of its own here):
``GroupNorm`` over contiguous channel blocks with epsilon 1e-6,
``MultiHeadDotProductAttention`` as matmuls and a softmax over the whole
L x L score matrix (queries scaled by 1/sqrt(d); keys and values from the
same normed input), the transposed conv with flax's ``SAME`` padding
(torch's ``padding=1`` for a 4x4 kernel at stride 2; its kernel is flax's
flipped in space with in/out swapped, ``jax_port.unet_state_dict_from_jax``).
The parameters are drawn from flax's defaults (``arch_util.flax_init_``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sisr_tpu_torch.models.arch_util import conv_nhwc, flax_init_
from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from sisr_tpu_torch.ops.resize import nearest_upsample

GROUPS, GN_EPS = 8, 1e-6


def _group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """flax ``GroupNorm`` of an NHWC map: float32 statistics, x's dtype out."""
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), norm.num_groups, norm.weight, norm.bias,
                     norm.eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class ResBlock(nn.Module):
    """GroupNorm -> swish -> conv3x3, twice, plus the input (through a 1x1
    conv where the width changes)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(GROUPS, in_features, eps=GN_EPS)
        self.conv1 = nn.Conv2d(in_features, features, 3, padding=1)
        self.norm2 = nn.GroupNorm(GROUPS, features, eps=GN_EPS)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.skip = nn.Conv2d(in_features, features, 1) if in_features != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(F.silu(_group_norm(x, self.norm1)), self.conv1)
        h = conv_nhwc(F.silu(_group_norm(h, self.norm2)), self.conv2)
        return (x if self.skip is None else conv_nhwc(x, self.skip)) + h


class DotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` called as ``(y, y)``: query, key,
    value and out projections with biases (``Linear(C, C)``: the flax
    kernels (C, heads, d) and (heads, d, C) flattened to heads * d)."""

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(features, features))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        b, l, c = y.shape
        heads, dt = self.num_heads, y.dtype
        d = c // heads

        def proj(mod):
            return (y @ mod.weight.t().to(dt) + mod.bias.to(dt)).reshape(b, l, heads, d)

        q = proj(self.query) / math.sqrt(d)
        k, v = proj(self.key), proj(self.value)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        attn = torch.softmax(logits.float(), dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, l, c)
        return out @ self.out.weight.t().to(dt) + self.out.bias.to(dt)


class SelfAttention2D(nn.Module):
    """x + attention over all the map's pixels of GroupNorm(x)."""

    def __init__(self, features: int, num_heads: int = 1):
        super().__init__()
        self.norm = nn.GroupNorm(GROUPS, features, eps=GN_EPS)
        self.attn = DotProductAttention(features, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.attn(_group_norm(x, self.norm).reshape(b, h * w, c))
        return x + y.reshape(b, h, w, c)


class UNetSR(nn.Module):
    """x``upscale`` SR UNet; NHWC input in [0, 1] whose sides are multiples
    of 2^(len(ch_mults) - 1) (the skip concats need them; JAX fails there
    too).  ``forward`` takes the port's ``reference``, ``deterministic`` and
    ``generator``, which change nothing here (no kernel, no random draw)."""

    def __init__(self, image_in_channels: int = 3, n_channels: int = 64,
                 ch_mults: Sequence[int] = (1, 2, 1, 1),
                 is_attn: Sequence[bool] = (True, True, True, True), n_blocks: int = 2,
                 n_heads: int = 1, upscale: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ch_mults = tuple(ch_mults)
        self.is_attn = tuple(is_attn)
        self.n_blocks = n_blocks
        self.upscale = upscale
        self.dtype = dtype
        n = n_channels
        self.conv_in = nn.Conv2d(image_in_channels, n, 3, padding=1)
        cur, skips = n, [n]
        last = len(self.ch_mults) - 1
        for si, mult in enumerate(self.ch_mults):
            ch = n * mult
            for bi in range(n_blocks):
                self.add_module(f"down_{si}_{bi}", ResBlock(cur, ch))
                if self.is_attn[si]:
                    self.add_module(f"down_attn_{si}_{bi}", SelfAttention2D(ch, n_heads))
                cur = ch
                skips.append(ch)
            if si < last:
                self.add_module(f"down_sample_{si}", nn.Conv2d(ch, ch, 3, stride=2, padding=1))
        mid = n * self.ch_mults[-1]
        self.mid_1 = ResBlock(cur, mid)
        self.mid_attn = SelfAttention2D(mid, n_heads)
        self.mid_2 = ResBlock(mid, mid)
        cur = mid
        for si in reversed(range(len(self.ch_mults))):
            ch = n * self.ch_mults[si]
            if si < last:
                self.add_module(f"up_sample_{si}",
                                nn.ConvTranspose2d(cur, ch, 4, stride=2, padding=1))
                cur = ch
            for bi in range(n_blocks):
                self.add_module(f"up_{si}_{bi}", ResBlock(cur + skips.pop(), ch))
                if self.is_attn[si]:
                    self.add_module(f"up_attn_{si}_{bi}", SelfAttention2D(ch, n_heads))
                cur = ch
        self.final_skip = nn.Conv2d(skips.pop(), cur, 1)
        self.conv_out = nn.Conv2d(cur, upscale * upscale * image_in_channels, 3, padding=1)
        flax_init_(self)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        _, h, w, _ = x.shape
        step = 2 ** (len(self.ch_mults) - 1)
        if h % step or w % step:
            raise ValueError(f"UNetSR: the sides ({h}, {w}) must be multiples of {step} "
                             f"(len(ch_mults) - 1 = {len(self.ch_mults) - 1} halvings)")
        base = nearest_upsample(x, self.upscale)
        feat = conv_nhwc(x.to(self.dtype), self.conv_in)
        skips = [feat]
        last = len(self.ch_mults) - 1
        for si in range(len(self.ch_mults)):
            for bi in range(self.n_blocks):
                feat = getattr(self, f"down_{si}_{bi}")(feat)
                if self.is_attn[si]:
                    feat = getattr(self, f"down_attn_{si}_{bi}")(feat)
                skips.append(feat)
            if si < last:
                feat = conv_nhwc(feat, getattr(self, f"down_sample_{si}"))
        feat = self.mid_2(self.mid_attn(self.mid_1(feat)))
        for si in reversed(range(len(self.ch_mults))):
            if si < last:
                feat = conv_nhwc(feat, getattr(self, f"up_sample_{si}"))
            for bi in range(self.n_blocks):
                feat = getattr(self, f"up_{si}_{bi}")(torch.cat([feat, skips.pop()], dim=-1))
                if self.is_attn[si]:
                    feat = getattr(self, f"up_attn_{si}_{bi}")(feat)
        feat = feat + conv_nhwc(skips.pop(), self.final_skip)
        out = conv_nhwc(F.silu(feat), self.conv_out)
        return base + pixel_shuffle(out, self.upscale).to(base.dtype)
