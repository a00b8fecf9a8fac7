"""DAT, the Dual Aggregation Transformer for image super-resolution (Chen,
Zhang, Gu, Kong, Yang, Yu, "Dual Aggregation Transformer for Image
Super-Resolution", ICCV 2023, arXiv:2308.03364; zhengchen1999/DAT
``basicsr/archs/dat_arch.py``), on the port's kernels.

    input (B, H, W, 3) in [0, 1]
      -> (x - mean) * img_range -> conv_first = f -> LayerNorm (before_RG)
      -> len(depth) x [blocks, then a 3x3 conv added to the group's input]
      -> LayerNorm -> conv_after_body + f
      -> conv_before_upsample (LeakyReLU 0.01) -> [conv, PixelShuffle 2]
         x log2(upscale) -> conv_last -> / img_range + mean

There is no image-level padding.  Block j of a group adds Attn(LN1(t)),
then SGFN(LN2(t)), to t; Attn is, block by block:

- even j, the spatial attention (DSTB, ``AdaptiveSpatialAttention``): the
  qkv Linear's channels split in two branches of heads/2, one attending in
  split_size (8 x 32) windows, the other in the transposed (32 x 8), over
  the map zero-padded at the bottom and right to multiples of 32 (padded
  keys are zeros, not masked); blocks (even group, j = 2) and (odd group, j
  % 4 == 0) roll each branch's padded map by half its window first (Swin's
  mask, -100 between regions); the position bias comes from a small MLP
  over relative coordinates (``DynamicPosBias``);
- odd j, the channel attention (DCTB, ``AdaptiveChannelAttention``): per
  head, softmax over the channels of q and k L2-normalised over the whole
  image, times a learned temperature, applied to v.

Both add an Adaptive Interaction Module: a 3x3 depthwise conv of v
(BatchNorm, GELU) beside the attention, the two gating each other through
sigmoid maps, a channel map from a whole-image pool and a spatial map from
a 1x1 bottleneck (in the spatial block the attention gets the channel map
of the conv branch and the conv branch the spatial map of the attention;
in the channel block the other way round).  SGFN: GELU(fc1(u)) split in
halves, the second through LayerNorm and a 3x3 depthwise conv, times the
first, then fc2.

Every spatial attention runs on ``ops/kernels/win_attn.py`` (both branches
in one launch, 18 calls a forward at DAT's depths), every channel
attention's whole-image sums on ``ops/kernels/chan_attn.py`` (18 calls);
the group convs, conv_after_body and conv_before_upsample on the conv3x3
kernel.  conv_first, the pixel-shuffle head, the depthwise convs (``F.conv2d``
with groups), the Linears, LayerNorms, GELU and the gates are plain PyTorch.
In inference (``deterministic``) each BatchNorm uses its running
statistics, folded into the conv before it once per weight version; in
training it normalises with the batch's statistics and updates the running
ones, as ``nn.BatchNorm2d`` in train mode.  Module and parameter names, the
position buffers and the initialisation are DAT's, so its checkpoints load
strictly (the shifted blocks' ``attn_mask_*`` buffers, masks at DAT's
training size that the kernel computes for any size, are dropped on load).
Activations are NHWC; parameters stay float32.  DAT's stochastic depth
(drop_path 0.1) is not ported: ``generator`` is taken, as by every model of
the port, and changes nothing.

The channel attention reduces over the whole image, so a tiled forward
(``TiledSR``) gives another answer than the whole image's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sisr_tpu_torch.models.arch_util import (conv_nhwc, conv_weights, derived, layer_norm,
                                             linear)
from sisr_tpu_torch.ops.kernels.autograd import replayed_forward
from sisr_tpu_torch.ops.kernels.chan_attn import apply_heads, chan_attention, chan_attn
from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3
from sisr_tpu_torch.ops.kernels.win_attn import win_attn
from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from sisr_tpu_torch.utils.constants import device_constant
from sisr_tpu_torch.utils.profiling import span

# DIV2K's RGB mean, DAT's ``rgb_mean``
DAT_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def _mean(cin: int) -> np.ndarray:
    return np.asarray(DAT_RGB_MEAN if cin == 3 else (0.0,) * cin)


def rpe_table(hs: int, ws: int) -> torch.Tensor:
    """((2hs - 1)(2ws - 1), 2) float rows (dy, dx), dy in [1 - hs, hs - 1]
    and dx in [1 - ws, ws - 1], row-major (DAT's ``rpe_biases``)."""
    dy, dx = torch.meshgrid(torch.arange(1 - hs, hs), torch.arange(1 - ws, ws), indexing="ij")
    return torch.stack([dy.flatten(), dx.flatten()], 1).float()


def position_index(hs: int, ws: int) -> torch.Tensor:
    """(N, N) row of ``rpe_table`` for each query and key of an hs x ws
    window: (yi - yj + hs - 1) (2ws - 1) + (xi - xj + ws - 1) (DAT's
    ``relative_position_index``)."""
    ys, xs = torch.meshgrid(torch.arange(hs), torch.arange(ws), indexing="ij")
    y, x = ys.flatten(), xs.flatten()
    return (y[:, None] - y[None, :] + hs - 1) * (2 * ws - 1) + x[:, None] - x[None, :] + ws - 1


def shifted(group: int, block: int) -> bool:
    """Whether block ``block`` (a spatial one) of group ``group`` is shifted."""
    return (group % 2 == 0 and block > 0 and (block - 2) % 4 == 0) or (
        group % 2 == 1 and block % 4 == 0)


def _bn_affine(bn: nn.BatchNorm2d):
    """(scale, shift) of a BatchNorm on its running statistics."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


def _bn_train(x, bn: nn.BatchNorm2d):
    """BatchNorm on the batch's statistics of x (channels on axis 1),
    updating the running ones."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, True,
                        bn.momentum, bn.eps)


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d, dt):
    """(weight, bias) of ``conv`` followed by ``bn`` in inference, in dt."""
    scale, shift = _bn_affine(bn)
    w = conv.weight * scale.view(-1, *([1] * (conv.weight.dim() - 1)))
    return w.to(dt).contiguous(), (conv.bias * scale + shift).to(dt)


class DynamicPosBias(nn.Module):
    """DAT's position MLP (``residual=False``): rows of relative
    coordinates -> a bias per head, through Linear(2, dim // 4) and three
    [LayerNorm, ReLU, Linear]."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        pos_dim = dim // 4
        self.pos_proj = nn.Linear(2, pos_dim)
        self.pos1 = nn.Sequential(nn.LayerNorm(pos_dim), nn.ReLU(inplace=True),
                                  nn.Linear(pos_dim, pos_dim))
        self.pos2 = nn.Sequential(nn.LayerNorm(pos_dim), nn.ReLU(inplace=True),
                                  nn.Linear(pos_dim, pos_dim))
        self.pos3 = nn.Sequential(nn.LayerNorm(pos_dim), nn.ReLU(inplace=True),
                                  nn.Linear(pos_dim, num_heads))

    def forward(self, biases: torch.Tensor) -> torch.Tensor:
        return self.pos3(self.pos2(self.pos1(self.pos_proj(biases))))


class SpatialAttention(nn.Module):
    """One branch's position bias (DAT's ``Spatial_Attention``, whose
    products the kernel computes): ``idx`` 0 in split_size windows, 1 in
    the transposed ones."""

    def __init__(self, dim: int, idx: int, split_size: Sequence[int], num_heads: int):
        super().__init__()
        hs, ws = (split_size[0], split_size[1]) if idx == 0 else (split_size[1], split_size[0])
        self.H_sp, self.W_sp = hs, ws
        self.pos = DynamicPosBias(dim // 4, num_heads)
        self.register_buffer("rpe_biases", rpe_table(hs, ws))
        self.register_buffer("relative_position_index", position_index(hs, ws))

    def dense_bias(self) -> torch.Tensor:
        """(heads, N, N) float32 bias of the branch's window."""
        n = self.H_sp * self.W_sp
        pos = self.pos(self.rpe_biases)
        return pos[self.relative_position_index.reshape(-1)].reshape(n, n, -1).permute(
            2, 0, 1).float()


class _Interaction(nn.Module):
    """The Adaptive Interaction Module's layers, under DAT's names:
    ``dwconv`` (3x3 depthwise, BatchNorm, GELU), ``channel_interaction``
    (pool, 1x1 C -> C/8, BatchNorm, GELU, 1x1 back) and
    ``spatial_interaction`` (1x1 C -> C/16, BatchNorm, GELU, 1x1 -> 1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim),
                                    nn.BatchNorm2d(dim), nn.GELU())
        self.channel_interaction = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // 8, 1), nn.BatchNorm2d(dim // 8),
            nn.GELU(), nn.Conv2d(dim // 8, dim, 1))
        self.spatial_interaction = nn.Sequential(
            nn.Conv2d(dim, dim // 16, 1), nn.BatchNorm2d(dim // 16), nn.GELU(),
            nn.Conv2d(dim // 16, 1, 1))

    def conv_branch(self, v: torch.Tensor, train: bool) -> torch.Tensor:
        """GELU(BN(dwconv3x3(v))), NHWC."""
        conv, bn = self.dwconv[0], self.dwconv[1]
        dt = v.dtype
        x = v.permute(0, 3, 1, 2)
        if train:
            y = _bn_train(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1,
                                   groups=conv.groups), bn)
        else:
            w, b = derived(self, "dwconv_bn", dt, v.device, lambda: _fold(conv, bn, dt),
                           sources=(conv, bn))
            y = F.conv2d(x, w, b, padding=1, groups=conv.groups)
        return F.gelu(y).permute(0, 2, 3, 1)

    def channel_map(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """(B, C) logits of the channel gate from x's mean over the map, in
        float32 (or x's wider type)."""
        c1, bn, c2 = (self.channel_interaction[i] for i in (1, 2, 4))
        acc = torch.promote_types(x.dtype, torch.float32)
        s = x.mean(dim=(1, 2), dtype=acc)
        if train:
            s = _bn_train(F.linear(s, c1.weight.flatten(1), c1.bias), bn)
        else:
            w, b = derived(self, "channel_bn", acc, x.device, lambda: _fold(c1, bn, acc),
                           sources=(c1, bn))
            s = F.linear(s, w.flatten(1), b)
        return F.linear(F.gelu(s), c2.weight.flatten(1), c2.bias)

    def spatial_map(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """(B, H, W, 1) logits of the spatial gate of x, in x's dtype."""
        c1, bn, c2 = (self.spatial_interaction[i] for i in (0, 1, 3))
        dt = x.dtype
        if train:
            y = F.linear(x, c1.weight.flatten(1).to(dt), c1.bias.to(dt))
            y = _bn_train(y.permute(0, 3, 1, 2), bn).permute(0, 2, 3, 1)
        else:
            w, b = derived(self, "spatial_bn", dt, x.device, lambda: _fold(c1, bn, dt),
                           sources=(c1, bn))
            y = F.linear(x, w.flatten(1), b)
        return F.linear(F.gelu(y), c2.weight.flatten(1).to(dt), c2.bias.to(dt))


class AdaptiveSpatialAttention(_Interaction):
    """The spatial block's attention (DAT's ``Adaptive_Spatial_Attention``):
    both branches' rectangle windows in one ``win_attn`` call over the
    map zero-padded to multiples of max(split_size), shifted by half the
    window where ``shift``; then the AIM: out = proj(o sigmoid(c_map(conv))
    + conv sigmoid(s_map(o)))."""

    def __init__(self, dim: int, num_heads: int, split_size: Sequence[int], shift: bool,
                 qkv_bias: bool = True):
        super().__init__(dim)
        self.heads = num_heads // 2
        self.split_size = tuple(split_size)
        self.shift = (split_size[0] // 2, split_size[1] // 2) if shift else (0, 0)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.attns = nn.ModuleList([SpatialAttention(dim // 2, i, split_size, self.heads)
                                    for i in range(2)])
        self._register_load_state_dict_pre_hook(_drop_masks)

    def forward(self, u: torch.Tensor, train: bool) -> torch.Tensor:
        dt, c = u.dtype, u.shape[-1]
        qkv = linear(u, self.qkv, dt)
        bias = derived(self, "dat_bias", torch.float32, u.device,
                       lambda: torch.cat([a.dense_bias() for a in self.attns]),
                       sources=tuple(self.attns))
        o = win_attn(qkv, bias, self.heads, self.split_size, self.shift, 0, 2,
                     max(self.split_size))
        with span("dat.aim"):
            conv = self.conv_branch(qkv[..., 2 * c:], train)
            gate_o = torch.sigmoid(self.channel_map(conv, train)).to(dt)[:, None, None, :]
            x = torch.addcmul(o * gate_o, conv, torch.sigmoid(self.spatial_map(o, train)))
        return linear(x, self.proj, dt)


def _drop_masks(state_dict, prefix, *args):
    for name in ("attn_mask_0", "attn_mask_1"):
        state_dict.pop(prefix + name, None)


class AdaptiveChannelAttention(_Interaction):
    """The channel block's attention (DAT's ``Adaptive_Channel_Attention``):
    the whole image's sums on ``chan_attn``, the d x d softmax per head,
    its product with v; then the AIM with the gates crossed: out =
    proj(o sigmoid(s_map(conv)) + conv sigmoid(c_map(o)))."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__(dim)
        self.heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, u: torch.Tensor, train: bool) -> torch.Tensor:
        dt, c = u.dtype, u.shape[-1]
        qkv = linear(u, self.qkv, dt)
        attn = chan_attention(chan_attn(qkv, self.heads), self.temperature, c // self.heads)
        o = apply_heads(qkv[..., 2 * c:], attn)
        with span("dat.aim"):
            conv = self.conv_branch(qkv[..., 2 * c:], train)
            gate_conv = torch.sigmoid(self.channel_map(o, train)).to(dt)[:, None, None, :]
            x = torch.addcmul(conv * gate_conv, o, torch.sigmoid(self.spatial_map(conv, train)))
        return linear(x, self.proj, dt)


class SpatialGate(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class SGFN(nn.Module):
    """The spatial-gate feed-forward network: g = GELU(fc1(u)) split in
    halves g1, g2; fc2(g1 * dwconv3x3(LN(g2)))."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.sg = SpatialGate(hidden // 2)
        self.fc2 = nn.Linear(hidden // 2, dim)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        dt = u.dtype
        with span("dat.sgfn"):
            g1, g2 = F.gelu(linear(u, self.fc1, dt)).chunk(2, dim=-1)
            return linear(g1 * conv_nhwc(layer_norm(g2, self.sg.norm), self.sg.conv), self.fc2, dt)


class DATB(nn.Module):
    """Block ``b_idx`` of group ``rg_idx``: t + Attn(LN1(t)), then + SGFN(LN2(t))."""

    def __init__(self, dim: int, num_heads: int, split_size: Sequence[int],
                 expansion_factor: float, qkv_bias: bool, rg_idx: int, b_idx: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        if b_idx % 2 == 0:
            self.attn = AdaptiveSpatialAttention(dim, num_heads, split_size,
                                                 shifted(rg_idx, b_idx), qkv_bias)
        else:
            self.attn = AdaptiveChannelAttention(dim, num_heads, qkv_bias)
        self.ffn = SGFN(dim, int(dim * expansion_factor))
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, t: torch.Tensor, train: bool) -> torch.Tensor:
        t = self.attn(layer_norm(t, self.norm1), train).add_(t)
        return self.ffn(layer_norm(t, self.norm2)).add_(t)


class ResidualGroup(nn.Module):
    """The blocks, then a 3x3 conv added to the group's input
    (``resi_connection='1conv'``)."""

    def __init__(self, dim: int, num_heads: int, split_size: Sequence[int], depth: int,
                 expansion_factor: float, qkv_bias: bool, rg_idx: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            DATB(dim, num_heads, split_size, expansion_factor, qkv_bias, rg_idx, j)
            for j in range(depth)])
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, t: torch.Tensor, train: bool) -> torch.Tensor:
        y = t
        for block in self.blocks:
            y = block(y, train)
        return conv3x3(y, t, *conv_weights(self.conv, t.dtype, t.device), "none")


class DAT(nn.Module):
    """DAT (module docstring).  NHWC input in [0, 1]; the defaults are the
    x4 model's published widths (``options/Test/test_DAT_x4.yml``:
    14,802,051 parameters).  Only the ``pixelshuffle`` head and the
    ``1conv`` residual connection, which the published DAT x4 uses, are
    built; ``img_size`` (DAT's training size, which sizes its stored masks)
    is taken and changes nothing."""

    def __init__(self, img_size: int = 64, in_chans: int = 3, embed_dim: int = 180,
                 split_size: Sequence[int] = (8, 32),
                 depth: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6), expansion_factor: float = 4.0,
                 qkv_bias: bool = True, upscale: int = 4, img_range: float = 1.0,
                 resi_connection: str = "1conv", upsampler: str = "pixelshuffle",
                 num_feat: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        if upsampler != "pixelshuffle" or upscale not in (2, 4):
            raise ValueError(f"DAT: only the x2 and x4 pixelshuffle heads "
                             f"(got {upsampler!r}, x{upscale})")
        if resi_connection != "1conv":
            raise ValueError(f"DAT: only resi_connection='1conv' (got {resi_connection!r})")
        if any(h % 2 for h in num_heads):
            raise ValueError(f"DAT: the spatial blocks split the heads in two ({num_heads})")
        c = embed_dim
        self.in_chans, self.img_range, self.upscale = in_chans, img_range, upscale
        self.upsampler, self.dtype = upsampler, dtype
        self.conv_first = nn.Conv2d(in_chans, c, 3, 1, 1)
        # DAT's before_RG is (Rearrange, LayerNorm): the LayerNorm keeps index 1
        self.before_RG = nn.Sequential(nn.Identity(), nn.LayerNorm(c))
        self.layers = nn.ModuleList([
            ResidualGroup(c, num_heads[i], split_size, d, expansion_factor, qkv_bias, i)
            for i, d in enumerate(depth)])
        self.norm = nn.LayerNorm(c)
        self.conv_after_body = nn.Conv2d(c, c, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(c, num_feat, 3, 1, 1),
                                                  nn.LeakyReLU(inplace=True))
        ups = []
        for _ in range(int(np.log2(upscale))):
            ups += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        # DAT's _init_weights: Linear trunc-normal 0.02 and bias 0, LayerNorm
        # and BatchNorm 1 and 0 (torch's own); convs keep torch's defaults
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        """(B, H, W, in_chans) -> (B, upscale H, upscale W, in_chans).
        ``deterministic`` False (training): every BatchNorm on the batch's
        statistics.  Inside ``replayed_forwards()`` (``TiledSR``'s tiles) a
        forward without grad on a card replays as a CUDA graph per
        signature (``ops/kernels/autograd.py::replayed_forward``)."""
        return replayed_forward(self, lambda t: self._forward(t, not deterministic), x,
                                (self.dtype,), deterministic)

    def _forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        cin = x.shape[-1]
        dt, dev = self.dtype, x.device
        mean = device_constant(_mean, (cin,), dt, dev)
        f = conv_nhwc((x.to(dt) - mean) * self.img_range, self.conv_first)
        t = layer_norm(f, self.before_RG[1])
        for layer in self.layers:
            t = layer(t, train)
        t = layer_norm(t, self.norm)
        y = conv3x3(t, f, *conv_weights(self.conv_after_body, dt, dev), "none")
        y = conv3x3(y, None, *conv_weights(self.conv_before_upsample[0], dt, dev), "leaky")
        for conv in self.upsample[::2]:
            y = pixel_shuffle(conv_nhwc(y, conv), 2)
        return conv_nhwc(y, self.conv_last) / self.img_range + mean
