"""HAT, the Hybrid Attention Transformer for image super-resolution (Chen et
al., "Activating More Pixels in Image Super-Resolution Transformer",
arXiv:2205.04437; XPixelGroup/HAT ``hat/archs/hat_arch.py``), on the
port's kernels.

    input (B, H, W, 3) in [0, 1]
      -> reflect-pad bottom and right to multiples of the window (HAT's
         ``pre_process``) -> (x - mean) * img_range -> conv_first
      -> patch LayerNorm -> len(depths) x RHAG -> LayerNorm
      -> conv_after_body + shallow
      -> conv_before_upsample (LeakyReLU 0.01) -> [conv, PixelShuffle 2]
         x log2(upscale) -> conv_last -> / img_range + mean -> crop

An RHAG is ``depth`` HABs (shift 0 and window/2 in turn) and one OCAB,
then a 3x3 conv added to its input.  A HAB adds window attention (learned
relative-position bias, the shift mask on shifted blocks) and
``conv_scale`` times its channel-attention branch (CAB: conv C -> C/3,
GELU, conv C/3 -> C, then the map times sigmoid(conv1x1(ReLU(conv1x1(its
mean over the map))))) to its input, then an MLP; an OCAB attends from
each window to the zero-padded ``window * (1 + overlap_ratio)`` square
around it, then an MLP.

Every attention runs on ``ops/kernels/win_attn.py`` (42 calls a forward at
HAT's depths), the RHAG convs, conv_after_body, conv_before_upsample and
the CAB convs on the conv3x3 kernel; conv_first and the pixel-shuffle head
are plain ``F.conv2d``, the Linears (``F.linear``), LayerNorms
(``F.layer_norm``) and the channel attention plain PyTorch.  Module and
parameter names, the two position-index buffers and the initialisation are
HAT's, so its checkpoints load strictly.
Activations are NHWC; parameters stay float32 and what is derived from them
(HWIO conv weights, each block's dense bias) is kept per compute ``dtype``
(``arch_util.derived``).  HAT's stochastic depth (its class default 0.1) is
not ported: ``deterministic`` and ``generator`` are taken, as by every
model of the port, and change nothing.
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
from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3
from sisr_tpu_torch.ops.kernels.win_attn import win_attn
from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from sisr_tpu_torch.ops.windows import pad_to_multiple
from sisr_tpu_torch.utils.constants import device_constant
from sisr_tpu_torch.utils.profiling import span

# DIV2K's RGB mean, HAT's ``rgb_mean``
HAT_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def _mean(cin: int) -> np.ndarray:
    return np.asarray(HAT_RGB_MEAN if cin == 3 else (0.0,) * cin)


def rpi_sa(window: int) -> torch.Tensor:
    """(w^2, w^2) row of the (2w - 1)^2 bias table for each query and key of
    a window: (yi - yj + w - 1) * (2w - 1) + (xi - xj + w - 1) (HAT's
    ``calculate_rpi_sa``)."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    y, x = ys.flatten(), xs.flatten()
    return ((y[:, None] - y[None, :] + window - 1) * (2 * window - 1)
            + x[:, None] - x[None, :] + window - 1)


def rpi_oca(window: int, key_window: int) -> torch.Tensor:
    """(w^2, k^2) row of the (w + k - 1)^2 table for query (yo, xo) of the
    window and key (ye, xe) of the k-square around it: (ye - yo + w - k + 1)
    * (w + k - 1) + (xe - xo + w - k + 1) (HAT's ``calculate_rpi_oca``).
    It runs negative (-880 to 640 at 16 and 24); indexing wraps those, and
    every offset still has a row of its own."""
    off = window - key_window + 1
    yo, xo = (t.flatten() for t in torch.meshgrid(torch.arange(window), torch.arange(window),
                                                  indexing="ij"))
    ye, xe = (t.flatten() for t in torch.meshgrid(torch.arange(key_window),
                                                  torch.arange(key_window), indexing="ij"))
    return ((ye[None, :] - yo[:, None] + off) * (window + key_window - 1)
            + xe[None, :] - xo[:, None] + off)


def _dense_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(heads, N, M) float32 bias of ``table`` ((rows, heads)) at ``index`` (N, M)."""
    n, m = index.shape
    return table[index.reshape(-1)].reshape(n, m, -1).permute(2, 0, 1).float().contiguous()


def _mlp(x, mlp: "Mlp", dt):
    return linear(F.gelu(linear(x, mlp.fc1, dt)), mlp.fc2, dt)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ChannelAttention(nn.Module):
    """``attention``: pool, conv1x1 C -> C/squeeze, ReLU, conv1x1 back,
    sigmoid (HAT's layout; the pool and the activations hold no weights)."""

    def __init__(self, dim: int, squeeze: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // squeeze, 1), nn.ReLU(inplace=True),
            nn.Conv2d(dim // squeeze, dim, 1), nn.Sigmoid())

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, H, W, C) -> z times its per-image channel gate."""
        c1, c2 = self.attention[1], self.attention[3]
        s = z.mean(dim=(1, 2), dtype=torch.float32)
        s = torch.relu(s @ c1.weight.flatten(1).t() + c1.bias)
        s = torch.sigmoid(s @ c2.weight.flatten(1).t() + c2.bias)
        return z * s.to(z.dtype)[:, None, None, :]


class CAB(nn.Module):
    def __init__(self, dim: int, compress_ratio: int, squeeze: int):
        super().__init__()
        self.cab = nn.Sequential(
            nn.Conv2d(dim, dim // compress_ratio, 3, 1, 1), nn.GELU(),
            nn.Conv2d(dim // compress_ratio, dim, 3, 1, 1), ChannelAttention(dim, squeeze))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        dt, dev = u.dtype, u.device
        h = F.gelu(conv3x3(u, None, *conv_weights(self.cab[0], dt, dev), "none"))
        z = conv3x3(h, None, *conv_weights(self.cab[2], dt, dev), "none")
        return self.cab[3](z)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)


class HAB(nn.Module):
    """The hybrid attention block: window attention (shifted by ``shift``)
    plus ``conv_scale`` times the CAB branch, then the MLP."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, compress_ratio: int,
                 squeeze: int, conv_scale: float, mlp_ratio: float):
        super().__init__()
        self.window, self.shift, self.conv_scale = window, shift, conv_scale
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.conv_block = CAB(dim, compress_ratio, squeeze)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        dt, attn = t.dtype, self.attn
        u = layer_norm(t, self.norm1)
        with span("hat.cab"):
            cab = self.conv_block(u)
        bias = derived(attn, "win_bias", torch.float32, t.device,
                       lambda: _dense_bias(attn.relative_position_bias_table, index))
        a = win_attn(linear(u, attn.qkv, dt), bias, attn.heads, self.window, self.shift)
        t = torch.add(t, cab, alpha=self.conv_scale).add_(linear(a, attn.proj, dt))
        return _mlp(layer_norm(t, self.norm2), self.mlp, dt).add_(t)


class OCAB(nn.Module):
    """Overlapping cross-attention: each window's queries against the
    zero-padded ``key_window`` square around it, then the MLP."""

    def __init__(self, dim: int, heads: int, window: int, key_window: int, mlp_ratio: float):
        super().__init__()
        self.heads, self.window, self.key_window = heads, window, key_window
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((window + key_window - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)

    def forward(self, t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        dt = t.dtype
        bias = derived(self, "win_bias", torch.float32, t.device,
                       lambda: _dense_bias(self.relative_position_bias_table, index))
        a = win_attn(linear(layer_norm(t, self.norm1), self.qkv, dt), bias, self.heads,
                     self.window, 0, self.key_window)
        t = linear(a, self.proj, dt).add_(t)
        return _mlp(layer_norm(t, self.norm2), self.mlp, dt).add_(t)


class AttenBlocks(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, key_window: int,
                 compress_ratio: int, squeeze: int, conv_scale: float, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList([
            HAB(dim, heads, window, 0 if j % 2 == 0 else window // 2, compress_ratio,
                squeeze, conv_scale, mlp_ratio) for j in range(depth)])
        self.overlap_attn = OCAB(dim, heads, window, key_window, mlp_ratio)


class RHAG(nn.Module):
    """Residual hybrid attention group: the blocks, then a 3x3 conv added to
    the group's input (``resi_connection='1conv'``)."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, key_window: int,
                 compress_ratio: int, squeeze: int, conv_scale: float, mlp_ratio: float):
        super().__init__()
        self.residual_group = AttenBlocks(dim, depth, heads, window, key_window,
                                          compress_ratio, squeeze, conv_scale, mlp_ratio)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, t: torch.Tensor, rpi_sa_: torch.Tensor,
                rpi_oca_: torch.Tensor) -> torch.Tensor:
        y = t
        for block in self.residual_group.blocks:
            y = block(y, rpi_sa_)
        y = self.residual_group.overlap_attn(y, rpi_oca_)
        return conv3x3(y, t, *conv_weights(self.conv, t.dtype, t.device), "none")


class PatchEmbed(nn.Module):
    """Holds the patch LayerNorm under HAT's name."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


class HAT(nn.Module):
    """HAT (module docstring).  NHWC input in [0, 1]; the defaults are the
    x4 model's published widths (HAT_SRx4_ImageNet-pretrain: 20,772,507
    parameters).  Only the ``pixelshuffle`` head and the ``1conv`` residual
    connection, which every published HAT uses, are built."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6), window_size: int = 16,
                 compress_ratio: int = 3, squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0, upscale: int = 4,
                 img_range: float = 1.0, upsampler: str = "pixelshuffle",
                 resi_connection: str = "1conv", num_feat: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if upsampler != "pixelshuffle" or upscale not in (2, 4):
            raise ValueError(f"HAT: only the x2 and x4 pixelshuffle heads "
                             f"(got {upsampler!r}, x{upscale})")
        if resi_connection != "1conv":
            raise ValueError(f"HAT: only resi_connection='1conv' (got {resi_connection!r})")
        c = embed_dim
        self.in_chans, self.img_range, self.upscale = in_chans, img_range, upscale
        self.upsampler, self.dtype = upsampler, dtype
        self.window_size = window_size
        key_window = int(window_size * overlap_ratio) + window_size
        self.register_buffer("relative_position_index_SA", rpi_sa(window_size))
        self.register_buffer("relative_position_index_OCA", rpi_oca(window_size, key_window))
        self.conv_first = nn.Conv2d(in_chans, c, 3, 1, 1)
        self.patch_embed = PatchEmbed(c)
        self.layers = nn.ModuleList([
            RHAG(c, depth, num_heads[i], window_size, key_window, compress_ratio,
                 squeeze_factor, conv_scale, mlp_ratio) for i, depth in enumerate(depths)])
        self.norm = nn.LayerNorm(c)
        self.conv_after_body = nn.Conv2d(c, c, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(c, num_feat, 3, 1, 1),
                                                  nn.LeakyReLU(inplace=True))
        ups = []
        for _ in range(int(np.log2(upscale))):
            ups += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        # HAT's _init_weights: Linear trunc-normal 0.02 and bias 0,
        # LayerNorm 1 and 0 (torch's own); convs keep torch's defaults
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        """(B, H, W, in_chans) -> (B, upscale H, upscale W, in_chans); inside
        ``replayed_forwards()`` (``TiledSR``'s tiles) a forward without grad
        on a card replays as a CUDA graph per signature
        (``ops/kernels/autograd.py::replayed_forward``)."""
        return replayed_forward(self, self._forward, x, (self.dtype,), deterministic)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, cin = x.shape
        dt, dev = self.dtype, x.device
        with span("hat.pad"):
            x = pad_to_multiple(x.to(dt), (self.window_size, self.window_size))
        mean = device_constant(_mean, (cin,), dt, dev)
        shallow = conv_nhwc((x - mean) * self.img_range, self.conv_first)
        t = layer_norm(shallow, self.patch_embed.norm)
        for layer in self.layers:
            t = layer(t, self.relative_position_index_SA, self.relative_position_index_OCA)
        t = layer_norm(t, self.norm)
        y = conv3x3(t, shallow, *conv_weights(self.conv_after_body, dt, dev), "none")
        y = conv3x3(y, None, *conv_weights(self.conv_before_upsample[0], dt, dev), "leaky")
        for conv in self.upsample[::2]:
            y = pixel_shuffle(conv_nhwc(y, conv), 2)
        y = conv_nhwc(y, self.conv_last) / self.img_range + mean
        with span("hat.pad"):
            return y[:, :h * self.upscale, :w * self.upscale]
