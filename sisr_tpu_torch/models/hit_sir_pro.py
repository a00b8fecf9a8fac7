"""HiT-SIR-Pro in PyTorch: the serving path of
``sisr_tpu/models/hit_sir_pro.py`` (reference models/hit_sir_pro.py:1065-1344).

    input (B,H,W,3) in [0,1]
      -> mean-subtract
      -> MultipleSizeConvExtract (packed 9x9 im2col matmul), or one 3x3 conv
      -> patch LayerNorm -> len(depths) x RHTB -> LayerNorm -> conv_after_body
      -> Fusion gate with shallow (three UnionAttentions; or + shallow
         without the gate)
      -> the head: conv_before_upsample -> packed nearest+conv x4 (the
         flagship's); or the pixel-shuffle heads (x2, x4, or one-step
         direct); or the denoise head (input + conv_last)
      -> mean add-back, crop

``stage`` splits the forward for whole-image evaluation as in JAX:
'features' stops after conv_before_upsample, 'head' runs the x4 head and
the mean add-back on such a map (``parallel/tiling.py::BandedHeadSR``).

Activations are NHWC; parameters keep the reference's torch state-dict
names and layouts, so a reference ``.pth`` loads with ``load_state_dict``.
Parameters stay float32; what a module derives from them for its kernels
(cast, transposed, folded or expanded weights, position-bias tables) is
made once per compute ``dtype`` and device and kept until a parameter
changes, so a forward runs only the work that depends on its input; a
forward that records gradients makes it anew under autograd instead.
The kernel functions run their CUDA kernels for CUDA tensors and their
plain versions for CPU tensors and inside ``ops.kernels.autograd.
plain_versions()`` (the yardstick on the card).  ``deterministic=False`` is
the training forward, as in JAX: no block threads the SCA statistics to the
next (its tail kernel has no backward), ``fused_htb`` is ignored, and the
dropout rates, when set (no experiment sets them), take effect
(``HiTSIR``'s docstring), each mask drawn from the forward's ``generator``
(``ops/dropout.py``).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sisr_tpu_torch.models.arch_util import conv_nhwc, conv_weights, derived
from sisr_tpu_torch.ops import dropout as drop
from sisr_tpu_torch.ops.color import IMAGENET_ISH_RGB_MEAN
from sisr_tpu_torch.ops.kernels.autograd import (in_plain_versions, plain_versions,
                                                 replayed_forward)
from sisr_tpu_torch.ops.kernels.conv3x3 import (conv3x3, conv3x3_shuffled,
                                                conv3x3_shuffled_tail,
                                                conv3x3_shuffled_tail_packed)
from sisr_tpu_torch.ops.kernels.dwconv import depthwise_conv_reference
from sisr_tpu_torch.ops.kernels.ffn import htb_tail, htb_tail_stats, layer_norm
from sisr_tpu_torch.ops.kernels.fusion_ops import fused_fusion, pack_params
from sisr_tpu_torch.ops.kernels.htb_block import htb_fused
from sisr_tpu_torch.ops.kernels.scc_attention import (blockdiag_kgen, head_mask,
                                                      pooling_matrix, scc_reference)
from sisr_tpu_torch.ops.kernels.scc_block import sca_reference, scc_block
from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from sisr_tpu_torch.ops.windows import pad_to_multiple
from sisr_tpu_torch.utils.constants import device_constant


def _linear(x, mod: nn.Linear, dt):
    """``x @ W^T + b`` in the compute dtype (flax Dense semantics)."""
    return x.to(dt) @ mod.weight.t().to(dt) + mod.bias.to(dt)


# elements of one slab of rows of the model-level LayerNorms and of the
# multi-size conv (below): their float32 or 4C-channel temporaries stay
# ~256 MiB each instead of a whole map's (1.5-3 GB apiece at a 1080p frame,
# which set the frame's peak memory)
LN_SLAB_ELEMS = 1 << 26


def _layer_norm_slabs(x: torch.Tensor, scale, bias) -> torch.Tensor:
    """``layer_norm`` of a (B, H, W, C) map, a slab of rows at a time where
    the map is large: the statistics are per pixel, so every value is the
    one ``layer_norm`` gives the whole map."""
    b, h, w, c = x.shape
    rows = max(1, LN_SLAB_ELEMS // max(1, b * w * c))
    if rows >= h:
        return layer_norm(x, scale, bias)
    return torch.cat([layer_norm(x[:, r:r + rows], scale, bias) for r in range(0, h, rows)],
                     dim=1)


def _input_mean(cin: int) -> np.ndarray:
    """The mean subtracted from the input: the RGB mean, or 0 for other
    channel counts."""
    return np.asarray(IMAGENET_ISH_RGB_MEAN if cin == 3 else (0.0,))


class MultipleSizeConvExtract(nn.Module):
    """Multi-kernel-size shallow feature extraction (reference :49-100).

    Four parallel convs (k=3,5,7,9) gated by ``sigmoid(conv1x1(x) * conv_k(x))``
    with a residual, projected back by a 1x1 conv.  The four convs run as
    ONE packed 9x9 conv (kernels zero-padded and concatenated), as an
    explicit im2col matmul with tap-major columns, exactly as in the JAX
    package."""

    def __init__(self, in_chans: int, out_channels: int):
        super().__init__()
        c = out_channels
        for k in (3, 5, 7, 9):
            setattr(self, f"conv{k}", nn.Conv2d(in_chans, c, k, padding=k // 2))
        self.conv_x = nn.Conv2d(in_chans, c, 1)
        # declared (and checkpointed) by the reference but unused (:62)
        self.norm = nn.LayerNorm(c)
        self.conv_last = nn.Conv2d(4 * c, c, 1)

    def _weights(self, dt):
        cin = self.conv_x.in_channels
        c = self.conv_x.out_channels
        convs = [getattr(self, f"conv{k}") for k in (3, 5, 7, 9)]
        packed_k = torch.cat(
            [F.pad(cv.weight, ((9 - cv.kernel_size[0]) // 2,) * 4)
             for cv in convs], dim=0)                       # (4c, cin, 9, 9)
        kmat = packed_k.permute(2, 3, 1, 0).reshape(81 * cin, 4 * c).to(dt)
        packed_b = torch.cat([cv.bias for cv in convs]).to(dt)
        gate_w = self.conv_x.weight[:, :, 0, 0].t().to(dt)
        lk = self.conv_last.weight[:, :, 0, 0].t().to(dt)     # (4c, c)
        return (kmat, packed_b, gate_w, self.conv_x.bias.to(dt), lk,
                self.conv_last.bias.to(dt))

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        c = self.conv_x.out_channels
        b, h, w, cin = x.shape
        weights = derived(self, "msce", dt, x.device, lambda: self._weights(dt))
        # a slab of rows at a time on large maps: the packed conv's 4c-channel
        # output and the im2col columns are ~30x the input, which set a
        # 1080p frame's peak memory; every pixel's value is unchanged
        rows = max(1, LN_SLAB_ELEMS // max(1, b * w * 4 * c))
        if rows >= h:
            return self._rows(F.unfold(x.to(dt).permute(0, 3, 1, 2), 9, padding=4), x,
                              weights, dt)
        xp = F.pad(x.to(dt).permute(0, 3, 1, 2), (4, 4, 4, 4))
        return torch.cat([self._rows(F.unfold(xp[:, :, r:min(h, r + rows) + 8], 9),
                                     x[:, r:r + rows], weights, dt)
                          for r in range(0, h, rows)], dim=1)

    def _rows(self, cols: torch.Tensor, x: torch.Tensor, weights, dt) -> torch.Tensor:
        """The block on rows of x, given their 9x9 im2col columns ``cols``
        (B, cin*81, rows*W)."""
        c = self.conv_x.out_channels
        b, h, w, cin = x.shape
        kmat, packed_b, gate_w, gate_b, lk, out = weights
        # (B, cin*81, H*W) channel-major columns -> (B, H, W, 81*cin) tap-major
        patches = cols.reshape(b, cin, 81, h, w).permute(0, 3, 4, 2, 1)
        b_all = patches.reshape(b, h, w, 81 * cin) @ kmat + packed_b
        gate = x.to(dt) @ gate_w + gate_b
        # gating per branch and the 1x1 projection split into four (c, c)
        # matmuls: never materializes the 4c-channel concat
        for k in range(4):
            p = b_all[..., k * c:(k + 1) * c]
            g = p * torch.sigmoid(gate * p) + p
            out = out + g @ lk[k * c:(k + 1) * c]
        return out


class DynamicPosBias(nn.Module):
    """MLP over relative coordinates (reference :274-313):
    pos3(pos2(pos1(pos_proj(biases)))), each posN = LayerNorm -> ReLU -> Linear."""

    def __init__(self, pos_dim: int, num_heads: int):
        super().__init__()
        self.pos_proj = nn.Linear(2, pos_dim)
        for i, feat in ((1, pos_dim), (2, pos_dim), (3, num_heads)):
            setattr(self, f"pos{i}", nn.Sequential(
                nn.LayerNorm(pos_dim), nn.ReLU(), nn.Linear(pos_dim, feat)))

    def forward(self, biases: torch.Tensor, dt) -> torch.Tensor:
        x = _linear(biases, self.pos_proj, dt)
        for i in (1, 2, 3):
            seq = getattr(self, f"pos{i}")
            x = torch.relu(layer_norm(x, seq[0].weight, seq[0].bias))
            x = _linear(x, seq[2], dt)
        return x


def _bias_gather_map(n: int, b: int) -> np.ndarray:
    """One axis of the separable gather map for the pooled relative-position
    bias: the pooled bias is a (wh/bh, ww/bw) box filter over the
    relative-coordinate grid evaluated at (y - by*rh + wh-1, x - bx*rw + ww-1);
    this is the (n*b,) row (or column) index for a window side n and base
    side b."""
    idx = np.arange(n)[:, None] - np.arange(b)[None, :] * (n // b) + n - 1
    return idx.reshape(-1).astype(np.int64)


def _bias_table(pooled: torch.Tensor, wh: int, ww: int, bh: int, bw: int,
                heads: int) -> torch.Tensor:
    """(P', heads) box-filtered grid -> (L, heads*l_base) bias table, column
    order head-major then base cell."""
    dev = pooled.device
    dy = device_constant(_bias_gather_map, (wh, bh), torch.long, dev)
    dx = device_constant(_bias_gather_map, (ww, bw), torch.long, dev)
    g = pooled.reshape(2 * wh - 1, 2 * ww - 1, heads).permute(2, 0, 1)
    g = g[:, dy, :]                                     # (heads, wh*bh, 2ww-1)
    g = g[:, :, dx]                                     # (heads, wh*bh, ww*bw)
    g = g.reshape(heads, wh, bh, ww, bw)
    return g.permute(1, 3, 0, 2, 4).reshape(wh * ww, heads * bh * bw)


def _box_pool_matrix(n: int, r: int) -> np.ndarray:
    """(n, n) banded matrix with M[i, k] = 1/r for i-r+1 <= k <= i: one axis
    of the causal box filter that mean-pools the bias grid (reference
    :496-500)."""
    m = np.zeros((n, n), np.float32)
    for i in range(n):
        m[i, max(0, i - r + 1):i + 1] = 1.0 / r
    return m


def _rpe_mother_set(wh: int, ww: int) -> np.ndarray:
    """(P, 2) float relative-coordinate table, h-major (reference :479-482)."""
    bh = np.arange(1 - wh, wh, dtype=np.float32)
    bw = np.arange(1 - ww, ww, dtype=np.float32)
    grid = np.stack(np.meshgrid(bh, bw, indexing="ij"))
    return grid.reshape(2, -1).T.copy()


class SpatialChannelAttention(nn.Module):
    """SCA (reference :317-359).  Inside HiTSIR only its parameters are
    used: the math is fused into the SCC kernel (``scc_block``).  Called on
    its own (DenseSR's ``sa_attn``, JAX ``hit_sir_pro.py:331-359``) it
    computes the squeeze-excite vectors and then ``sca_reference``, in
    x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear1 = nn.Conv2d(1, dim, 3, padding=1)
        self.linear2 = nn.Conv2d(1, dim, 3, padding=1)
        self.linear1_first = nn.Linear(dim, dim // 10)
        self.linear1_second = nn.Linear(dim // 10, dim)
        self.linear2_first = nn.Linear(dim, dim // 10)
        self.linear2_second = nn.Linear(dim // 10, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = x.shape[-1], x.dtype
        s1 = _linear(_linear(x.mean(dim=(1, 2), keepdim=True), self.linear1_first, dt),
                     self.linear1_second, dt)
        s2 = _linear(_linear(x.amax(dim=(1, 2), keepdim=True), self.linear2_first, dt),
                     self.linear2_second, dt)
        return sca_reference(x, self.linear1.weight.reshape(c, 9).t().to(dt),
                             self.linear1.bias.to(dt),
                             self.linear2.weight.reshape(c, 9).t().to(dt),
                             self.linear2.bias.to(dt), s1, s2)


class SCC(nn.Module):
    """Spatial-Channel Correlation (reference :362-602).

    Per window: q/v halves across heads, k synthesized as
    ``(k_gen1(q) + k_gen2(v)) / 2``; the spatial branch pools k, v to the
    base window and adds a pooled dynamic position bias; the channel branch
    is a single-head channel gram; both are projected, then dropped out
    at ``proj_drop`` in training.  In training with ``value_drop`` it runs
    the plain version with the value dropout, as JAX does (its
    ``_reference_with_dropout``); else the kernel."""

    def __init__(self, dim: int, base_win_size: Tuple[int, int],
                 window_size: Tuple[int, int], num_heads: int,
                 is_channel_spatial_attn: bool = True, value_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.dim = dim
        self.value_drop = value_drop
        self.proj_drop = proj_drop
        self.base_win_size = tuple(base_win_size)
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        wh, ww = self.window_size
        bh, bw = min(wh, base_win_size[0]), min(ww, base_win_size[1])
        d = dim // (2 * num_heads)
        if is_channel_spatial_attn:
            self.qkv = SpatialChannelAttention(dim)
        self.proj = nn.Linear(dim, dim)
        self.spatial_linear = nn.Linear((wh // bh) * (ww // bw), 1)
        self.k_generate1 = nn.Linear(d, d)
        self.k_generate2 = nn.Linear(d, d)
        self.pos = DynamicPosBias(dim // 4 // 4, num_heads)

    def _weights(self, dt, dev):
        """Everything the kernel takes that depends on weights only."""
        c = self.dim
        wh, ww = self.window_size
        bh = min(wh, self.base_win_size[0])
        bw = min(ww, self.base_win_size[1])
        heads = self.num_heads
        rh, rw = wh // bh, ww // bw
        sca_w = se_w = None
        if hasattr(self, "qkv"):
            q = self.qkv
            sca_w = (q.linear1.weight.reshape(c, 9).t().to(dt), q.linear1.bias.to(dt),
                     q.linear2.weight.reshape(c, 9).t().to(dt), q.linear2.bias.to(dt))
            # the squeeze-excite Dense layers as (W^T, b): x @ W^T + b is flax Dense
            se_w = tuple(tuple((m.weight.t().to(dt), m.bias.to(dt)) for m in pair)
                         for pair in ((q.linear1_first, q.linear1_second),
                                      (q.linear2_first, q.linear2_second)))

        # dynamic position bias, mean-pooled to the base window by a
        # separable box filter, expanded to the (L, heads*l_base) table
        rpe = device_constant(_rpe_mother_set, (wh, ww), dt, dev)
        pos = self.pos(rpe, dt)
        if rh == 1 and rw == 1:
            pooled = pos
        else:
            grid = pos.reshape(2 * wh - 1, 2 * ww - 1, heads)
            rmat = device_constant(_box_pool_matrix, (2 * wh - 1, rh), dt, dev)
            cmat = device_constant(_box_pool_matrix, (2 * ww - 1, rw), dt, dev)
            t = torch.einsum("ik,kjh->ijh", rmat, grid)
            pooled = torch.einsum("jl,ilh->ijh", cmat, t).reshape(-1, heads)
        bias = _bias_table(pooled, wh, ww, bh, bw, heads)

        k1, k2 = self.k_generate1, self.k_generate2
        w1, w2, bb = blockdiag_kgen(k1.weight.t().to(dt), k1.bias.to(dt),
                                    k2.weight.t().to(dt), k2.bias.to(dt), heads)
        pmat, pb = pooling_matrix(self.spatial_linear.weight.t(),
                                  self.spatial_linear.bias, wh, ww, bh, bw, dt)
        mask = head_mask(heads, bh * bw, c // 2, dt, dev)
        return (sca_w, se_w, w1, w2, bb, pmat, pb, mask, bias.to(dt),
                self.proj.weight.t().to(dt), self.proj.bias.to(dt))

    def forward(self, x: torch.Tensor, stats=None, deterministic: bool = True,
                generator: drop.Rng = None) -> torch.Tensor:
        sca, rest = self.bundle(x, stats)
        if self.value_drop > 0.0 and not deterministic:
            out = _scc_with_value_drop(x, sca, *rest, self.num_heads, self.window_size,
                                       self.value_drop, generator)
        else:
            out = scc_block(x, sca, *rest, self.num_heads, self.window_size)
        return out if deterministic else drop.dropout(out, self.proj_drop, generator)

    def bundle(self, x: torch.Tensor, stats=None):
        """(sca, the rest of scc_block's arguments up to proj_b) for x:
        the SCA parameter tuple (None without SCA), with the threaded
        (cmean, cmax) maps when ``stats`` are given."""
        b, hp, wp, c = x.shape
        dt = x.dtype
        sca_w, se_w, *rest = derived(self, "scc", dt, x.device,
                                     lambda: self._weights(dt, x.device))

        sca = None
        if sca_w is not None:
            if stats is not None:
                # the previous block's tail kernel already reduced x
                cmean, cmax, ssum, smax = stats
                sp_avg = (ssum.to(dt) / float(hp * wp)).reshape(b, 1, 1, c)
                sp_max = smax.to(dt).reshape(b, 1, 1, c)
            else:
                cmean = cmax = None
                sp_avg = x.mean(dim=(1, 2), keepdim=True)
                sp_max = x.amax(dim=(1, 2), keepdim=True)
            s = []
            for pool, pair in zip((sp_avg, sp_max), se_w):
                for wt, bias in pair:
                    pool = pool @ wt + bias
                s.append(pool)
            sca = sca_w + tuple(s)
            if cmean is not None:
                sca = sca + (cmean, cmax)
        return sca, rest


def _scc_with_value_drop(x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k, proj_b,
                         heads: int, window, value_drop: float,
                         rng: drop.Rng) -> torch.Tensor:
    """``scc_block``'s plain version with the value dropout."""
    b, hp, wp, c = x.shape
    wh, ww = window
    dt = x.dtype
    qkv = sca_reference(x, *sca) if sca is not None else x
    out6 = scc_reference(qkv.reshape(b, hp // wh, wh, wp // ww, ww, c), w1, w2, bb, pmat, pb,
                         mask, bias, heads, value_drop, rng)
    return out6.reshape(b, hp, wp, c).to(dt) @ proj_k.to(dt) + proj_b.to(dt)


class DepthwiseConv(nn.Module):
    """Holds the 5x5 depthwise conv under the reference's name
    (``dwconv.depthwise_conv.0``)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.depthwise_conv = nn.Sequential(
            nn.Conv2d(hidden, hidden, 5, padding=2, groups=hidden))


class ConvFFN(nn.Module):
    """ConvFFN parameters (reference :12-46); the math is the HTB-tail kernel."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DepthwiseConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)


class HierarchicalTransformerBlock(nn.Module):
    """pad -> SCC -> (crop) post-norm residual -> ConvFFN (reference :605-710).

    ``fused_htb`` (off by default, as JAX's ``SISR_FUSED_HTB``) runs the
    blocks whose window equals its base window, on maps the window divides,
    as one ``htb_fused`` call.  In training with ``drop`` or ``drop_path``
    the tail runs plain, with the FFN's two dropouts and stochastic depth
    around both residual branches (JAX ``hit_sir_pro.py:774-790``); else
    the tail kernel."""

    def __init__(self, dim: int, num_heads: int, base_win_size, window_size,
                 mlp_ratio: float = 2.0, is_channel_spatial_attn: bool = True,
                 fused_htb: bool = False, drop: float = 0.0, value_drop: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop = drop
        self.drop_path = drop_path
        self.window_size = tuple(window_size)
        wh, ww = self.window_size
        # JAX's semantic conditions (hit_sir_pro.py:698-706, htb_block.py:212);
        # its TPU-layout ones (w % 8, (wh*w) % 128, wh*w <= 8192, the FFN
        # row tile equal to wh) size VMEM blocks and have no counterpart here
        self.fused_htb = (fused_htb and is_channel_spatial_attn
                          and min(wh, base_win_size[0]) == wh
                          and min(ww, base_win_size[1]) == ww)
        self.norm1 = nn.LayerNorm(dim)
        self.correlation = SCC(dim, base_win_size, window_size, num_heads,
                               is_channel_spatial_attn, value_drop, drop)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = ConvFFN(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, emit_stats: bool = False, stats=None,
                deterministic: bool = True, generator: drop.Rng = None):
        """``deterministic=False`` (training, JAX's flag) drops ``stats``
        and runs no ``htb_fused``; its dropouts draw from ``generator``;
        ``emit_stats`` is for evaluation."""
        _, h, w, _ = x.shape
        dt = x.dtype
        if not deterministic:
            stats = None
        tail = derived(self, "tail", dt, x.device, lambda: self._tail_weights(dt),
                       sources=(self.norm1, self.mlp, self.norm2))
        if (self.fused_htb and deterministic and h % self.window_size[0] == 0
                and w % self.window_size[1] == 0):
            sca, rest = self.correlation.bundle(x, stats)
            return htb_fused(x, sca, *rest, self.correlation.num_heads, self.window_size,
                             *tail, emit_stats=emit_stats)
        xp = pad_to_multiple(x, self.window_size)
        if stats is not None and xp.shape[1:3] != (h, w):
            # the threaded stats describe the UNPADDED x: channel pools
            # commute with the reflect padding (pad the maps), the global
            # max is unchanged, the global sum gains the pad strips
            cmean, cmax, ssum, smax = stats
            cmean = pad_to_multiple(cmean[..., None], self.window_size)[..., 0]
            cmax = pad_to_multiple(cmax[..., None], self.window_size)[..., 0]
            f32 = torch.float32
            ssum = (ssum + xp[:, h:, :w].to(f32).sum(dim=(1, 2))
                    + xp[:, :, w:].to(f32).sum(dim=(1, 2)))
            stats = (cmean, cmax, ssum, smax)
        attn = self.correlation(xp, stats=stats, deterministic=deterministic,
                                generator=generator)
        if not deterministic and (self.drop > 0.0 or self.drop_path > 0.0):
            return self._tail_with_dropout(attn[:, :h, :w], x, *tail, generator)

        args = (x,) + tail
        # the (possibly window-padded) attn goes in whole: the tail reads
        # only its first h rows and w columns
        if emit_stats:
            return htb_tail_stats(attn, *args)
        return htb_tail(attn, *args)

    def _tail_with_dropout(self, attn, shortcut, ln1_s, ln1_b, w1, b1, dw, dwb, w2, b2,
                           ln2_s, ln2_b, rng: drop.Rng) -> torch.Tensor:
        """The tail's plain composition (``htb_tail_reference``) with the
        dropouts of training."""
        x = shortcut + drop.drop_path(layer_norm(attn, ln1_s, ln1_b), self.drop_path, rng)
        h = F.gelu(x @ w1 + b1)
        h = drop.dropout(h + F.gelu(depthwise_conv_reference(h, dw, dwb)), self.drop, rng)
        y = drop.dropout(h @ w2 + b2, self.drop, rng)
        return x + drop.drop_path(layer_norm(y, ln2_s, ln2_b), self.drop_path, rng)

    def _tail_weights(self, dt):
        mlp = self.mlp
        dw = mlp.dwconv.depthwise_conv[0]
        ws = (self.norm1.weight, self.norm1.bias, mlp.fc1.weight.t(), mlp.fc1.bias,
              dw.weight[:, 0].permute(1, 2, 0), dw.bias, mlp.fc2.weight.t(),
              mlp.fc2.bias, self.norm2.weight, self.norm2.bias)
        return tuple(t.to(dt).contiguous() for t in ws)


class ResidualGroup(nn.Module):
    """Holds the blocks under the reference's name (``residual_group.blocks``)."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RHTB(nn.Module):
    """depth x HTB with hierarchical windows, then 3x3 conv + residual, or
    with ``resi_connection='3conv'`` the reference's three-conv squeeze
    (reference :755-936, :911-918), plain convs as in JAX.  In evaluation
    (``deterministic``) each block's tail kernel emits the SCA pool
    statistics the next block needs; in training, and with
    ``use_checkpoint``, every block pools its own input (JAX's ``thread``).
    ``use_checkpoint`` recomputes each block in the backward
    (``torch.utils.checkpoint``; JAX's ``nn.remat``), replaying the
    block's dropout draws (``_checkpointed``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, base_win_size,
                 window_sizes, mlp_ratio: float = 2.0,
                 is_channel_spatial_attn: bool = True, fused_htb: bool = False,
                 drop: float = 0.0, value_drop: float = 0.0, drop_paths: Sequence[float] = (),
                 use_checkpoint: bool = False, resi_connection: str = "1conv"):
        super().__init__()
        if resi_connection not in ("1conv", "3conv"):
            raise ValueError(f"resi_connection must be '1conv' or '3conv', got "
                             f"{resi_connection!r}")
        self.is_channel_spatial_attn = is_channel_spatial_attn
        self.use_checkpoint = use_checkpoint
        self.residual_group = ResidualGroup([
            HierarchicalTransformerBlock(dim, num_heads, base_win_size,
                                         window_sizes[i], mlp_ratio,
                                         is_channel_spatial_attn, fused_htb, drop, value_drop,
                                         drop_paths[i] if drop_paths else 0.0)
            for i in range(depth)])
        if resi_connection == "1conv":
            self.conv = nn.Conv2d(dim, dim, 3, padding=1)
        else:
            self.conv = nn.Sequential(
                nn.Conv2d(dim, dim // 4, 3, padding=1), nn.LeakyReLU(0.2, inplace=True),
                nn.Conv2d(dim // 4, dim // 4, 1), nn.LeakyReLU(0.2, inplace=True),
                nn.Conv2d(dim // 4, dim, 3, padding=1))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: drop.Rng = None) -> torch.Tensor:
        blocks = self.residual_group.blocks
        thread = deterministic and not self.use_checkpoint
        remat = self.use_checkpoint and torch.is_grad_enabled()
        y, stats = x, None
        for i, block in enumerate(blocks):
            want = thread and i + 1 < len(blocks) and self.is_channel_spatial_attn
            if remat:
                y = _checkpointed(block, y, deterministic, generator)
                continue
            out = block(y, emit_stats=want, stats=stats, deterministic=deterministic,
                        generator=generator)
            y, stats = out if want else (out, None)
        if isinstance(self.conv, nn.Sequential):
            y = F.leaky_relu(conv_nhwc(y, self.conv[0]), 0.2)
            y = F.leaky_relu(conv_nhwc(y, self.conv[2]), 0.2)
            return x + conv_nhwc(y, self.conv[4])
        return conv3x3(y, x, *conv_weights(self.conv, x.dtype, x.device), "none")


def _checkpointed(block: nn.Module, y: torch.Tensor, deterministic: bool,
                  rng: drop.Rng) -> torch.Tensor:
    """``block(y)`` under ``torch.utils.checkpoint``, whose recompute in
    the backward draws the forward's dropout masks again: checkpoint
    restores torch's default generators only, so the recompute draws from
    a copy of the caller's generator as it stood before the forward (the
    caller's generator advances once, as without checkpointing).  The
    recompute runs on the backward's thread: a forward inside
    ``plain_versions()`` recomputes inside it too."""
    rng = drop.as_rng(rng)
    g = rng.generator
    state = None if g is None or deterministic else g.get_state()
    plain = in_plain_versions()
    calls = []

    def run(y):
        r = rng
        if calls and state is not None:          # the recompute
            replay = torch.Generator(device=g.device)
            replay.set_state(state)
            r = rng._replace(generator=replay)
        calls.append(1)
        with plain_versions() if plain else nullcontext():
            return block(y, deterministic=deterministic, generator=r)

    return checkpoint(run, y, use_reentrant=False)


def _folded_up2(conv: nn.Conv2d, dt):
    """conv3x3(nearest_x2(x)) as one conv to 4x the channels, packed:
    nearest upsampling repeats each pixel 2x2, so per output phase (a, b)
    the 3x3 taps collapse onto at most 2x2 source pixels, and the phase
    kernels go in column-phase-major order, so that the conv's output is
    the packed form of the x2 map (``pixel_shuffle_phase_major``).  Returns
    the (3, 3, Cin, 4F) kernel and the bias tiled x4, in dt
    (``hit_sir_pro.py`` NearestConvUp2, ``emit_packed``)."""
    kernel = conv.weight.permute(2, 3, 1, 0)                  # HWIO
    cin, feat = kernel.shape[2], kernel.shape[3]

    def fold(w, phase, axis):
        rows = [w.select(axis, i) for i in range(3)]
        zero = torch.zeros_like(rows[0])
        new = ([rows[0], rows[1] + rows[2], zero] if phase == 0
               else [zero, rows[0] + rows[1], rows[2]])
        return torch.stack(new, dim=axis)

    phases = [fold(fold(kernel, a, 0), b, 1) for a in (0, 1) for b in (0, 1)]
    k_full = torch.stack([phases[2 * a + b] for b in (0, 1) for a in (0, 1)],
                         dim=3).reshape(3, 3, cin, feat * 4)
    return k_full.to(dt).contiguous(), conv.bias.repeat(4).to(dt)


class UnionAttention(nn.Module):
    """Joint C/H/W attention parameters (reference :104-133): the 3x3 convs
    of the mean/max pool pairs over C, H and W, and conv_last over the sum
    of their broadcast maps.  The math is ``fused_fusion``'s."""

    def __init__(self, channels: int):
        super().__init__()
        for name in ("conv1", "conv2", "conv3"):
            setattr(self, name, nn.Conv2d(2, 1, 3, padding=1))
        self.conv_last = nn.Conv2d(channels, channels, 3, padding=1)

    def raw(self):
        """((kernel HWIO, bias) of conv1, conv2, conv3, conv_last)."""
        return tuple((cv.weight.permute(2, 3, 1, 0).contiguous(), cv.bias)
                     for cv in (self.conv1, self.conv2, self.conv3, self.conv_last))


class Fusion(nn.Module):
    """Deep/shallow fusion gate (reference :136-162), called as
    ``fusion(deep, shallow)`` like the reference call site: the first
    positional argument takes the deep output (the reference's parameter
    names are swapped; parity is with the positional semantics)."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        for i in (1, 2, 3):
            setattr(self, f"union_attention{i}", UnionAttention(channels))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        def make():
            raws = tuple(getattr(self, f"union_attention{i}").raw() for i in (1, 2, 3))
            # the kernel's weights; gradients reach raws through fused_fusion
            with torch.no_grad():
                packed = pack_params(raws, self.channels, a.dtype)
            return raws, packed

        raws, packed = derived(self, "fusion", a.dtype, a.device, make)
        return fused_fusion(a, b, raws, packed)


class PatchEmbed(nn.Module):
    """Holds the patch LayerNorm under the reference's name."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


class HiTSIR(nn.Module):
    """HiT-SIR-Pro network (reference :1065-1344).  NHWC input in [0,1].

    Shallow extraction: MSCE, or one 3x3 conv (``conv_first``) with
    ``is_mult_size_conv_feat_extract=False``.  Heads (``upsampler``):
    'nearest+conv' (x4 only, the packed head), 'pixelshuffle' (x2, x4:
    ``conv_before_upsample``, then ``upsample.{0,2,..}`` conv + shuffle,
    ``conv_last``), 'pixelshuffledirect' (``upsample.0`` conv + one
    shuffle), anything else the denoise head (input + ``conv_last``).
    ``conv_after_body`` and ``conv_before_upsample`` run on the conv3x3
    kernel on every head, the Fusion gate on its kernels; the shallow
    conv and the pixel-shuffle heads' convs are plain ``F.conv2d``, as
    JAX computes them outside its kernels.  The parameters are initialised
    as the reference's (every Linear trunc-normal 0.02, bias 0), so that
    under one seed the state dict is the reference's.  ``head_packed``
    makes ``stage='head'`` return the packed (B, H, W/16, 16*in_chans)
    layout (JAX's attribute, set by ``BandedHeadSR``); ``fused_htb`` runs
    the degenerate-window blocks as one ``htb_fused`` call each.  Neither
    adds parameters.

    The reference's other options, with JAX's semantics: ``drop_rate``
    (``pos_drop``, the FFN's dropouts, the projection's), ``value_drop_rate``
    (SCC's values), ``drop_path_rate`` (stochastic depth, linspace over all
    blocks), all active only in training; ``ape`` (an absolute position
    embedding over ``img_size`` x ``img_size`` maps, trunc-normal 0.02:
    another input size raises); ``resi_connection='3conv'``;
    ``use_checkpoint`` (each block recomputed in the backward, no stats
    threading).  A block in training with a dropout runs SCC (value
    dropout) or its tail (the other two) plain, as JAX does; every other
    call keeps its kernel."""

    def __init__(self, is_mult_size_conv_feat_extract: bool = True,
                 is_channel_spatial_attn: bool = True, is_fusion: bool = True,
                 in_chans: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 base_win_size: Tuple[int, int] = (8, 8),
                 mlp_ratio: float = 2.0, upscale: int = 4,
                 img_range: float = 1.0, upsampler: str = "nearest+conv",
                 hier_win_ratios: Sequence[float] = (0.5, 1, 2, 4, 6, 8, 10, 12),
                 num_feat: int = 64, dtype: torch.dtype = torch.float32,
                 head_packed: bool = False, fused_htb: bool = False,
                 drop_rate: float = 0.0, value_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, ape: bool = False, img_size: int = 64,
                 resi_connection: str = "1conv", use_checkpoint: bool = False):
        super().__init__()
        if upsampler == "nearest+conv" and upscale != 4:
            raise ValueError(f"the nearest+conv head is x4 only (got x{upscale})")
        if upsampler == "pixelshuffle" and upscale not in (2, 4):
            raise ValueError(f"the pixelshuffle head is x2 or x4 (got x{upscale})")
        c = embed_dim
        self.in_chans = in_chans
        self.img_range = img_range
        self.upscale = upscale
        self.upsampler = upsampler
        self.dtype = dtype
        self.head_packed = head_packed
        self.drop_rate = drop_rate
        self.value_drop_rate = value_drop_rate
        self.drop_path_rate = drop_path_rate
        self.img_size = img_size
        wins = tuple((int(base_win_size[0] * r), int(base_win_size[1] * r))
                     for r in hier_win_ratios)
        self.conv_first = (MultipleSizeConvExtract(in_chans, c) if is_mult_size_conv_feat_extract
                           else nn.Conv2d(in_chans, c, 3, padding=1))
        # registered here for the reference's state-dict order
        self.fusion = Fusion(c) if is_fusion else None
        self.patch_embed = PatchEmbed(c)
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, img_size * img_size, c))
            with torch.no_grad():
                self.absolute_pos_embed.normal_(0.0, 0.02).clamp_(-2.0, 2.0)
        # stochastic-depth decay: linspace over all blocks (reference :1193)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        offs = np.cumsum((0,) + tuple(depths)).tolist()
        self.layers = nn.ModuleList([
            RHTB(c, depth, num_heads[i], tuple(base_win_size), wins, mlp_ratio,
                 is_channel_spatial_attn, fused_htb, drop_rate, value_drop_rate,
                 dpr[offs[i]:offs[i] + depth], use_checkpoint, resi_connection)
            for i, depth in enumerate(depths)])
        self.norm = nn.LayerNorm(c)
        self.conv_after_body = nn.Conv2d(c, c, 3, padding=1)
        # the reference's heads (:1235-1262), in its construction order
        if upsampler in ("pixelshuffle", "nearest+conv"):
            self.conv_before_upsample = nn.Sequential(
                nn.Conv2d(c, num_feat, 3, padding=1), nn.LeakyReLU(inplace=True))
        if upsampler == "pixelshuffle":
            ups = []
            for _ in range(int(np.log2(upscale))):
                ups += [nn.Conv2d(num_feat, 4 * num_feat, 3, padding=1), nn.PixelShuffle(2)]
            self.upsample = nn.Sequential(*ups)
            self.conv_last = nn.Conv2d(num_feat, in_chans, 3, padding=1)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                nn.Conv2d(c, upscale ** 2 * in_chans, 3, padding=1), nn.PixelShuffle(upscale))
        elif upsampler == "nearest+conv":
            self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
            self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
            self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, padding=1)
            self.conv_last = nn.Conv2d(num_feat, in_chans, 3, padding=1)
        else:
            self.conv_last = nn.Conv2d(c, in_chans, 3, padding=1)
        self._init_linears()

    def _init_linears(self):
        """The reference's init pass (its ``_init_weights``, applied after
        construction): every Linear weight trunc-normal with std 0.02,
        drawn as ``normal_`` then ``clamp_`` to [-2, 2] in module order,
        every Linear bias 0; LayerNorm and conv keep torch's defaults."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    m.weight.normal_(0.0, 0.02).clamp_(-2.0, 2.0)
                    nn.init.zeros_(m.bias)

    def _x4_head(self, y: torch.Tensor, packed: bool = False) -> torch.Tensor:
        """The packed nearest+conv x4 tail (``hit_sir_pro.py`` _x4_head,
        :1014-1042, as the JAX package runs it on its chip): conv_up1 emits
        the packed x2 map, conv_up2 reads it through the shuffled conv and
        emits the packed x4 map, and conv_hr + conv_last read that in one
        kernel; no pixel shuffle is ever materialized.  With ``packed``
        that kernel writes the packed layout (the width 4*w1 must be a
        multiple of 16)."""
        dt, dev = y.dtype, y.device
        y = conv3x3(y, None, *derived(self.conv_up1, "up2", dt, dev,
                                      lambda: _folded_up2(self.conv_up1, dt)), "leaky2")
        y = conv3x3_shuffled(y, *derived(self.conv_up2, "up2", dt, dev,
                                         lambda: _folded_up2(self.conv_up2, dt)), "leaky2")
        tail = conv3x3_shuffled_tail_packed if packed else conv3x3_shuffled_tail
        return tail(y, *conv_weights(self.conv_hr, dt, dev), "leaky2",
                    *conv_weights(self.conv_last, dt, dev))

    def forward(self, x: torch.Tensor, stage: str = "full", deterministic: bool = True,
                generator: drop.Rng = None) -> torch.Tensor:
        """``stage``: 'full' the whole network; 'features' stops at the
        pre-upsample feature map (B, H, W, num_feat), without the mean
        added back; 'head' takes that map and returns the x4 head's output
        plus the mean, uncropped (packed with ``head_packed``, the mean
        then tiled to match).  ``deterministic=False``: the training
        forward (see the module docstring), its dropout masks drawn from
        ``generator``: a ``torch.Generator`` on the input's device (None:
        torch's default one), or an ``ops.dropout.DropoutRng`` that also
        names this rank's slice of the global batch.  Inside
        ``replayed_forwards()`` (``TiledSR``'s tiles) a forward without grad
        on a card replays as a CUDA graph per signature
        (``ops/kernels/autograd.py::replayed_forward``)."""
        return replayed_forward(
            self, lambda t: self._forward(t, stage, deterministic, generator), x,
            (self.dtype, self.head_packed, stage), deterministic)

    def _forward(self, x: torch.Tensor, stage: str, deterministic: bool,
                 generator: drop.Rng) -> torch.Tensor:
        if stage not in ("full", "features", "head"):
            raise ValueError(f"unknown stage {stage!r}")
        if stage != "full" and self.upsampler != "nearest+conv":
            raise ValueError(f"stage {stage!r} needs the nearest+conv head")
        _, h, w, cin = x.shape
        dt = self.dtype
        x = x.to(dt)
        if stage == "head":
            mean = device_constant(_input_mean, (self.in_chans,), dt, x.device)
            out = self._x4_head(x, self.head_packed)
            if out.shape[-1] != self.in_chans and mean.numel() == self.in_chans:
                mean = mean.repeat(out.shape[-1] // self.in_chans)
            return out / self.img_range + mean
        mean = device_constant(_input_mean, (cin,), dt, x.device)
        x = (x - mean) * self.img_range

        if isinstance(self.conv_first, MultipleSizeConvExtract):
            shallow = self.conv_first(x, dt)
        else:
            shallow = conv_nhwc(x, self.conv_first)
        feat = _layer_norm_slabs(shallow, self.patch_embed.norm.weight,
                                 self.patch_embed.norm.bias)
        if hasattr(self, "absolute_pos_embed"):
            if (h, w) != (self.img_size, self.img_size):
                raise ValueError(f"ape: the position embedding covers {self.img_size}x"
                                 f"{self.img_size} maps, not {h}x{w}")
            feat = feat + self.absolute_pos_embed.reshape(1, h, w, -1).to(dt)
        if not deterministic:
            feat = drop.dropout(feat, self.drop_rate, generator)
        for layer in self.layers:
            feat = layer(feat, deterministic, generator)
        feat = _layer_norm_slabs(feat, self.norm.weight, self.norm.bias)
        deep = conv3x3(feat, None, *conv_weights(self.conv_after_body, dt, x.device), "none")
        y = self.fusion(deep, shallow) if self.fusion is not None else deep + shallow
        if self.upsampler in ("pixelshuffle", "nearest+conv"):
            y = conv3x3(y, None, *conv_weights(self.conv_before_upsample[0], dt, x.device),
                        "leaky")
        if stage == "features":
            return y
        if self.upsampler == "nearest+conv":
            y = self._x4_head(y)
        elif self.upsampler == "pixelshuffle":
            for conv in self.upsample[::2]:
                y = pixel_shuffle(conv_nhwc(y, conv), 2)
            y = conv_nhwc(y, self.conv_last)
        elif self.upsampler == "pixelshuffledirect":
            y = pixel_shuffle(conv_nhwc(y, self.upsample[0]), self.upscale)
        else:
            y = x + conv_nhwc(y, self.conv_last)
        y = y / self.img_range + mean
        return y[:, :h * self.upscale, :w * self.upscale, :]


def flagship_config(**overrides) -> dict:
    """The configuration trained by the reference (main.py:26-32)."""
    cfg = dict(
        is_mult_size_conv_feat_extract=True,
        is_channel_spatial_attn=True,
        is_fusion=True,
        embed_dim=180,
        depths=(6, 6, 6, 6, 6, 6),
        num_heads=(6, 6, 6, 6, 6, 6),
        base_win_size=(8, 8),
        mlp_ratio=2.0,
        upsampler="nearest+conv",
        hier_win_ratios=(0.5, 1, 2, 4, 6, 8, 10, 12),
        upscale=4,
    )
    cfg.update(overrides)
    return cfg
