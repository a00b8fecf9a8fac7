"""Deformable convolution (DCNv1/v2) and deformable attention in plain
PyTorch (port of ``sisr_tpu/ops/deform.py``): every (output position,
kernel tap) is sampled bilinearly with one gather, and taps x channels are
contracted against the weight in one matmul, as the JAX package does.

Library surface: the reference's CUDA extensions
(``BasicSR_master/basicsr/ops/dcn/``, ``KAIR_master/models/op/deform_attn``)
are inert even there (EDVR- and VRT-class models only).

Layouts are NHWC:
  x       (B, H, W, Cin)
  offset  (B, Hout, Wout, 2*dg*Kh*Kw)   torch's channel order: per
                                        deformable group g, tap k, (dy, dx)
  mask    (B, Hout, Wout, dg*Kh*Kw)     DCNv2 modulation (None: v1)
  weight  (Kh, Kw, Cin, Cout)
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _bilinear_gather(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) sampled at fractional (py, px) of shape (B, P, K):
    (B, P, K, C).  A corner outside the map contributes zero (the CUDA
    kernels' zero padding at the sampled coordinates)."""
    b, h, w, c = x.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = (py - y0)[..., None].to(x.dtype), (px - x0)[..., None].to(x.dtype)
    flat = x.reshape(b, h * w, c)

    def corner(yi, xi):
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()).reshape(b, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals.reshape(*py.shape, c) * valid[..., None].to(x.dtype)

    return ((1 - wy) * (1 - wx) * corner(y0, x0) + (1 - wy) * wx * corner(y0, x0 + 1)
            + wy * (1 - wx) * corner(y0 + 1, x0) + wy * wx * corner(y0 + 1, x0 + 1))


def _base_grid(hout: int, wout: int, kh: int, kw: int, stride: Tuple[int, int],
               pad: Tuple[int, int], dil: Tuple[int, int], device) -> Tuple[torch.Tensor, ...]:
    """The undeformed sampling grid, (1, P, 1, K) each for y and x: output
    position * stride - pad + dilation * tap."""
    oy = torch.arange(hout, device=device) * stride[0] - pad[0]
    ox = torch.arange(wout, device=device) * stride[1] - pad[1]
    ty = torch.arange(kh, device=device) * dil[0]
    tx = torch.arange(kw, device=device) * dil[1]
    shape = (hout, wout, kh, kw)
    base_y = (oy[:, None, None, None] + ty[None, None, :, None]).expand(shape)
    base_x = (ox[None, :, None, None] + tx[None, None, None, :]).expand(shape)
    p, k = hout * wout, kh * kw
    return (base_y.reshape(1, p, 1, k).float(), base_x.reshape(1, p, 1, k).float())


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                  stride: IntPair = 1, padding: IntPair = 1, dilation: IntPair = 1,
                  deformable_groups: int = 1) -> torch.Tensor:
    """Modulated (``mask`` given) or plain deformable 2-D convolution, the
    semantics of ``torchvision.ops.deform_conv2d`` / BasicSR's
    ModulatedDeformConv (basicsr/ops/dcn/deform_conv.py:244-285) on the
    module docstring's NHWC layouts."""
    b, h, w, cin = x.shape
    kh, kw, wcin, cout = weight.shape
    if wcin != cin:
        raise ValueError(f"weight takes {wcin} channels, x has {cin}")
    sy, sx = _pair(stride)
    py, px = _pair(padding)
    dy, dx = _pair(dilation)
    k, dg = kh * kw, deformable_groups
    if cin % dg:
        raise ValueError(f"{cin} channels in {dg} deformable groups")
    hout = (h + 2 * py - dy * (kh - 1) - 1) // sy + 1
    wout = (w + 2 * px - dx * (kw - 1) - 1) // sx + 1
    if tuple(offset.shape) != (b, hout, wout, 2 * dg * k):
        raise ValueError(f"offset {tuple(offset.shape)}, want {(b, hout, wout, 2 * dg * k)}")
    p = hout * wout
    base_y, base_x = _base_grid(hout, wout, kh, kw, (sy, sx), (py, px), (dy, dx), x.device)
    off = offset.reshape(b, p, dg, k, 2).float()
    samp_y, samp_x = base_y + off[..., 0], base_x + off[..., 1]       # (B, P, dg, K)

    cpg = cin // dg
    cols = []
    for g in range(dg):
        v = _bilinear_gather(x[..., g * cpg:(g + 1) * cpg], samp_y[:, :, g], samp_x[:, :, g])
        if mask is not None:
            v = v * mask.reshape(b, p, dg, k)[:, :, g, :, None].to(v.dtype)
        cols.append(v)
    col = torch.cat(cols, dim=-1)                                      # (B, P, K, Cin)
    y = col.reshape(b, p, k * cin) @ weight.reshape(k * cin, cout).to(col.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(b, hout, wout, cout)


def deform_attn(q: torch.Tensor, kv: torch.Tensor, offset: torch.Tensor,
                window: IntPair = (3, 3), stride: int = 1, padding: Optional[int] = None,
                dilation: int = 1, attention_heads: int = 1,
                deformable_groups: int = 1) -> torch.Tensor:
    """Deformable attention (the reference's CUDA extension,
    KAIR_master/models/op/deform_attn.py:53-104): per output position and
    clip, K = kh*kw points are sampled bilinearly from k and v at the deform
    conv's grid plus the learned offsets, per deformable group; each head
    softmax-attends q(p)/sqrt(d) over the clip_size*K sampled keys and
    averages the sampled values (deform_attn_cuda_pt110.cpp:103-112).

    q (B, H, W, C); kv (B, clip, H, W, 2C), k | v on the channel axis;
    offset (B, clip, H, W, dg*K*2), per group g, tap t: (dy, dx).
    Returns (B, H, W, C)."""
    b, h, w, c = q.shape
    clip = kv.shape[1]
    kh, kw = _pair(window)
    k, dg, heads = kh * kw, deformable_groups, attention_heads
    pad = kh // 2 if padding is None else padding
    if stride != 1:
        raise ValueError("the reference module only instantiates stride 1")
    if tuple(kv.shape) != (b, clip, h, w, 2 * c):
        raise ValueError(f"kv {tuple(kv.shape)}, want {(b, clip, h, w, 2 * c)}")
    if tuple(offset.shape) != (b, clip, h, w, dg * k * 2):
        raise ValueError(f"offset {tuple(offset.shape)}, want {(b, clip, h, w, dg * k * 2)}")
    if c % dg or c % heads:
        raise ValueError(f"{c} channels in {dg} groups and {heads} heads")
    d, p, cpg = c // heads, h * w, c // dg
    f32 = torch.float32
    base_y, base_x = _base_grid(h, w, kh, kw, (1, 1), (pad, pad), (dilation, dilation),
                                q.device)

    ks_list, vs_list = [], []
    for n in range(clip):
        off = offset[:, n].reshape(b, p, dg, k, 2).float()
        sy, sx = base_y + off[..., 0], base_x + off[..., 1]
        kcols, vcols = [], []
        for g in range(dg):
            kg = kv[:, n, :, :, g * cpg:(g + 1) * cpg]
            vg = kv[:, n, :, :, c + g * cpg:c + (g + 1) * cpg]
            kcols.append(_bilinear_gather(kg, sy[:, :, g], sx[:, :, g]))
            vcols.append(_bilinear_gather(vg, sy[:, :, g], sx[:, :, g]))
        ks_list.append(torch.cat(kcols, dim=-1))
        vs_list.append(torch.cat(vcols, dim=-1))
    ks = torch.stack(ks_list, dim=2).reshape(b, p, clip * k, heads, d)
    vs = torch.stack(vs_list, dim=2).reshape(b, p, clip * k, heads, d)

    qh = q.reshape(b, p, heads, d).to(f32) * (float(d) ** -0.5)
    attn = torch.softmax(torch.einsum("bphd,bpshd->bphs", qh, ks.to(f32)), dim=-1)
    out = torch.einsum("bphs,bpshd->bphd", attn, vs.to(f32))
    return out.reshape(b, h, w, c).to(q.dtype)
