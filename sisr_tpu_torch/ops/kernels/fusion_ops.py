"""The deep/shallow Fusion gate: its nine pool pairs, and the whole gate
with the linear split of each UnionAttention's conv_last.

Ports of ``sisr_tpu/ops/pallas/fusion_ops.py``:

    fusion_pools    _fusion_pools_pallas   csrc/fusion.cu fusion_pools_launch
    fused_fusion    _fused_fusion_pallas   csrc/fusion.cu fusion_pools_launch,
                                           then fusion_maps_gate_launch

each over its plain version (``fusion_pools_reference``,
``fused_fusion_reference``, which equals the Fusion module's math).

Pools, slot order ``[a_mean, a_max, ab_mean, ab_max, b_mean, b_max]``:

    cp3 (B, 6, H, W)  over C, in a.dtype
    hp3 (B, 6, W, C)  over H, float32
    wp3 (B, 6, H, C)  over W, in a.dtype

``raws`` are the three UnionAttentions' conv parameters as in the JAX
package: ``((c1k, c1b), (c2k, c2b), (c3k, c3b), (clk, clb))`` each, HWIO
kernels.  ``pack_params`` derives the kernel's weights from them.

Gradients are the JAX ``custom_vjp``s' (``fusion_ops.py:163-181,
:492-510``): the vjp of the plain version recomputed from the saved
inputs.  ``fused_fusion``'s differentiable inputs are a, b and raws; the
packed weights are derived from raws and get no gradient of their own.
"""

from __future__ import annotations

import ctypes

import torch

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.autograd import KernelFunction
from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_reference


def fusion_pools_reference(a, b):
    """cp3, hp3, wp3 as in the module docstring."""
    f32 = torch.float32
    cps, hps, wps = [], [], []
    for s in (a, a + b, b):
        sf = s.to(f32)
        cps += [sf.mean(-1).to(a.dtype), s.amax(-1)]
        hps += [sf.mean(1), s.amax(1).to(f32)]
        wps += [sf.mean(2).to(a.dtype), s.amax(2)]
    return torch.stack(cps, 1), torch.stack(hps, 1), torch.stack(wps, 1)


def _fusion_pools_cuda(a, b):
    bsz, h, w, c = a.shape
    if tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"fusion_pools: a {tuple(a.shape)} != b {tuple(b.shape)}")
    dt = a.dtype
    build.check_cuda("fusion_pools", a.device, dt, a=a, b=b)
    cp3 = torch.empty((bsz, 6, h, w), dtype=dt, device=a.device)
    hp3 = torch.empty((bsz, 6, w, c), dtype=torch.float32, device=a.device)
    wp3 = torch.empty((bsz, 6, h, c), dtype=dt, device=a.device)
    fn = build.library("fusion").fusion_pools_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    code = fn(build.DTYPE_CODES[dt], build.ptr(a), build.ptr(b), build.ptr(cp3),
              build.ptr(hp3), build.ptr(wp3), bsz, h, w, c, build.stream(a.device))
    build.raise_on_error("fusion_pools", code)
    build.launches["fusion_pools"] += 1
    return cp3, hp3, wp3


FUSION_POOLS = KernelFunction(_fusion_pools_cuda, fusion_pools_reference)


def fusion_pools(a, b, reference: bool = False):
    """All nine Fusion pool pairs of a, a + b and b.  A CPU tensor runs the
    plain version; a CUDA tensor the kernel unless ``reference=True``."""
    if reference or a.device.type == "cpu":
        return fusion_pools_reference(a, b)
    return FUSION_POOLS(a, b)


def _ua_raw_reference(pools, raw, dt):
    """One UnionAttention from its pools and raw params (the module math).
    pools: cp (B,H,W,2), hp (B,W,C,2), wp (B,H,C,2)."""
    (c1k, c1b), (c2k, c2b), (c3k, c3b), (clk, clb) = raw
    cp, hp, wp = pools

    def conv(t, k, bias):
        return conv3x3_reference(t.to(dt), None, k, bias, "none")

    c_att = conv(cp, c1k, c1b)                                  # (B,H,W,1)
    # the H pool convolves over the grid (C, W), the W pool over (C, H)
    h_att = conv(hp.permute(0, 2, 1, 3), c2k, c2b)[..., 0]      # (B,C,W)
    h_att = h_att.permute(0, 2, 1)[:, None]                     # (B,1,W,C)
    w_att = conv(wp.permute(0, 2, 1, 3), c3k, c3b)[..., 0]      # (B,C,H)
    w_att = w_att.permute(0, 2, 1)[:, :, None]                  # (B,H,1,C)
    return conv(c_att + h_att + w_att, clk, clb)


def fused_fusion_reference(a, b, raws):
    """The Fusion module's math: ``a * sigmoid(ua1(a) * g) + b *
    sigmoid(ua3(b) * (1 - g))`` with ``g = sigmoid(ua2(a + b))``."""
    dt = a.dtype
    cp3, hp3, wp3 = fusion_pools_reference(a, b)

    def pools(k):
        return tuple(t[:, 2 * k:2 * k + 2].to(dt).permute(0, 2, 3, 1)
                     for t in (cp3, hp3, wp3))

    a_att = _ua_raw_reference(pools(0), raws[0], dt)
    gate = torch.sigmoid(_ua_raw_reference(pools(1), raws[1], dt))
    b_att = _ua_raw_reference(pools(2), raws[2], dt)
    return (a * torch.sigmoid(a_att * gate)
            + b * torch.sigmoid(b_att * (1.0 - gate)))


def pack_params(raws, c: int, dt):
    """The kernel's weights from the three UAs' raw params, rounded as the
    TPU kernel's ``_pack_params``: c1w/c2w/c3w (3, 18) taps [ch*9 + a*3 +
    b], cb (9,) biases [c1b, c2b, c3b] per UA, clb (3, C) in float32; the
    folded conv_last kernels khw (3, 18, C, C) = [sum_i K[i,j] | K[0,j] |
    K[2,j] | sum_j K[i,j] | K[i,0] | K[i,2]] and the channel-summed taps
    k1blk (27, 3C), block-diagonal per UA, in ``dt``."""
    f32 = torch.float32
    c1w, c2w, c3w, cb, khw, clb, k1s = [], [], [], [], [], [], []
    for (c1, c2, c3, cl) in raws:
        for (kk, _), dst in zip((c1, c2, c3), (c1w, c2w, c3w)):
            dst.append(kk[:, :, :, 0].permute(2, 0, 1).reshape(18))
        cb.append(torch.stack([c1[1][0], c2[1][0], c3[1][0]]))
        clk = cl[0].to(f32)                                       # (3,3,C,C)
        rows, cols = clk.sum(0), clk.sum(1)
        khw.append(torch.stack([rows[j] for j in range(3)] + [clk[0, j] for j in range(3)]
                               + [clk[2, j] for j in range(3)] + [cols[i] for i in range(3)]
                               + [clk[i, 0] for i in range(3)] + [clk[i, 2] for i in range(3)]))
        clb.append(cl[1])
        k1s.append(clk.sum(2).reshape(9, c))
    k1blk = torch.zeros((27, 3 * c), dtype=f32, device=k1s[0].device)
    for k in range(3):
        k1blk[9 * k:9 * (k + 1), k * c:(k + 1) * c] = k1s[k]
    return (torch.stack(c1w).to(f32), torch.stack(c2w).to(f32), torch.stack(c3w).to(f32),
            torch.stack(cb).reshape(9).to(f32), torch.stack(khw).to(dt).contiguous(),
            torch.stack(clb).to(f32), k1blk.to(dt))


def _fused_fusion_cuda(a, b, packed):
    bsz, h, w, c = a.shape
    dt = a.dtype
    shapes = ((3, 18), (3, 18), (3, 18), (9,), (3, 18, c, c), (3, c), (27, 3 * c))
    types = (torch.float32,) * 4 + (dt, torch.float32, dt)
    packed = tuple(build.as_arg(t, ty) for t, ty in zip(packed, types))
    for t, s in zip(packed, shapes):
        if tuple(t.shape) != s:
            raise ValueError(f"fused_fusion: packed weight {tuple(t.shape)} != {s}")
        if t.device != a.device:
            raise TypeError(f"fused_fusion: a packed weight lies on {t.device}")
    cp3, hp3, wp3 = _fusion_pools_cuda(a, b)
    scratch = torch.empty(bsz * (3 * h * w + 9 * w * c + 9 * h * c), dtype=torch.float32,
                          device=a.device)
    out = torch.empty_like(a)
    fn = build.library("fusion").fusion_maps_gate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    code = fn(build.DTYPE_CODES[dt], build.ptr(a), build.ptr(b), build.ptr(cp3),
              build.ptr(hp3), build.ptr(wp3), *[build.ptr(t) for t in packed],
              build.ptr(scratch), build.ptr(out), bsz, h, w, c, build.stream(a.device))
    build.raise_on_error("fused_fusion", code)
    build.launches["fused_fusion"] += 1
    return out


FUSED_FUSION = KernelFunction(lambda a, b, raws, packed: _fused_fusion_cuda(a, b, packed),
                              lambda a, b, raws, packed: fused_fusion_reference(a, b, raws))


def fused_fusion(a, b, raws, packed, reference: bool = False):
    """The whole Fusion gate of a (deep) and b (shallow), (B, H, W, C).  A
    CPU tensor runs the plain version on ``raws``; a CUDA tensor the pools
    kernel, then the maps and gate kernels on ``packed``, which is
    ``pack_params(raws, C, a.dtype)`` as the caller keeps it (the Fusion
    module does), unless ``reference=True``."""
    if reference or a.device.type == "cpu":
        return fused_fusion_reference(a, b, raws)
    return FUSED_FUSION(a, b, raws, packed)
