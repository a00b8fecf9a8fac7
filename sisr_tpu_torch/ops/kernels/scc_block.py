"""Fused SCA + SCC + projection window attention.

Port of ``sisr_tpu/ops/pallas/scc_block.py::_scc_block_pallas`` (its
per-window and row-of-windows bodies): one public function, ``scc_block``,
over the plain version ``scc_block_reference`` and the CUDA kernel
``csrc/scc_block.cu``.

    SCA:  qkv = (leaky(conv3x3(ch_mean))*s1 + leaky(conv3x3(ch_max))*s2)/2 + x
    SCC:  q/v split -> k synthesis -> learned pooling -> S-SC (+pos bias)
          -> C-SC channel gram
    proj: out = [out_s | out_c] @ P + b

The SCA patch build and the squeeze-excite vectors s1/s2 are plain torch
outside the kernel, as in JAX: they need reductions over the whole map.

The gradient is the JAX ``custom_vjp``'s (``scc_block.py:420-445``): the
vjp of ``scc_block_reference`` recomputed from the saved inputs, the
``sca`` tuple flattened into the Function's inputs and back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.autograd import KernelFunction
from sisr_tpu_torch.ops.kernels.scc_attention import scc_reference


def _conv_patches(m: torch.Tensor) -> torch.Tensor:
    """(B, k, H, W) maps -> (B, H, W, 9k) zero-padded 3x3 im2col patches:
    map by map, taps in row-major order (matches the (C, 1, 3, 3) kernel
    reshaped to (9, C)).  A (B, H, W) map counts as k = 1."""
    if m.dim() == 3:
        m = m[:, None]
    b, k, h, w = m.shape
    return F.unfold(m, 3, padding=1).transpose(1, 2).reshape(b, h, w, 9 * k)


def _patches(x, cmean, cmax):
    """(B, H, W, 18): the channel-mean taps, then the channel-max taps;
    ``cmean``/``cmax`` are the maps the previous tail kernel emitted."""
    dt = x.dtype
    maps = (x.mean(dim=-1), x.amax(dim=-1)) if cmean is None else (cmean, cmax)
    return _conv_patches(torch.stack(maps, dim=1).to(dt))


def sca_reference(x, w9a, b9a, w9m, b9m, s1, s2, cmean=None, cmax=None):
    """SpatialChannelAttention with precomputed squeeze-excite vectors.
    x: (B,H,W,C); w9*: (9, C); s1/s2: (B,1,1,C); cmean/cmax: optional
    (B,H,W) channel-pool maps."""
    dt = x.dtype
    p = _patches(x, cmean, cmax)
    ca = F.leaky_relu(p[..., :9] @ w9a.to(dt) + b9a.to(dt), 0.2)
    cm = F.leaky_relu(p[..., 9:] @ w9m.to(dt) + b9m.to(dt), 0.2)
    return (ca * s1 + cm * s2) / 2.0 + x


def scc_block_reference(x, sca, w1, w2, bb, pmat, pb, mask, bias,
                        proj_k, proj_b, heads: int, window):
    """Plain version.  x: (B, Hp, Wp, C) padded to window multiples; sca:
    None or the ``sca_reference`` parameter tuple; the rest as in
    ``scc_attention.scc_reference`` plus the (C, C) projection."""
    b, hp, wp, c = x.shape
    wh, ww = window
    dt = x.dtype
    qkv = sca_reference(x, *sca) if sca is not None else x
    x6 = qkv.reshape(b, hp // wh, wh, wp // ww, ww, c)
    out6 = scc_reference(x6, w1, w2, bb, pmat, pb, mask, bias, heads)
    # scc_reference promotes to float32 through the pooling bias; cast
    # back before the projection
    out = out6.reshape(b, hp, wp, c).to(dt)
    return out @ proj_k.to(dt) + proj_b.to(dt)


def _scc_block_cuda(x, sca, w1, w2, bb, pmat, pb, bias, proj_k, proj_b,
                    heads: int, window):
    b, hp, wp, c = x.shape
    wh, ww = window
    half = c // 2
    l_full = wh * ww
    l_base = pmat.shape[0]
    dt = x.dtype
    if c % 2 or half % heads or hp % wh or wp % ww:
        raise ValueError(f"scc_block: x {tuple(x.shape)} does not fit window "
                         f"{window} / heads {heads}")
    expect = {"w1": (w1, (half, half)), "w2": (w2, (half, half)),
              "bb": (bb, (1, half)), "pmat": (pmat, (l_base, l_full)),
              "pb": (pb, (1, 1)), "bias": (bias, (l_full, heads * l_base)),
              "proj_k": (proj_k, (c, c)), "proj_b": (proj_b, (c,))}
    for name, (t, s) in expect.items():
        if tuple(t.shape) != s:
            raise ValueError(f"scc_block: {name} {tuple(t.shape)} != {s}")
    cast = lambda t: build.as_arg(t, dt)
    if sca is not None:
        w9a, b9a, w9m, b9m, s1, s2 = sca[:6]
        cmean, cmax = sca[6:] if len(sca) > 6 else (None, None)
        sca_in = (_patches(x, cmean, cmax).contiguous(), cast(w9a),
                  cast(b9a), cast(w9m), cast(b9m), cast(s1.reshape(b, c)),
                  cast(s2.reshape(b, c)))
    else:
        sca_in = (None,) * 7
    wkv = cast(torch.cat([w1, w2], dim=0))        # k = qkv @ [w1; w2] + bb
    ins = (wkv, cast(bb), cast(pmat), cast(bias), cast(proj_k), cast(proj_b))
    build.check_cuda("scc_block", x.device, dt, x=x,
                     **{f"sca{i}": t for i, t in enumerate(sca_in)},
                     **{f"in{i}": t for i, t in enumerate(ins)})
    pb32 = pb.to(device=x.device, dtype=torch.float32).contiguous()
    lib = build.library("scc_block")
    size_fn = lib.scc_block_scratch_floats
    size_fn.restype = ctypes.c_longlong
    size_fn.argtypes = [ctypes.c_int] * 7
    dims = (b, hp, wp, c, wh, ww, l_base)
    scratch = torch.empty(size_fn(*dims), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    fn = lib.scc_block_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 17
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    code = fn(build.DTYPE_CODES[dt], build.ptr(x),
              *[build.ptr(t) for t in sca_in],
              build.ptr(ins[0]), build.ptr(ins[1]), build.ptr(ins[2]),
              build.ptr(pb32), *[build.ptr(t) for t in ins[3:]],
              build.ptr(out), build.ptr(scratch),
              b, hp, wp, c, heads, wh, ww, l_base, build.stream(x.device))
    build.raise_on_error("scc_block", code)
    build.launches["scc_block"] += 1
    return out


# the kernel derives the head mask from ``heads``
SCC_BLOCK = KernelFunction(
    lambda x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k, proj_b, heads, window:
    _scc_block_cuda(x, sca, w1, w2, bb, pmat, pb, bias, proj_k, proj_b, heads, window),
    scc_block_reference)


def scc_block(x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k, proj_b,
              heads: int, window, reference: bool = False):
    """Fused SCA + SCC + proj; see the module docstring.  A CPU tensor runs
    the plain version; a CUDA tensor the kernel unless ``reference=True``.
    The kernel derives the same-head mask from ``heads``; ``mask`` is the
    plain version's form of it."""
    if reference or x.device.type == "cpu":
        return scc_block_reference(x, sca, w1, w2, bb, pmat, pb, mask, bias,
                                   proj_k, proj_b, heads, window)
    return SCC_BLOCK(x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k, proj_b, heads,
                     window)
