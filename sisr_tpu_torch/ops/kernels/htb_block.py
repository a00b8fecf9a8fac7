"""One whole HierarchicalTransformerBlock for degenerate windows:
SCA + SCC + projection + LN1 + ConvFFN + LN2 (+ the next block's stats).

Port of ``sisr_tpu/ops/pallas/htb_block.py::htb_fused``, over the plain
version ``htb_fused_reference`` (``scc_block_reference`` then
``htb_tail_reference``) and the CUDA kernel ``csrc/htb_fused.cu``, whose
attention output stays in shared memory.  The block's window must equal its
base window (the pooling is then one scalar) and divide the map (no window
padding).  Evaluation only.
"""

from __future__ import annotations

import ctypes

import torch

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.ffn import (_tail_buffers, htb_tail_reference,
                                            stats_reference)
from sisr_tpu_torch.ops.kernels.scc_block import _patches, scc_block_reference


def htb_fused_reference(x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k,
                        proj_b, heads, window, ln1_s, ln1_b, fc1_k, fc1_b,
                        dw_k, dw_b, fc2_k, fc2_b, ln2_s, ln2_b):
    """Plain version: the SCC chain, then the HTB tail."""
    attn = scc_block_reference(x, sca, w1, w2, bb, pmat, pb, mask, bias,
                               proj_k, proj_b, heads, window)
    return htb_tail_reference(attn, x, ln1_s, ln1_b, fc1_k, fc1_b, dw_k,
                              dw_b, fc2_k, fc2_b, ln2_s, ln2_b)


def _htb_fused_cuda(x, sca, w1, w2, bb, pmat, pb, bias, proj_k, proj_b,
                    heads: int, window, tail, stats: bool):
    b, h, w, c = x.shape
    wh, ww = window
    half, big_l = c // 2, wh * ww
    dt = x.dtype
    cast = lambda t: build.as_arg(t, dt)
    tail = [cast(t) for t in tail]
    ch = tail[2].shape[1]
    if c % 2 or half % heads or h % wh or w % ww:
        raise ValueError(f"htb_fused: x {tuple(x.shape)} does not fit window "
                         f"{window} / heads {heads}")
    expect = {"w1": (w1, (half, half)), "w2": (w2, (half, half)),
              "bb": (bb, (1, half)), "pmat": (pmat, (big_l, big_l)),
              "pb": (pb, (1, 1)), "bias": (bias, (big_l, heads * big_l)),
              "proj_k": (proj_k, (c, c)), "proj_b": (proj_b, (c,))}
    shapes = ((c,), (c,), (c, ch), (ch,), (5, 5, ch), (ch,), (ch, c), (c,),
              (c,), (c,))
    expect.update({f"tail{i}": (t, s) for i, (t, s) in enumerate(zip(tail, shapes))})
    for name, (t, s) in expect.items():
        if tuple(t.shape) != s:
            raise ValueError(f"htb_fused: {name} {tuple(t.shape)} != {s}")
    if sca is not None:
        w9a, b9a, w9m, b9m, s1, s2 = sca[:6]
        cmean, cmax = sca[6:] if len(sca) > 6 else (None, None)
        sca_in = (_patches(x, cmean, cmax).contiguous(), cast(w9a), cast(b9a),
                  cast(w9m), cast(b9m), cast(s1.reshape(b, c)), cast(s2.reshape(b, c)))
    else:
        sca_in = (None,) * 7
    ins = (cast(torch.cat([w1, w2], dim=0)), cast(bb), cast(pmat), cast(bias),
           cast(proj_k), cast(proj_b))
    build.check_cuda("htb_fused", x.device, dt, x=x,
                     **{f"sca{i}": t for i, t in enumerate(sca_in)},
                     **{f"in{i}": t for i, t in enumerate(ins)},
                     **{f"tail{i}": t for i, t in enumerate(tail)})
    dev = x.device
    pb32 = pb.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    # x2 = x + LN1(attn) and h = gelu(fc1) pass between the two launches
    x2 = torch.empty_like(x)
    hbuf, st = _tail_buffers(b, h, w, c, ch, dt, dev, stats)
    fn = build.library("htb_fused").htb_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 32 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    code = fn(build.DTYPE_CODES[dt], build.ptr(x), *[build.ptr(t) for t in sca_in],
              *[build.ptr(t) for t in ins[:3]], build.ptr(pb32),
              *[build.ptr(t) for t in ins[3:]], *[build.ptr(t) for t in tail],
              build.ptr(x2), build.ptr(hbuf), build.ptr(out), *[build.ptr(t) for t in st],
              b, h, w, c, heads, wh, ww, ch, build.stream(dev))
    build.raise_on_error("htb_fused", code)
    build.launches["htb_fused"] += 1
    if not stats:
        return out
    cmean, cmax, psum, pmax = st
    return out, (cmean, cmax, psum.sum(dim=1), pmax.amax(dim=1))


def htb_fused(x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k, proj_b,
              heads: int, window, ln1_s, ln1_b, fc1_k, fc1_b, dw_k, dw_b,
              fc2_k, fc2_b, ln2_s, ln2_b, emit_stats: bool = False,
              reference: bool = False):
    """The whole block.  Arguments as ``scc_block`` then ``htb_tail``
    (without the shortcut: it is ``x``); ``sca`` may carry threaded
    (cmean, cmax) maps at positions 6-7.  Returns ``out``, or ``(out,
    (cmean, cmax, ssum, smax))`` with ``emit_stats``, as ``htb_tail_stats``.
    A CPU tensor runs the plain version; a CUDA tensor the kernel unless
    ``reference=True``.  The kernel derives the same-head mask from
    ``heads``; ``mask`` is the plain version's form of it."""
    tail = (ln1_s, ln1_b, fc1_k, fc1_b, dw_k, dw_b, fc2_k, fc2_b, ln2_s, ln2_b)
    if reference or x.device.type == "cpu":
        out = htb_fused_reference(x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k,
                                  proj_b, heads, window, *tail)
        return (out, stats_reference(out)) if emit_stats else out
    return _htb_fused_cuda(x, sca, w1, w2, bb, pmat, pb, bias, proj_k, proj_b, heads,
                           window, tail, emit_stats)
