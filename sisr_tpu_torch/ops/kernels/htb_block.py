"""One whole HierarchicalTransformerBlock for degenerate windows:
SCA + SCC + projection + LN1 + ConvFFN + LN2 (+ the next block's stats).

Port of ``sisr_tpu/ops/pallas/htb_block.py::htb_fused``, over the plain
version ``htb_fused_reference`` (``scc_block_reference`` then
``htb_tail_reference``) and the CUDA kernel ``csrc/htb_fused.cu``, whose
attention output stays in shared memory.  The block's window must equal its
base window (the pooling is then one scalar) and divide the map (no window
padding).  Evaluation only, as in JAX (``htb_block.py:25``): the kernel has
no backward, and on a CUDA tensor inputs that need a gradient raise.

In bfloat16 at the model's shapes (``wgmma_path``) the kernel runs the
attention on ``scc_block``'s wgmma phases and LN1, fc1 and the tail on
``htb_tail``'s, over the same packed weights (``scc_block.pack_wkv``,
``pack_proj``, ``ffn.pack_w1``, ``pack_w2``, kept on their weight tensors),
and returns the statistics' per-channel totals as ``htb_tail`` adds them
up (``ffn.stats_totals``).
"""

from __future__ import annotations

import ctypes

import torch

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.autograd import needs_grad, runs_plain
from sisr_tpu_torch.ops.kernels.ffn import (_tail_buffers, htb_tail_reference, pack_w1,
                                            pack_w2, stats_reference, stats_totals)
from sisr_tpu_torch.ops.kernels.scc_block import (_patches, pack_proj, pack_wkv,
                                                  scc_block_reference)


def wgmma_path(dtype, c: int, heads: int, ch: int, l: int) -> bool:
    """Whether ``csrc/htb_fused.cu`` runs this shape on its wgmma path
    (``fwg::takes``): bfloat16, C = 180 in 6 heads, Ch = 360, and windows of
    16 or 64 tokens.  Other shapes, and float32, take the earlier kernels."""
    return (dtype == torch.bfloat16 and c == 180 and heads == 6 and ch == 360
            and l in (16, 64))


def htb_fused_reference(x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k,
                        proj_b, heads, window, ln1_s, ln1_b, fc1_k, fc1_b,
                        dw_k, dw_b, fc2_k, fc2_b, ln2_s, ln2_b):
    """Plain version: the SCC chain, then the HTB tail."""
    attn = scc_block_reference(x, sca, w1, w2, bb, pmat, pb, mask, bias,
                               proj_k, proj_b, heads, window)
    return htb_tail_reference(attn, x, ln1_s, ln1_b, fc1_k, fc1_b, dw_k,
                              dw_b, fc2_k, fc2_b, ln2_s, ln2_b)


@build.launched("htb_fused")
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
    packed = wgmma_path(dt, c, heads, ch, big_l)
    # k = qkv @ [w1; w2] + bb: packed on the wgmma path, else (C, C/2)
    wkv = None if packed else cast(torch.cat([w1, w2], dim=0))
    ins = (wkv, cast(bb), cast(pmat), cast(bias), cast(proj_k), cast(proj_b))
    build.check_cuda("htb_fused", x.device, dt, x=x,
                     **{f"sca{i}": t for i, t in enumerate(sca_in)},
                     **{f"in{i}": t for i, t in enumerate(ins)},
                     **{f"tail{i}": t for i, t in enumerate(tail)})
    dev = x.device
    pb32 = pb.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    # x2 = x + LN1(attn) and h = gelu(fc1) pass between the two launches
    x2 = torch.empty_like(x)
    hbuf, st = _tail_buffers(b, h, w, c, ch, dt, dev, stats, totals=packed)
    packs = (None,) * 4
    if packed:
        fc1_k, fc2_k = tail[2], tail[6]
        packs = (build.cached(w1, "_scc_wkv_pack", (w1, w2),
                              lambda: pack_wkv(w1, w2, heads).to(dt)),
                 build.cached(proj_k, "_scc_proj_pack", (proj_k,),
                              lambda: pack_proj(proj_k, heads).to(dt)),
                 build.cached(fc1_k, "_htb_w1_pack", (fc1_k,), lambda: pack_w1(fc1_k)),
                 build.cached(fc2_k, "_htb_w2_pack", (fc2_k,), lambda: pack_w2(fc2_k)))
    fn = build.entry("htb_fused", "htb_fused_launch", ctypes.c_int,
                     [ctypes.c_int] + [ctypes.c_void_p] * 36 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p])
    code = build.launch(fn, dev,
                        build.DTYPE_CODES[dt], build.ptr(x), *[build.ptr(t) for t in sca_in],
                        *[build.ptr(t) for t in ins[:3]], build.ptr(pb32),
                        *[build.ptr(t) for t in ins[3:]], *[build.ptr(t) for t in tail],
                        build.ptr(x2), build.ptr(hbuf), build.ptr(out),
                        *[build.ptr(t) for t in st],
                        *[build.ptr(t) for t in packs], b, h, w, c, heads, wh, ww, ch)
    build.raise_on_error("htb_fused", code)
    if not stats:
        return out
    if packed:          # the kernel's slots and maxima
        return out, stats_totals(st)
    cmean, cmax, psum, pmax = st
    return out, (cmean, cmax, psum.sum(dim=1), pmax.amax(dim=1))


def htb_fused(x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k, proj_b,
              heads: int, window, ln1_s, ln1_b, fc1_k, fc1_b, dw_k, dw_b,
              fc2_k, fc2_b, ln2_s, ln2_b, emit_stats: bool = False):
    """The whole block.  Arguments as ``scc_block`` then ``htb_tail``
    (without the shortcut: it is ``x``); ``sca`` may carry threaded
    (cmean, cmax) maps at positions 6-7.  Returns ``out``, or ``(out,
    (cmean, cmax, ssum, smax))`` with ``emit_stats``, as ``htb_tail_stats``.
    The kernel for a CUDA tensor, the plain version otherwise
    (``autograd.runs_plain``).  The kernel derives the same-head mask from
    ``heads``; ``mask`` is the plain version's form of it."""
    tail = (ln1_s, ln1_b, fc1_k, fc1_b, dw_k, dw_b, fc2_k, fc2_b, ln2_s, ln2_b)
    if runs_plain(x):
        out = htb_fused_reference(x, sca, w1, w2, bb, pmat, pb, mask, bias, proj_k,
                                  proj_b, heads, window, *tail)
        return (out, stats_reference(out)) if emit_stats else out
    if needs_grad(x, sca, w1, w2, bb, pmat, pb, bias, proj_k, proj_b, tail):
        raise RuntimeError("htb_fused has no backward: train with fused_htb off "
                           "(the model's forward with deterministic=False ignores it)")
    return _htb_fused_cuda(x, sca, w1, w2, bb, pmat, pb, bias, proj_k, proj_b, heads,
                           window, tail, emit_stats)
