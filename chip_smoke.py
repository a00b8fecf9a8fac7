#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sisr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --phases build,serve,whole   # a part (no result line)

Phases:
  build    compile every kernel in sisr_tpu_torch/csrc with nvcc (one
           process per source, all at once) into build/kernels/;
  kernels  each of the nine kernels against its plain PyTorch version on
           the same inputs, first at the shapes one 192x192 tile of the
           flagship gives it, then at the 1080p frame's: the packed tail at
           a head band, htb_fused at window 4 and 8 on 1088x1920, and one
           case of each earlier kernel that a tile never gives it (scc_block
           with 130,560 windows of 4x4 and at window 48 on a padded map,
           htb_tail_stats with a padded attn, conv3x3 180->180,
           fused_fusion, conv3x3_shuffled at a band).  In float32 (TF32 off)
           within 2e-4 x max(1, max|plain|), and in bfloat16, where the
           kernel must stay within twice the plain bfloat16 version's
           distance from the float32 plain version (or 4 bf16 ulps of the
           output scale); then its time (CUDA events, warmed) in bfloat16
           and float32, the plain version's, the bound (bfloat16 bytes at
           3.35 TB/s, or operations at 989 TFLOP/s on the tensor cores and
           67 TFLOP/s for float32 work on the FP32 pipes, whichever is
           larger) and, where one PyTorch call computes the same function,
           that call's time;
  serve    the serving entry point (TiledSR over HiTSIR, the full flagship
           with its Fusion gate, synthesized weights) on three requests, bfloat16
           then float32, with every launch counter checked per tile; then
           the command line's path once (``infer.main``, PNG in and out);
  whole    the whole-image path (BandedHeadSR: the body whole, the x4 head
           over feature-row bands) on the 1080p frame bench.py runs (LR
           1080x1920, align 64, band_rows 120: 8 bands of 136), bfloat16
           and bfloat16 with fused_htb in turns (the A/B), then float32:
           warmed, three timed runs each, min and median ms, input MP/s,
           peak device memory; then 120x160, 256x320 and 250x330 with
           align 0 (one call; stacked with the packed tail; canvas with the
           unpacked tail); every launch counter checked per request;
  profile  one bfloat16 and one float32 tile, and a bfloat16 1080p frame
           without and with fused_htb, under torch.profiler: device time
           by kernel, device busy time against the wall time;
  check    a 192x192 tile of each request through the plain model on the
           card (``reference=True``): float32 kernels within 1e-3 max abs;
           bfloat16 kernels >= 44 dB PSNR (mean squared error over the
           tiles) against the float32 plain model, or, where the plain
           bfloat16 model itself stays below 47 dB (these synthesized
           weights amplify any rounding), within 3 dB of it.  Then
           BandedHeadSR on 256x320 and 250x330: float32 within 1e-5 of the
           whole forward and 1e-3 of the plain model, bfloat16 at the same
           PSNR bar, fused_htb within 1e-4 of the unfused model.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
as the last line when every phase passed,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result line, when there is no CUDA card or any
check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_BF16_FLOPS = 989e12                       # H100 SXM, dense
PEAK_F32_FLOPS = 67e12                         # H100 SXM, FP32 outside the tensor cores
TILE = 192
REQUESTS = ((192, 192), (256, 320), (480, 640))   # 1, 4 and 12 tiles
# the whole-image path as bench.py runs it: an LR 1080x1920 frame, align
# 64 (1088 rows), band_rows 120, which BandedHeadSR makes 8 bands of 136
FRAME, FRAME_ALIGN, BAND_ROWS = (1080, 1920), 64, 120
FRAME_ALIGNED, BAND_ROWS_1080 = (1088, 1920), 136
# smaller whole-image requests (align 0): one call; stacked bands with the
# packed tail; canvas bands with the unpacked tail (330 % 4 != 0)
SMALL = ((120, 160), (256, 320), (250, 330))
# launches of each kernel per 192x192 tile of the flagship
PER_TILE = {"conv3x3": 9, "conv3x3_shuffled": 1, "conv3x3_shuffled_tail": 1,
            "fusion_pools": 1, "fused_fusion": 1, "htb_tail": 36, "htb_tail_stats": 30,
            "scc_block": 36}
SOURCES = {
    "conv3x3": ("sisr_tpu_torch/csrc/conv3x3.cu", "sisr_tpu/ops/pallas/conv3x3.py:171"),
    "conv3x3_shuffled": ("sisr_tpu_torch/csrc/conv3x3.cu",
                         "sisr_tpu/ops/pallas/conv3x3.py:333"),
    "conv3x3_shuffled_tail": ("sisr_tpu_torch/csrc/shuffled_tail.cu",
                              "sisr_tpu/ops/pallas/conv3x3.py:490"),
    "htb_tail": ("sisr_tpu_torch/csrc/htb_tail.cu", "sisr_tpu/ops/pallas/ffn.py:328"),
    "scc_block": ("sisr_tpu_torch/csrc/scc_block.cu", "sisr_tpu/ops/pallas/scc_block.py:309"),
    "fusion_pools": ("sisr_tpu_torch/csrc/fusion.cu", "sisr_tpu/ops/pallas/fusion_ops.py:133"),
    "fused_fusion": ("sisr_tpu_torch/csrc/fusion.cu", "sisr_tpu/ops/pallas/fusion_ops.py:404"),
    "conv3x3_shuffled_tail_packed": ("sisr_tpu_torch/csrc/shuffled_tail.cu",
                                     "sisr_tpu/ops/pallas/conv3x3.py:705"),
    "htb_fused": ("sisr_tpu_torch/csrc/htb_fused.cu", "sisr_tpu/ops/pallas/htb_block.py:217"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, target_s: float = 0.25, max_iters: int = 50, min_iters: int = 3) -> float:
    """Mean device ms of ``fn`` over a warmed run of launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = time.perf_counter() - t0
    n = max(min_iters, min(max_iters, int(target_s / max(est, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _flat(out):
    import torch

    if isinstance(out, torch.Tensor):
        return [out.float()]
    return [t for o in out for t in _flat(o)]


def _upcast(arg):
    """Every tensor in ``arg`` (nested in tuples and lists) as float32."""
    import torch

    if isinstance(arg, torch.Tensor):
        return arg.float()
    if isinstance(arg, (tuple, list)):
        return type(arg)(_upcast(a) for a in arg)
    return arg


def _errs(a, b):
    """Per output tensor: (max |a - b|, max |b|)."""
    return [(float((x - y).abs().max()), float(y.abs().max()))
            for x, y in zip(_flat(a), _flat(b))]


# --- the kernels' cases: the shapes of one flagship tile, and of a frame ------

class Case:
    """One kernel call at one shape: inputs from a seeded generator, the
    call, and the work it must do: bytes moved once, operations of the
    bfloat16 run on the tensor cores (``flops``) and on the FP32 pipes
    (``flops32``: float32 work the function keeps in float32).  ``scope``
    is "tile" (a 192x192 tile's shapes) or "frame" (the 1080p frame's);
    ``count`` is the calls a tile or a frame makes at this shape."""

    def __init__(self, kernel, label, count, make, call, nbytes, flops,
                 library=None, flops32=0.0, scope="tile"):
        self.kernel, self.label, self.count = kernel, label, count
        self.make, self.call, self.nbytes, self.flops = make, call, nbytes, flops
        self.library, self.flops32, self.scope = library, flops32, scope

    def t_ops(self) -> float:
        """Least ms for the operations: each type at its peak, the two pipes
        side by side."""
        return max(self.flops / PEAK_BF16_FLOPS, self.flops32 / PEAK_F32_FLOPS) * 1e3


def _gen(seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *s: torch.randn(*s, generator=g, device="cuda")


def conv_cases(shapes, scope="tile"):
    """shapes: (h, w, cin, cout, act, res, calls)."""
    import torch.nn.functional as F
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3

    cases = []
    for h, w, cin, cout, act, res, n in shapes:
        def make(dt, h=h, w=w, cin=cin, cout=cout, res=res):
            rn = _gen(h * 7 + cin + cout)
            ins = [rn(1, h, w, cin), rn(1, h, w, cout) if res else None,
                   rn(3, 3, cin, cout) / math.sqrt(9 * cin), rn(cout) * 0.1]
            return [None if t is None else t.to(dt) for t in ins]

        def call(ins, reference, act=act):
            y, r, k, b = ins
            return conv3x3(y, r, k, b, act, reference=reference)

        def library(ins):
            y, r, k, b = ins
            return F.conv2d(y.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b, padding=1)

        def nbytes(es, h=h, w=w, cin=cin, cout=cout, res=res):
            return es * (h * w * cin + 9 * cin * cout + cout
                         + h * w * cout * (2 if res else 1))

        cases.append(Case("conv3x3", f"{h}x{w} {cin}->{cout} {act}{' +res' if res else ''}",
                          n, make, call, nbytes, 2.0 * h * w * 9 * cin * cout, library,
                          scope=scope))
    return cases


def shuffled_case(h2, w2, count, scope="tile"):
    """conv_up2 of the packed x4 head: yp (1, h2, w2, 256) -> (1, 2h2, 2w2,
    256); no single PyTorch call computes it."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled

    f = 64

    def make(dt):
        rn = _gen(11)
        ins = [rn(1, h2, w2, 4 * f), rn(3, 3, f, 4 * f) / math.sqrt(9 * f), rn(4 * f) * 0.1]
        return [t.to(dt) for t in ins]

    return Case("conv3x3_shuffled",
                f"yp {h2}x{w2}x256 -> {2 * h2}x{2 * w2} 64->256 leaky2", count, make,
                lambda ins, reference: conv3x3_shuffled(*ins, "leaky2", reference=reference),
                lambda es: es * (h2 * w2 * 4 * f + 9 * f * 4 * f + 4 * f + 4 * h2 * w2 * 4 * f),
                2.0 * 4 * h2 * w2 * 9 * f * 4 * f, scope=scope)


def tail_case(h2, w2, count, packed=False, scope="tile"):
    """conv_hr + conv_last of the packed x4 head over yp (1, h2, w2, 256),
    plain or with the output packed 16 pixels to a row; no single PyTorch
    call computes it."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_shuffled_tail,
                                                    conv3x3_shuffled_tail_packed)

    f = 64
    fn = conv3x3_shuffled_tail_packed if packed else conv3x3_shuffled_tail
    hout, wout = 2 * h2, 2 * w2

    def make(dt):
        rn = _gen(12)
        ins = [rn(1, h2, w2, 4 * f), rn(3, 3, f, f) / math.sqrt(9 * f), rn(f) * 0.1,
               rn(3, 3, f, 3) / math.sqrt(9 * f), rn(3) * 0.1]
        return [t.to(dt) for t in ins]

    out = f"{hout}x{wout // 16}x48" if packed else f"{hout}x{wout}x3"
    return Case("conv3x3_shuffled_tail_packed" if packed else "conv3x3_shuffled_tail",
                f"yp {h2}x{w2}x256 -> {out} 64->64->3", count, make,
                lambda ins, reference: fn(ins[0], ins[1], ins[2], "leaky2", ins[3], ins[4],
                                          reference=reference),
                lambda es: es * (h2 * w2 * 4 * f + 9 * f * f + f + 9 * f * 3 + 3
                                 + hout * wout * 3),
                2.0 * hout * wout * 9 * f * (f + 3), scope=scope)


def fusion_cases(h, w, pools=True, scope="tile"):
    """The Fusion gate (a, b 1 x h x w x 180): the pools alone, and the
    whole gate (pools, maps, gate) with its packed weights made once, as
    the model keeps them.  Operations, per UA k of three:

    - pools (float32): 19 per input element (a + b; sum and max over C, H
      and W of a, a + b, b);
    - maps (float32): per row of h_att (W rows) and w_att (H rows), three
      outputs (the folded map and two border corrections) of three taps
      of a C x C product: 2 * 3 * 3 * C^2 each, 2 * 27 * (H + W) * C^2 in
      all; the 18-tap convs of the pools, 2 * 18 * 3 * (H*W + (H + W) * C);
    - gate: base = p27 @ k1blk, nine nonzero taps per UA and output element,
      bfloat16 by bfloat16 in the bfloat16 run: 2 * 9 * 3 per output
      element; then 20 float32 operations per output element (six adds of
      the maps, three sigmoids at three, five for the gate)."""
    from sisr_tpu_torch.ops.kernels.fusion_ops import fused_fusion, fusion_pools, pack_params

    c = 180

    def make_ab(dt):
        rn = _gen(21)
        return [rn(1, h, w, c).to(dt) for _ in range(2)]

    def make_fused(dt):
        rn = _gen(22)
        raws = tuple(((rn(3, 3, 2, 1) / 4.0, 0.01 * rn(1)), (rn(3, 3, 2, 1) / 4.0, 0.01 * rn(1)),
                      (rn(3, 3, 2, 1) / 4.0, 0.01 * rn(1)),
                      (rn(3, 3, c, c) / math.sqrt(9 * c), 0.01 * rn(c))) for _ in range(3))
        a, b = make_ab(dt)
        return [a, b, raws, pack_params(raws, c, dt)]

    pool_bytes = lambda es: es * (2 * h * w * c + 6 * h * w + 6 * h * c) + 4 * 6 * w * c
    pool_ops = 19.0 * h * w * c
    map_ops = 2.0 * 27 * (h + w) * c * c + 2.0 * 18 * 3 * (h * w + (h + w) * c)
    fused = Case("fused_fusion", f"a, b {h}x{w}x{c}, pools + maps + gate", 1, make_fused,
                 lambda ins, reference: fused_fusion(ins[0], ins[1], ins[2], ins[3], reference),
                 lambda es: (es * (3 * h * w * c + 3 * 18 * c * c + 27 * 3 * c)
                             + 4 * (3 * 3 * 18 + 9 + 3 * c)),
                 2.0 * 9 * 3 * h * w * c, flops32=pool_ops + map_ops + 20.0 * h * w * c,
                 scope=scope)
    if not pools:
        return [fused]
    return [Case("fusion_pools", f"a, b {h}x{w}x{c}", 1, make_ab,
                 lambda ins, reference: fusion_pools(*ins, reference=reference), pool_bytes,
                 0.0, flops32=pool_ops, scope=scope), fused]


def _tail_inputs(rn, c, ch):
    """The HTB tail's weights: LN1, fc1, dwconv, fc2, LN2."""
    return [1 + 0.05 * rn(c), 0.01 * rn(c), rn(c, ch) / math.sqrt(c), 0.01 * rn(ch),
            rn(5, 5, ch) / 5.0, 0.01 * rn(ch), rn(ch, c) / math.sqrt(ch), 0.01 * rn(c),
            1 + 0.05 * rn(c), 0.01 * rn(c)]


def htb_cases(h, w, variants, pad=0, scope="tile"):
    """variants: (stats, calls); attn is ``pad`` rows taller than the
    shortcut (a window-padded SCC output)."""
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail, htb_tail_stats

    c, ch = 180, 360
    cases = []
    for stats, n in variants:
        def make(dt):
            rn = _gen(5)
            ins = [rn(1, h + pad, w, c), rn(1, h, w, c)] + _tail_inputs(rn, c, ch)
            return [t.to(dt) for t in ins]

        fn = htb_tail_stats if stats else htb_tail

        def call(ins, reference, fn=fn):
            return fn(*ins, reference=reference)

        def nbytes(es, stats=stats):
            weights = 2 * c * ch + 25 * ch + 2 * ch + 6 * c
            stat = 4 * (2 * h * w + 2 * c) if stats else 0
            return es * (3 * h * w * c + weights) + stat

        flops = 2.0 * h * w * (2 * c * ch + 25 * ch)
        label = f"{h}x{w} C={c} Ch={ch}{' +stats' if stats else ''}"
        cases.append(Case("htb_tail", label + (f", attn {h + pad}x{w}" if pad else ""),
                          n, make, call, nbytes, flops, scope=scope))
    return cases


def _scc_inputs(rn, dt, h, w, win, base=8, c=180, heads=6):
    """x and the SCC arguments of one block (as the model derives them)."""
    import torch
    from sisr_tpu_torch.ops.kernels.scc_attention import (blockdiag_kgen, head_mask,
                                                          pooling_matrix)

    half, d = c // 2, c // (2 * heads)
    bh = min(win, base)
    lb, big_l, rh = bh * bh, win * win, win // bh
    x = rn(1, h, w, c)
    sca = (rn(9, c) / 3.0, 0.01 * rn(c), rn(9, c) / 3.0, 0.01 * rn(c),
           0.3 * rn(1, 1, 1, c), 0.3 * rn(1, 1, 1, c))
    w1, w2, bb = blockdiag_kgen(rn(d, d) / math.sqrt(d), 0.01 * rn(d),
                                rn(d, d) / math.sqrt(d), 0.01 * rn(d), heads)
    pmat, pb = pooling_matrix(rn(rh * rh, 1) / rh, 0.01 * rn(1), win, win, bh, bh,
                              torch.float32)
    mask = head_mask(heads, lb, half, torch.float32, "cuda")
    bias = 0.1 * rn(big_l, heads * lb)
    proj_k, proj_b = rn(c, c) / math.sqrt(c), 0.01 * rn(c)
    cast = lambda t: t.to(dt)
    return [cast(x), tuple(map(cast, sca)), cast(w1), cast(w2), cast(bb), cast(pmat), pb,
            cast(mask), cast(bias), cast(proj_k), cast(proj_b)]


def _scc_work(h, w, win, base=8, c=180, heads=6):
    """(bytes at 1 byte an element, operations) of one SCC block."""
    half, d = c // 2, c // (2 * heads)
    lb, big_l = min(win, base) ** 2, win * win
    nbytes = (2 * h * w * c + h * w * 18 + big_l * heads * lb + c * half + c * c + 40 * c
              + big_l * lb)
    per_token = (18 * c + c * half + half * half + 2 * lb * half
                 + half * half + lb * half + half * half + c * c)
    return nbytes, 2.0 * h * w * per_token + 2.0 * (h * w // big_l) * lb * half * d


def scc_cases(shapes, scope="tile"):
    """shapes: (h, w, window, calls)."""
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    heads = 6
    cases = []
    for h, w, win, n in shapes:
        lb, big_l = min(win, 8) ** 2, win * win

        def make(dt, h=h, w=w, win=win):
            return _scc_inputs(_gen(win), dt, h, w, win)

        def call(ins, reference, win=win):
            return scc_block(*ins, heads, (win, win), reference=reference)

        nb, flops = _scc_work(h, w, win)
        cases.append(Case("scc_block", f"{h}x{w} window {win} (L={big_l}, l_base={lb})",
                          n, make, call, lambda es, nb=nb: es * nb, flops, scope=scope))
    return cases


def htb_fused_cases(h, w, shapes, scope="frame"):
    """The whole degenerate-window HTB: shapes (window, threaded stats,
    calls); both emit the next block's stats, as the flagship's do.  Work:
    the SCC block's, with its channel branch in the reassociated form
    (2 * 2 * L * C/2 a token) and its spatial branch kept in float32 (2 * 2
    * L * C/2), plus the tail's; bytes: x, the SCC and tail weights, out
    and the stats (x2 and h are intermediates)."""
    import torch
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused

    c, ch, heads, half = 180, 360, 6, 90
    cases = []
    for win, threaded, n in shapes:
        big_l = win * win

        def make(dt, win=win, threaded=threaded):
            rn = _gen(30 + win)
            ins = _scc_inputs(rn, dt, h, w, win)
            if threaded:
                xf = ins[0].float()
                ins[1] = ins[1] + (xf.mean(-1), xf.amax(-1))
            return ins + [t.to(dt) for t in _tail_inputs(rn, c, ch)]

        def call(ins, reference, win=win):
            return htb_fused(*ins[:11], heads, (win, win), *ins[11:], emit_stats=True,
                             reference=reference)

        nb, _ = _scc_work(h, w, win)
        weights = 2 * c * ch + 25 * ch + 2 * ch + 6 * c
        tc = 2.0 * h * w * (18 * c + c * half + 2 * big_l * half + c * c + 2 * c * ch + 25 * ch)
        f32 = 2.0 * h * w * 2 * big_l * half
        cases.append(Case(
            "htb_fused", f"{h}x{w} window {win} (L={big_l}) +stats"
            + (", threaded stats" if threaded else ""), n, make, call,
            lambda es, nb=nb: es * (nb + weights) + 4 * (2 * h * w + 2 * c)
            + (4 * 2 * h * w if threaded else 0),
            tc, flops32=f32, scope=scope))
    return cases


TILE_CONVS = [  # (cin, cout, act, res, calls per tile)
    (180, 180, "none", True, 6),    # RHTB residual convs
    (180, 180, "none", False, 1),   # conv_after_body
    (180, 64, "leaky", False, 1),   # conv_before_upsample
    (64, 256, "leaky2", False, 1),  # conv_up1 (phase-folded, packed out)
]


def tile_cases():
    return (conv_cases([(TILE, TILE) + c for c in TILE_CONVS])
            + [shuffled_case(TILE, TILE, 1), tail_case(2 * TILE, 2 * TILE, 1)]
            + htb_cases(TILE, TILE, ((True, 30), (False, 6)))
            + scc_cases([(TILE, TILE, win, 6) for win in (4, 8, 16, 32, 48, 64)])
            + fusion_cases(TILE, TILE))


def frame_cases():
    """At the 1080p frame's shapes (LR 1080x1920 aligned to 1088x1920, 8
    head bands of 136 + 4 halo rows): rows 7 and 10 with their per-frame
    counts (the 8 bands; the 6 window-4 and 6 window-8 blocks with
    fused_htb), and one case of each earlier kernel that a 192x192 tile
    never gives it (calls 0: checked and timed, outside the tile sums)."""
    h, w = FRAME_ALIGNED
    rows = BAND_ROWS_1080 + 4
    up48 = lambda n: -(-n // 48) * 48     # the 48-window blocks pad 1088 to 1104
    return ([tail_case(2 * rows, 2 * w, 8, packed=True, scope="frame")]
            + htb_fused_cases(h, w, ((4, False, 6), (8, True, 6)))
            + scc_cases([(h, w, 4, 0), (up48(h), up48(w), 48, 0)], scope="frame")
            + htb_cases(h, w, ((True, 0),), pad=up48(h) - h, scope="frame")
            + conv_cases([(h, w, 180, 180, "none", True, 0)], scope="frame")
            + fusion_cases(h, w, pools=False, scope="frame")
            + [shuffled_case(rows, w, 0, scope="frame")])


def run_kernels(failures: list) -> tuple:
    """Hold every kernel against its plain version; time both.  Returns
    (rows, extra): rows[(kernel, scope)] sums a kernel's cases over a tile
    or a frame, weighted by their calls; extra[kernel] lists its frame
    cases of no calls (shapes the tile never gives it)."""
    import torch
    from sisr_tpu_torch.utils.precision import exact_mode

    f32, b16 = torch.float32, torch.bfloat16
    rows, extra = {}, {}
    for case in tile_cases() + frame_cases():
        # a frame case runs for seconds: time it over one call after the warm-up
        few = dict(min_iters=1) if case.scope == "frame" else {}
        try:
            with exact_mode():
                ins32 = case.make(f32)
                got = case.call(ins32, False)
                ref = case.call(ins32, True)
                torch.cuda.synchronize()
                e32 = _errs(got, ref)
                finite = all(bool(torch.isfinite(t).all()) for t in _flat(got))
                del got, ref
                ins16 = case.make(b16)
                got16 = case.call(ins16, False)
                ref16 = case.call(ins16, True)
                truth = case.call(_upcast(ins16), True)
                torch.cuda.synchronize()
            # every output tensor on its own scale (the stats sums are large)
            err32 = max(e for e, _ in e32)
            ok32 = all(e <= 2e-4 * max(1.0, s) for e, s in e32)
            err16 = max(e for e, _ in _errs(got16, ref16))
            e16k, e16p = _errs(got16, truth), _errs(ref16, truth)
            ok16 = all(ek <= max(2.0 * ep, 4 * 2.0 ** -8 * s)
                       for (ek, s), (ep, _) in zip(e16k, e16p))
            err16_k, err16_p = max(e for e, _ in e16k), max(e for e, _ in e16p)
            ok = ok32 and ok16 and finite
            for t in _flat(got16):
                ok = ok and bool(torch.isfinite(t).all())
            del got16, ref16, truth
            ms = time_ms(lambda: case.call(ins16, False), **few)
            plain_ms = time_ms(lambda: case.call(ins16, True), max_iters=10, **few)
            lib_ms = time_ms(lambda: case.library(ins16), **few) if case.library else None
            del ins16
            with exact_mode():
                ms32 = time_ms(lambda: case.call(ins32, False), **few)
                plain32 = time_ms(lambda: case.call(ins32, True), max_iters=10, **few)
            del ins32
            torch.cuda.empty_cache()
            t_bytes = case.nbytes(2) / HBM_BYTES_PER_S * 1e3
            t_ops = case.t_ops()
            log(f"  {case.kernel:21s} {case.label:44s} f32 err {err32:.3e} "
                f"{'ok' if ok32 else 'FAIL'} | bf16 err vs plain {err16:.3e}, vs f32 "
                f"{err16_k:.3e} (plain bf16 vs f32 {err16_p:.3e}) {'ok' if ok16 else 'FAIL'} "
                f"| bf16 ms {ms:.4f} plain {plain_ms:.4f} "
                f"lib {'-' if lib_ms is None else f'{lib_ms:.4f}'} | f32 ms {ms32:.4f} "
                f"plain {plain32:.4f} | bound {max(t_bytes, t_ops):.4f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}) x{case.count}/{case.scope} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"kernel {case.kernel} {case.label} disagrees with its plain version")
            if case.count == 0:
                extra.setdefault(case.kernel, []).append(dict(
                    shape=case.label, max_abs_err=err32, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, ms_f32=ms32, plain_ms_f32=plain32,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations"))
                continue
            row = rows.setdefault((case.kernel, case.scope), dict(
                err=0.0, ms=0.0, plain=0.0, lib=0.0, ms32=0.0, plain32=0.0,
                has_lib=case.library is not None, t_bytes=0.0, t_ops=0.0))
            row["err"] = max(row["err"], err32)
            row["ms"] += case.count * ms
            row["plain"] += case.count * plain_ms
            row["lib"] += case.count * (lib_ms or 0.0)
            row["ms32"] += case.count * ms32
            row["plain32"] += case.count * plain32
            row["t_bytes"] += case.count * t_bytes
            row["t_ops"] += case.count * t_ops
        except Exception:  # record, keep checking the other kernels
            failures.append(f"kernel {case.kernel} {case.label}: {traceback.format_exc()}")
            log(f"  {case.kernel} {case.label} FAILED\n{traceback.format_exc()}")
            torch.cuda.empty_cache()
    return rows, extra


def run_serving(failures: list) -> dict:
    """Serve three requests through the entry point, bf16 then f32."""
    import torch
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.parallel.tiling import tile_positions

    g = torch.Generator(device="cuda").manual_seed(0)
    imgs = [torch.rand((h, w, 3), generator=g, device="cuda") for h, w in REQUESTS]
    models = {}
    for dt in ("bfloat16", "float32"):
        model = infer.create_model(dt, "cuda")
        infer.synth_weights(model, seed=0)
        models[dt] = model
    n_params = sum(p.numel() for p in models["float32"].parameters())
    log(f"  model: HiTSIR(**flagship_config()), the Fusion gate on, {n_params:,} parameters")
    main_counts = None
    with torch.inference_mode():
        for dt, model in models.items():
            model(imgs[0][None])  # warm: cuBLAS handles, kernel attributes
            torch.cuda.synchronize()
            build.reset_launches()
            for (h, w), img in zip(REQUESTS, imgs):
                before = dict(build.launches)
                t0 = time.perf_counter()
                out = infer.upscale(model, img, TILE)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                tiles = len(tile_positions(h, TILE, 16)) * len(tile_positions(w, TILE, 16))
                got = {k: build.launches[k] - before[k] for k in PER_TILE}
                want = {k: v * tiles for k, v in PER_TILE.items()}
                ok = (tuple(out.shape) == (4 * h, 4 * w, 3)
                      and bool(torch.isfinite(out).all()) and got == want)
                log(f"  {dt:8s} request {h}x{w}: {tiles} tiles, {sec * 1e3:.1f} ms, "
                    f"{h * w / sec / 1e6:.4f} input MP/s, launches {got} "
                    f"{'ok' if ok else 'FAIL (want ' + str(want) + ')'}")
                if not ok:
                    failures.append(f"serving {dt} {h}x{w}: shape/finite/launch counts")
            if dt == "bfloat16":
                main_counts = dict(build.launches)
            log(f"  {dt} launches over the three requests: {dict(build.launches)}")
    run_cli(failures)
    # one 192x192 tile of each request for the whole-model check
    tiles = [img[None, :TILE, :TILE] for img in imgs]
    return dict(models=models, tiles=tiles, counts=main_counts)


def run_cli(failures: list) -> None:
    """The command-line path once: a PNG in, no weights file (a warning,
    then seeded weights), a PNG four times larger out, under build/smoke/."""
    from pathlib import Path

    import numpy as np
    from PIL import Image
    from sisr_tpu_torch import infer

    work = Path(__file__).resolve().parent / "build" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    h, w = 60, 76
    lr = np.random.default_rng(0).integers(0, 256, (h, w, 3), dtype=np.uint8)
    Image.fromarray(lr).save(work / "lr.png")
    t0 = time.perf_counter()
    out = infer.main(str(work / "lr.png"), str(work / "sr.png"), str(work / "absent.pth"),
                     dtype="bfloat16", device="cuda")
    sec = time.perf_counter() - t0
    with Image.open(out) as img:
        ok = img.size == (4 * w, 4 * h)
        size = img.size
    log(f"  infer.main {w}x{h} PNG -> {size[0]}x{size[1]} PNG in {sec:.1f} s (model build, "
        f"weight synthesis and one tile) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("infer.main: output size")


# the kernels' names in csrc/ start with these
PREFIXES = {"conv3x3": "::conv3x3_", "conv3x3_shuffled": "::shuffled_conv_",
            "conv3x3_shuffled_tail(_packed)": "::tail_", "htb_tail": "::htb_tail_",
            "scc_block": "::scc_", "fusion_pools": "::pools_", "fusion maps+gate": "::fusion_",
            "htb_fused": "::htb_fused_"}


def profile_call(fn) -> dict:
    """Where the time of one ``fn()`` goes: device time by kernel name
    (torch.profiler), device busy time against the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's own row repeats its kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    ours = {name: sum(ms for ms, _, key in rows if pre in key) for name, pre in PREFIXES.items()}
    log(f"  wall {wall:.1f} ms under the profiler, device busy {busy:.1f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle); hand-written kernels "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in ours.items())
        + f", everything else {busy - sum(ours.values()):.1f} ms")
    for ms, count, key in rows[:15]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    return dict(wall_ms=wall, busy_ms=busy, kernels_ms=ours)


def run_profile(served: dict, dt: str) -> None:
    """Where one tile's time goes in ``dt``."""
    import torch

    model, tile = served["models"][dt], served["tiles"][0]
    with torch.inference_mode():
        profile_call(lambda: model(tile))


def flagship(dt: str, like, fused_htb: bool):
    """The flagship in ``dt`` on the card with ``like``'s weights."""
    import torch
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config

    model = HiTSIR(**flagship_config(), dtype=getattr(torch, dt), fused_htb=fused_htb)
    model = model.to("cuda").eval()
    model.load_state_dict(like.state_dict(), strict=True)
    return model


def expected_counts(h: int, w: int, nb: int, packed: bool, fused: bool) -> dict:
    """Launches of one whole-image request: h x w after alignment, nb head
    bands.  The body: 8 convs (6 RHTB, conv_after_body,
    conv_before_upsample), the Fusion gate, 36 blocks of SCC + tail (30
    emit the next block's stats); with fused_htb the window-4 and window-8
    blocks (6 each, all emitting stats) that their windows divide run as
    htb_fused.  Each band: conv_up1, conv_up2 and the tail."""
    from sisr_tpu_torch.ops.kernels import build

    nf = (6 if fused and h % 4 == 0 and w % 4 == 0 else 0) + \
         (6 if fused and h % 8 == 0 and w % 8 == 0 else 0)
    want = dict.fromkeys(build.launches, 0)
    want.update(conv3x3=8 + nb, conv3x3_shuffled=nb, fusion_pools=1, fused_fusion=1,
                scc_block=36 - nf, htb_tail=36 - nf, htb_tail_stats=30 - nf, htb_fused=nf)
    want["conv3x3_shuffled_tail_packed" if packed else "conv3x3_shuffled_tail"] = nb
    return want


def run_whole(served: dict, failures: list, profile: bool) -> dict:
    """BandedHeadSR over the flagship: the 1080p frame as bench.py runs it
    (bf16 unfused and fused_htb in turns, then f32), then the smaller
    requests with align 0, every launch counter checked per request."""
    import statistics

    import torch
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.parallel.tiling import BandedHeadSR

    m16, m32 = served["models"]["bfloat16"], served["models"]["float32"]
    models = {"bf16": m16, "bf16 fused_htb": flagship("bfloat16", m16, True), "f32": m32}
    dts = {"bf16": torch.bfloat16, "bf16 fused_htb": torch.bfloat16, "f32": torch.float32}
    g = torch.Generator(device="cuda").manual_seed(1)
    frame = torch.rand((*FRAME, 3), generator=g, device="cuda")
    small = [torch.rand((h, w, 3), generator=g, device="cuda") for h, w in SMALL]
    summary = {}

    def request(label, img, align, timed=None):
        runner = BandedHeadSR(models[label], band_rows=BAND_ROWS, out_dtype=dts[label],
                              align=align)
        h, w = img.shape[:2]
        hh, ww = (-(-h // align) * align, -(-w // align) * align) if align else (h, w)
        form, tbe, pos, packed = runner.plan(hh, ww)
        torch.cuda.reset_peak_memory_stats()
        before = dict(build.launches)
        t0 = time.perf_counter()
        out = runner(img)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {k: build.launches[k] - before[k] for k in build.launches}
        want = expected_counts(hh, ww, len(pos), packed, label.endswith("fused_htb"))
        ok = (tuple(out.shape) == (4 * h, 4 * w, 3) and out.dtype == dts[label]
              and bool(torch.isfinite(out).all()) and got == want)
        if not ok:
            failures.append(f"whole {label} {h}x{w}: shape/finite/launch counts "
                            f"(got {got}, want {want})")
        if timed is not None:
            timed.append((sec * 1e3, torch.cuda.max_memory_allocated()))
        return dict(ok=ok, ms=sec * 1e3, form=form, bands=len(pos), band_rows=tbe,
                    packed=packed, launches=got)

    with torch.inference_mode():
        build.reset_launches()
        runs = {label: [] for label in models}
        for label in models:          # warm: cuBLAS handles, kernel attributes
            first = request(label, frame, FRAME_ALIGN)
            log(f"  {label:15s} 1080p warm-up: {first['ms']:.1f} ms, {first['form']} "
                f"{first['bands']} bands of {first['band_rows']}, packed {first['packed']}, "
                f"launches {first['launches']} {'ok' if first['ok'] else 'FAIL'}")
        for _ in range(3):            # unfused and fused bf16 in turns, then f32
            for label in ("bf16", "bf16 fused_htb"):
                request(label, frame, FRAME_ALIGN, runs[label])
        for _ in range(3):
            request("f32", frame, FRAME_ALIGN, runs["f32"])
        mp = FRAME[0] * FRAME[1] / 1e6
        for label, rs in runs.items():
            ms = [r[0] for r in rs]
            med = statistics.median(ms)
            summary[label] = dict(min_ms=min(ms), median_ms=med, runs_ms=ms,
                                  input_mp_per_s=mp / (med / 1e3),
                                  peak_gib=max(r[1] for r in rs) / 2 ** 30)
            log(f"  {label:15s} 1080p (LR {FRAME[0]}x{FRAME[1]} -> {4 * FRAME[0]}x"
                f"{4 * FRAME[1]}): min {min(ms):.1f} ms, median {med:.1f} ms over {len(ms)}, "
                f"{summary[label]['input_mp_per_s']:.4f} input MP/s, peak "
                f"{summary[label]['peak_gib']:.2f} GiB")
        a, b = summary["bf16"]["median_ms"], summary["bf16 fused_htb"]["median_ms"]
        log(f"  fused_htb A/B (bf16, medians, runs in turns): fused {b:.1f} ms vs unfused "
            f"{a:.1f} ms: {b - a:+.1f} ms ({100 * (b - a) / a:+.1f}%)")
        for label in ("bf16", "f32"):
            for (h, w), img in zip(SMALL, small):
                r = request(label, img, 0)
                log(f"  {label:15s} {h}x{w} (align 0): {r['ms']:.1f} ms, {r['form']} "
                    f"{r['bands']} band(s) of {r['band_rows']}, packed {r['packed']}, "
                    f"launches {r['launches']} {'ok' if r['ok'] else 'FAIL'}")
        counts = dict(build.launches)
        log(f"  launches over the whole phase: {counts}")
        if profile:
            for label in ("bf16", "bf16 fused_htb"):
                log(f"[profile] one {label} 1080p frame")
                runner = BandedHeadSR(models[label], band_rows=BAND_ROWS,
                                      out_dtype=dts[label], align=FRAME_ALIGN)
                summary[label]["profile"] = profile_call(lambda: runner(frame))
    del models["bf16 fused_htb"]
    torch.cuda.empty_cache()
    log(json.dumps({"whole": summary}))
    return counts


def run_check(served: dict, failures: list) -> None:
    """Kernel path vs the plain model on one tile of each request."""
    import torch
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.utils.precision import exact_mode

    models, tiles = served["models"], served["tiles"]
    m32, m16 = models["float32"], models["bfloat16"]
    rounded = infer.create_model("float32", "cuda")
    rounded.load_state_dict({k: v.to(torch.bfloat16).float()
                             for k, v in m32.state_dict().items()})
    err, sq = 0.0, {"k16": 0.0, "p16": 0.0, "in": 0.0, "w": 0.0}
    with torch.inference_mode(), exact_mode():
        for tile in tiles:
            ref = m32(tile, reference=True).clamp(0, 1)
            err = max(err, float((m32(tile).clamp(0, 1) - ref).abs().max()))
            outs = {
                "k16": m16(tile).float(),
                "p16": m16(tile, reference=True).float(),
                # how far these weights let any bfloat16 forward come: the
                # float32 plain model fed the bf16-rounded input, and with
                # bf16-rounded weights
                "in": m32(tile.to(torch.bfloat16).float(), reference=True),
                "w": rounded(tile, reference=True),
            }
            for k, y in outs.items():
                sq[k] += float(((y.clamp(0, 1) - ref) ** 2).mean()) / len(tiles)
    db = {k: 10 * math.log10(1.0 / max(v, 1e-20)) for k, v in sq.items()}
    # 44 dB is the JAX flagship's bar (test_model_parity.py:124-133); where
    # the plain bfloat16 model does not reach 47 dB on these weights, the
    # kernels must come within 3 dB of the plain bfloat16 model
    bar16 = min(44.0, db["p16"] - 3.0)
    ok32, ok16 = err <= 1e-3, db["k16"] >= bar16
    log(f"  over {len(tiles)} tiles: f32 kernels vs f32 plain: max abs {err:.3e} (bar 1e-3) "
        f"{'ok' if ok32 else 'FAIL'}")
    log(f"  bf16 kernels vs f32 plain: {db['k16']:.2f} dB PSNR (bar {bar16:.2f}: "
        f"{'44 dB' if bar16 == 44.0 else 'plain bf16 - 3 dB'}) "
        f"{'ok' if ok16 else 'FAIL'}; bf16 plain vs f32 plain: {db['p16']:.2f} dB")
    log(f"  f32 plain vs itself fed the bf16-rounded input: {db['in']:.2f} dB; "
        f"with bf16-rounded weights: {db['w']:.2f} dB")
    if not (ok32 and ok16):
        failures.append("whole-model check against the plain model")


def run_whole_check(served: dict, failures: list) -> None:
    """BandedHeadSR against the whole forward and the plain model on the
    smaller stacked/packed and canvas/unpacked requests, float32 (TF32
    off): banded vs the whole forward on the kernels within 1e-5 max abs
    (test_tiling.py:174), vs the plain whole model within 1e-3; bfloat16
    banded vs the float32 plain model, PSNR pooled over both requests, at
    the tile check's bar; fused_htb vs unfused within 1e-4 (other kernels,
    so not bit-equal)."""
    import torch
    from sisr_tpu_torch.parallel.tiling import BandedHeadSR
    from sisr_tpu_torch.utils.precision import exact_mode

    m16, m32 = served["models"]["bfloat16"], served["models"]["float32"]
    m32f = flagship("float32", m32, True)
    g = torch.Generator(device="cuda").manual_seed(2)
    reqs = SMALL[1:]
    imgs = [torch.rand((h, w, 3), generator=g, device="cuda") for h, w in reqs]
    err = dict(whole=0.0, plain=0.0, fused=0.0)
    sq = dict(k16=0.0, p16=0.0)
    with torch.inference_mode(), exact_mode():
        for img in imgs:
            banded = BandedHeadSR(m32, BAND_ROWS)(img)
            whole = m32(img[None])[0]
            plain = m32(img[None], reference=True)[0].clamp(0, 1)
            err["whole"] = max(err["whole"], float((banded - whole).abs().max()))
            err["plain"] = max(err["plain"], float((banded.clamp(0, 1) - plain).abs().max()))
            fused = BandedHeadSR(m32f, BAND_ROWS)(img)
            err["fused"] = max(err["fused"], float((fused - banded).abs().max()))
            outs = {"k16": BandedHeadSR(m16, BAND_ROWS, out_dtype=torch.float32)(img),
                    "p16": m16(img[None], reference=True)[0].float()}
            for k, y in outs.items():
                sq[k] += float(((y.clamp(0, 1) - plain) ** 2).mean()) / len(imgs)
    db = {k: 10 * math.log10(1.0 / max(v, 1e-20)) for k, v in sq.items()}
    bar16 = min(44.0, db["p16"] - 3.0)
    oks = dict(whole=err["whole"] <= 1e-5, plain=err["plain"] <= 1e-3,
               fused=err["fused"] <= 1e-4, bf16=db["k16"] >= bar16)
    mark = lambda k: "ok" if oks[k] else "FAIL"
    log(f"  over {', '.join(f'{h}x{w}' for h, w in reqs)}, f32: banded vs whole forward "
        f"max abs {err['whole']:.3e} (bar 1e-5) {mark('whole')}; vs the plain whole model "
        f"{err['plain']:.3e} (bar 1e-3) {mark('plain')}; fused_htb vs unfused "
        f"{err['fused']:.3e} (bar 1e-4) {mark('fused')}")
    log(f"  bf16 banded vs f32 plain: {db['k16']:.2f} dB PSNR (bar {bar16:.2f}: "
        f"{'44 dB' if bar16 == 44.0 else 'plain bf16 - 3 dB'}) {mark('bf16')}; "
        f"bf16 plain vs f32 plain: {db['p16']:.2f} dB")
    if not all(oks.values()):
        failures.append("whole-image check against the whole forward and the plain model")


# what each path must launch: serving the tiles, and the whole-image path
SERVE_KERNELS = ("conv3x3", "conv3x3_shuffled", "conv3x3_shuffled_tail", "htb_tail",
                 "scc_block", "fusion_pools", "fused_fusion")
PER = {"tile": "one 192x192 tile (sum over its shapes)",
       "frame": "one 1080p frame, LR 1088x1920 aligned (sum over its calls: 8 bands; "
                "6 window-4 and 6 window-8 blocks with fused_htb)"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phases", default="build,kernels,serve,whole,profile,check")
    args = p.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card",
              file=sys.stderr)
        return 1
    from sisr_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    failures: list = []
    rows, extra, served, whole = {}, {}, None, None

    log("[build]")
    try:
        sec = build.build_all()
        log(f"  built {', '.join(build.KERNELS)} in {sec:.1f} s")
        for name, text in build.build_logs.items():
            for line in text.splitlines():
                if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
                    log(f"  {name}: {line.strip()}")
    except Exception:
        failures.append(f"build: {traceback.format_exc()}")
        log(traceback.format_exc())
    if "kernels" in phases and not failures:
        log("[kernels] per shape of one 192x192 flagship tile, then of the 1080p frame")
        rows, extra = run_kernels(failures)
    if "serve" in phases and not failures:
        log("[serve] TiledSR(tile 192, overlap 16) over HiTSIR(**flagship_config())")
        try:
            served = run_serving(failures)
        except Exception:
            failures.append(f"serve: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "whole" in phases and served is not None and not failures:
        log(f"[whole] BandedHeadSR(band_rows {BAND_ROWS}) over HiTSIR(**flagship_config())")
        try:
            whole = run_whole(served, failures, "profile" in phases)
        except Exception:
            failures.append(f"whole: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "profile" in phases and served is not None:
        for dt in ("bfloat16", "float32"):
            log(f"[profile] one {dt} 192x192 tile")
            try:
                run_profile(served, dt)
            except Exception:
                failures.append(f"profile: {traceback.format_exc()}")
                log(traceback.format_exc())
    if "check" in phases and served is not None:
        log("[check] a 192x192 tile of each request against the plain model (reference=True)")
        try:
            run_check(served, failures)
            if "whole" in phases:
                log("[check] BandedHeadSR against the whole forward and the plain model")
                run_whole_check(served, failures)
        except Exception:
            failures.append(f"check: {traceback.format_exc()}")
            log(traceback.format_exc())

    # each path's counts, set to 0 just before it and read just after
    paths = {"serve": (served or {}).get("counts"), "whole": whole}
    for path, names in (("serve", SERVE_KERNELS), ("whole", tuple(SOURCES))):
        if paths[path] is not None and not all(paths[path][k] > 0 for k in names):
            failures.append(f"the {path} path did not launch every kernel: {paths[path]}")
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        scope = "tile" if (name, "tile") in rows else "frame"
        row = rows.get((name, scope))
        by_path = {p: (c or {}).get(name, 0) for p, c in paths.items()}
        entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=sum(by_path.values()), launches_by_path=by_path)
        if row:
            entry.update(
                max_abs_err=row["err"], ms=row["ms"], plain_ms=row["plain"],
                bound_ms=max(row["t_bytes"], row["t_ops"]),
                bound_by="bytes" if row["t_bytes"] >= row["t_ops"] else "operations",
                library_ms=row["lib"] if row["has_lib"] else None,
                per=PER[scope], timed_dtype="bfloat16",
                err_dtype="float32", ms_f32=row["ms32"], plain_ms_f32=row["plain32"])
        if name in extra:
            entry["whole_frame_cases"] = extra[name]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    if failures:
        print(f"chip_smoke: {len(failures)} failed check(s):", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    if not {"build", "kernels", "serve", "whole", "check"} <= phases:
        log("chip_smoke: partial run (--phases); no result line")
        return 2
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
