#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sisr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --phases build,serve,profile   # a part (no result line)

Phases:
  build    compile every kernel in sisr_tpu_torch/csrc with nvcc (one
           process per source, all at once) into build/kernels/;
  kernels  each of the seven kernels at the shapes one 192x192 tile of the
           flagship gives it, against its plain PyTorch version on the same
           inputs: in
           float32 (TF32 off) within 2e-4 x max(1, max|plain|), and in
           bfloat16, where the kernel must stay within twice the plain
           bfloat16 version's distance from the float32 plain version (or
           4 bf16 ulps of the output scale); then its time (CUDA events,
           warmed) in bfloat16 and float32, the plain version's, the bound
           (bfloat16 bytes at 3.35 TB/s, or operations at 989 TFLOP/s on
           the tensor cores and 67 TFLOP/s for float32 work on the FP32
           pipes, whichever is larger) and, where one PyTorch call computes the
           same function, that call's time;
  serve    the serving entry point (TiledSR over HiTSIR, the full flagship
           with its Fusion gate, synthesized weights) on three requests, bfloat16
           then float32, with every launch counter checked per tile; then
           the command line's path once (``infer.main``, PNG in and out);
  profile  one bfloat16 and one float32 tile under torch.profiler: device
           time by kernel, device busy time against the tile's wall time;
  check    a 192x192 tile of each request through the plain model on the
           card (``reference=True``): float32 kernels within 1e-3 max abs;
           bfloat16 kernels >= 44 dB PSNR (mean squared error over the
           tiles) against the float32 plain model, or, where the plain
           bfloat16 model itself stays below 47 dB (these synthesized
           weights amplify any rounding), within 3 dB of it.

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
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, target_s: float = 0.25, max_iters: int = 50) -> float:
    """Mean device ms of ``fn`` over a warmed run of launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = time.perf_counter() - t0
    n = max(3, min(max_iters, int(target_s / max(est, 1e-6))))
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


# --- the kernels' cases: the shapes of one flagship tile ---------------------

class Case:
    """One kernel call at one shape: inputs from a seeded generator, the
    call, and the work it must do: bytes moved once, operations of the
    bfloat16 run on the tensor cores (``flops``) and on the FP32 pipes
    (``flops32``: float32 work the function keeps in float32)."""

    def __init__(self, kernel, label, per_tile, make, call, nbytes, flops,
                 library=None, flops32=0.0):
        self.kernel, self.label, self.per_tile = kernel, label, per_tile
        self.make, self.call, self.nbytes, self.flops = make, call, nbytes, flops
        self.library, self.flops32 = library, flops32

    def t_ops(self) -> float:
        """Least ms for the operations: each type at its peak, the two pipes
        side by side."""
        return max(self.flops / PEAK_BF16_FLOPS, self.flops32 / PEAK_F32_FLOPS) * 1e3


def conv_cases():
    import torch
    import torch.nn.functional as F
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3

    shapes = [  # (h, w, cin, cout, act, res, per tile)
        (192, 192, 180, 180, "none", True, 6),    # RHTB residual convs
        (192, 192, 180, 180, "none", False, 1),   # conv_after_body
        (192, 192, 180, 64, "leaky", False, 1),   # conv_before_upsample
        (192, 192, 64, 256, "leaky2", False, 1),  # conv_up1 (phase-folded, packed out)
    ]
    cases = []
    for h, w, cin, cout, act, res, n in shapes:
        def make(dt, h=h, w=w, cin=cin, cout=cout, res=res):
            g = torch.Generator(device="cuda").manual_seed(h * 7 + cin + cout)
            rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
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
                          n, make, call, nbytes, 2.0 * h * w * 9 * cin * cout, library))
    return cases


def head_cases():
    """The packed x4 head's conv_up2 (shuffled conv) and conv_hr + conv_last
    (shuffled tail) at one tile's shapes; no single PyTorch call computes
    either."""
    import torch
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled, conv3x3_shuffled_tail

    f = 64

    def gen(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return lambda *s: torch.randn(*s, generator=g, device="cuda")

    def make_up(dt):
        rn = gen(11)
        ins = [rn(1, 192, 192, 4 * f), rn(3, 3, f, 4 * f) / math.sqrt(9 * f), rn(4 * f) * 0.1]
        return [t.to(dt) for t in ins]

    def make_tail(dt):
        rn = gen(12)
        ins = [rn(1, 384, 384, 4 * f), rn(3, 3, f, f) / math.sqrt(9 * f), rn(f) * 0.1,
               rn(3, 3, f, 3) / math.sqrt(9 * f), rn(3) * 0.1]
        return [t.to(dt) for t in ins]

    up = Case("conv3x3_shuffled", "yp 192x192x256 -> 384x384 64->256 leaky2", 1, make_up,
              lambda ins, reference: conv3x3_shuffled(*ins, "leaky2", reference=reference),
              lambda es: es * (192 * 192 * 4 * f + 9 * f * 4 * f + 4 * f + 384 * 384 * 4 * f),
              2.0 * 384 * 384 * 9 * f * 4 * f)
    tail = Case("conv3x3_shuffled_tail", "yp 384x384x256 -> 768x768 64->64->3", 1, make_tail,
                lambda ins, reference: conv3x3_shuffled_tail(
                    ins[0], ins[1], ins[2], "leaky2", ins[3], ins[4], reference=reference),
                lambda es: es * (384 * 384 * 4 * f + 9 * f * f + f + 9 * f * 3 + 3
                                 + 768 * 768 * 3),
                2.0 * 768 * 768 * 9 * f * (f + 3))
    return [up, tail]


def fusion_cases():
    """The Fusion gate at one tile's shapes (a, b 1x192x192x180): the pools
    alone, and the whole gate (pools, maps, gate) with its packed weights
    made once, as the model keeps them.  Operations, per UA k of three:

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
    import torch
    from sisr_tpu_torch.ops.kernels.fusion_ops import fused_fusion, fusion_pools, pack_params

    h = w = TILE
    c = 180

    def make_ab(dt):
        g = torch.Generator(device="cuda").manual_seed(21)
        return [torch.randn(1, h, w, c, generator=g, device="cuda").to(dt) for _ in range(2)]

    def make_fused(dt):
        g = torch.Generator(device="cuda").manual_seed(22)
        rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
        raws = tuple(((rn(3, 3, 2, 1) / 4.0, 0.01 * rn(1)), (rn(3, 3, 2, 1) / 4.0, 0.01 * rn(1)),
                      (rn(3, 3, 2, 1) / 4.0, 0.01 * rn(1)),
                      (rn(3, 3, c, c) / math.sqrt(9 * c), 0.01 * rn(c))) for _ in range(3))
        a, b = make_ab(dt)
        return [a, b, raws, pack_params(raws, c, dt)]

    pool_bytes = lambda es: es * (2 * h * w * c + 6 * h * w + 6 * h * c) + 4 * 6 * w * c
    pool_ops = 19.0 * h * w * c
    pools = Case("fusion_pools", f"a, b {h}x{w}x{c}", 1, make_ab,
                 lambda ins, reference: fusion_pools(*ins, reference=reference), pool_bytes,
                 0.0, flops32=pool_ops)
    map_ops = 2.0 * 27 * (h + w) * c * c + 2.0 * 18 * 3 * (h * w + (h + w) * c)
    fused = Case("fused_fusion", f"a, b {h}x{w}x{c}, pools + maps + gate", 1, make_fused,
                 lambda ins, reference: fused_fusion(ins[0], ins[1], ins[2], ins[3], reference),
                 lambda es: (es * (3 * h * w * c + 3 * 18 * c * c + 27 * 3 * c)
                             + 4 * (3 * 3 * 18 + 9 + 3 * c)),
                 2.0 * 9 * 3 * h * w * c, flops32=pool_ops + map_ops + 20.0 * h * w * c)
    return [pools, fused]


def htb_cases():
    import torch
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail, htb_tail_stats

    h = w = TILE
    c, ch = 180, 360
    cases = []
    for stats, n in ((True, 30), (False, 6)):
        def make(dt):
            g = torch.Generator(device="cuda").manual_seed(5)
            rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
            ins = [rn(1, h, w, c), rn(1, h, w, c), 1 + 0.05 * rn(c), 0.01 * rn(c),
                   rn(c, ch) / math.sqrt(c), 0.01 * rn(ch), rn(5, 5, ch) / 5.0,
                   0.01 * rn(ch), rn(ch, c) / math.sqrt(ch), 0.01 * rn(c),
                   1 + 0.05 * rn(c), 0.01 * rn(c)]
            return [t.to(dt) for t in ins]

        fn = htb_tail_stats if stats else htb_tail

        def call(ins, reference, fn=fn):
            return fn(*ins, reference=reference)

        def nbytes(es, stats=stats):
            weights = 2 * c * ch + 25 * ch + 2 * ch + 6 * c
            stat = 4 * (2 * h * w + 2 * c) if stats else 0
            return es * (3 * h * w * c + weights) + stat

        flops = 2.0 * h * w * (2 * c * ch + 25 * ch)
        cases.append(Case("htb_tail", f"{h}x{w} C={c} Ch={ch}{' +stats' if stats else ''}",
                          n, make, call, nbytes, flops))
    return cases


def scc_cases():
    import torch
    from sisr_tpu_torch.ops.kernels.scc_attention import (blockdiag_kgen, head_mask,
                                                          pooling_matrix)
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    h = w = TILE
    c, heads, base = 180, 6, 8
    half, d = c // 2, c // 12
    cases = []
    for win in (4, 8, 16, 32, 48, 64):
        bh = min(win, base)
        lb, big_l, rh = bh * bh, win * win, win // bh

        def make(dt, win=win, bh=bh, lb=lb, big_l=big_l, rh=rh):
            g = torch.Generator(device="cuda").manual_seed(win)
            rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
            x = rn(1, h, w, c)
            sca = (rn(9, c) / 3.0, 0.01 * rn(c), rn(9, c) / 3.0, 0.01 * rn(c),
                   0.3 * rn(1, 1, 1, c), 0.3 * rn(1, 1, 1, c))
            w1, w2, bb = blockdiag_kgen(rn(d, d) / math.sqrt(d), 0.01 * rn(d),
                                        rn(d, d) / math.sqrt(d), 0.01 * rn(d), heads)
            pmat, pb = pooling_matrix(rn(rh * rh, 1) / rh, 0.01 * rn(1), win, win,
                                      bh, bh, torch.float32)
            mask = head_mask(heads, lb, half, torch.float32, "cuda")
            bias = 0.1 * rn(big_l, heads * lb)
            proj_k, proj_b = rn(c, c) / math.sqrt(c), 0.01 * rn(c)
            cast = lambda t: t.to(dt)
            return [cast(x), tuple(map(cast, sca)), cast(w1), cast(w2), cast(bb),
                    cast(pmat), pb, cast(mask), cast(bias), cast(proj_k), cast(proj_b)]

        def call(ins, reference, win=win):
            return scc_block(*ins, heads, (win, win), reference=reference)

        def nbytes(es, lb=lb, big_l=big_l):
            return es * (2 * h * w * c + h * w * 18 + big_l * heads * lb
                         + c * half + c * c + 40 * c + big_l * lb)

        per_token = (18 * c + c * half + half * half + 2 * lb * half
                     + half * half + lb * half + half * half + c * c)
        flops = 2.0 * h * w * per_token + 2.0 * (h * w // big_l) * lb * half * d
        cases.append(Case("scc_block", f"{h}x{w} window {win} (L={big_l}, l_base={lb})",
                          6, make, call, nbytes, flops))
    return cases


def run_kernels(failures: list) -> list:
    """Hold every kernel against its plain version; time both."""
    import torch
    from sisr_tpu_torch.utils.precision import exact_mode

    f32, b16 = torch.float32, torch.bfloat16
    rows = {}
    for case in conv_cases() + head_cases() + htb_cases() + scc_cases() + fusion_cases():
        try:
            with exact_mode():
                ins32 = case.make(f32)
                got = case.call(ins32, False)
                ref = case.call(ins32, True)
                torch.cuda.synchronize()
                e32 = _errs(got, ref)
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
            ok = ok32 and ok16
            for t in _flat(got) + _flat(got16):
                ok = ok and bool(torch.isfinite(t).all())
            ms = time_ms(lambda: case.call(ins16, False))
            plain_ms = time_ms(lambda: case.call(ins16, True), max_iters=10)
            lib_ms = time_ms(lambda: case.library(ins16)) if case.library else None
            with exact_mode():
                ms32 = time_ms(lambda: case.call(ins32, False))
                plain32 = time_ms(lambda: case.call(ins32, True), max_iters=10)
            t_bytes = case.nbytes(2) / HBM_BYTES_PER_S * 1e3
            t_ops = case.t_ops()
            log(f"  {case.kernel:21s} {case.label:40s} f32 err {err32:.3e} "
                f"{'ok' if ok32 else 'FAIL'} | bf16 err vs plain {err16:.3e}, vs f32 "
                f"{err16_k:.3e} (plain bf16 vs f32 {err16_p:.3e}) {'ok' if ok16 else 'FAIL'} "
                f"| bf16 ms {ms:.4f} plain {plain_ms:.4f} "
                f"lib {'-' if lib_ms is None else f'{lib_ms:.4f}'} | f32 ms {ms32:.4f} "
                f"plain {plain32:.4f} | bound {max(t_bytes, t_ops):.4f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}) x{case.per_tile}/tile "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"kernel {case.kernel} {case.label} disagrees with its plain version")
            row = rows.setdefault(case.kernel, dict(err=0.0, ms=0.0, plain=0.0, lib=0.0,
                                                    ms32=0.0, plain32=0.0,
                                                    has_lib=case.library is not None,
                                                    t_bytes=0.0, t_ops=0.0))
            row["err"] = max(row["err"], err32)
            row["ms"] += case.per_tile * ms
            row["plain"] += case.per_tile * plain_ms
            row["lib"] += case.per_tile * (lib_ms or 0.0)
            row["ms32"] += case.per_tile * ms32
            row["plain32"] += case.per_tile * plain32
            row["t_bytes"] += case.per_tile * t_bytes
            row["t_ops"] += case.per_tile * t_ops
        except Exception:  # record, keep checking the other kernels
            failures.append(f"kernel {case.kernel} {case.label}: {traceback.format_exc()}")
            log(f"  {case.kernel} {case.label} FAILED\n{traceback.format_exc()}")
    return rows


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


def run_profile(served: dict, dt: str) -> None:
    """Where one tile's time goes in ``dt``: device time by kernel name
    (torch.profiler), device busy time against the tile's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, tile = served["models"][dt], served["tiles"][0]
    with torch.inference_mode():
        model(tile)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(tile)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's own row repeats its kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    # the kernels' names in csrc/ start with these
    prefixes = {"conv3x3": "::conv3x3_", "conv3x3_shuffled": "::shuffled_conv_",
                "conv3x3_shuffled_tail": "::tail_", "htb_tail": "::htb_tail_",
                "scc_block": "::scc_", "fusion_pools": "::pools_",
                "fusion maps+gate": "::fusion_"}
    ours = {name: sum(ms for ms, _, key in rows if pre in key) for name, pre in prefixes.items()}
    log(f"  wall {wall:.1f} ms under the profiler, device busy {busy:.1f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle); hand-written kernels "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in ours.items())
        + f", everything else {busy - sum(ours.values()):.1f} ms")
    for ms, count, key in rows[:15]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phases", default="build,kernels,serve,profile,check")
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
    rows, served = {}, None

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
        log("[kernels] per shape of one 192x192 flagship tile")
        rows = run_kernels(failures)
    if "serve" in phases and not failures:
        log("[serve] TiledSR(tile 192, overlap 16) over HiTSIR(**flagship_config())")
        try:
            served = run_serving(failures)
        except Exception:
            failures.append(f"serve: {traceback.format_exc()}")
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
        except Exception:
            failures.append(f"check: {traceback.format_exc()}")
            log(traceback.format_exc())

    counts = (served or {}).get("counts") or {}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        row = rows.get(name)
        entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=counts.get(name, 0))
        if row:
            entry.update(
                max_abs_err=row["err"], ms=row["ms"], plain_ms=row["plain"],
                bound_ms=max(row["t_bytes"], row["t_ops"]),
                bound_by="bytes" if row["t_bytes"] >= row["t_ops"] else "operations",
                library_ms=row["lib"] if row["has_lib"] else None,
                per="one 192x192 tile (sum over its shapes)", timed_dtype="bfloat16",
                err_dtype="float32", ms_f32=row["ms32"], plain_ms_f32=row["plain32"])
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    if failures:
        print(f"chip_smoke: {len(failures)} failed check(s):", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    if not {"build", "kernels", "serve", "check"} <= phases:
        log("chip_smoke: partial run (--phases); no result line")
        return 2
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
