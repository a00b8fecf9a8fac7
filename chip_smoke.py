#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sisr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --phases build,serve,whole   # a part (no result line)
    python3 chip_smoke.py --ab build/base   # the redesigned kernels against a checkout

Phases:
  build    compile every kernel in sisr_tpu_torch/csrc with nvcc (one
           process per source, all at once) into build/kernels/; count
           the HGMMA instructions in the SASS of the conv3x3, scc_block,
           htb_tail and shuffled_tail libraries, of htb_fused's launch A
           (htb_fused_wg) in its library, and the HGMMA or HMMA of the
           shuffled conv's own kernels (shuffled_conv_wgmma_*) in conv3x3's
           and of the Fusion gate's maps (fusion_maps) in fusion's (their
           bfloat16 paths run on the tensor cores: none fails the run);
  kernels  each of the twelve kernel functions against its plain PyTorch
           version on the same inputs, first at the shapes one 192x192 tile
           of the flagship gives it, then at the 1080p frame's: the packed
           tail at a head band, htb_fused at window 4 and 8 on 1088x1920,
           and one case of each earlier kernel that a tile never gives it
           (scc_block with 130,560 windows of 4x4 and at window 48 on a
           padded map, htb_tail_stats with a padded attn, htb_fused's
           unfused pair on its inputs, conv3x3
           180->180, fusion_pools and fused_fusion, conv3x3_shuffled at
           a band); then
           every kernel shape a training step launches (batch 2, LR
           64x64: each conv, the x4 head, the Fusion gate, scc_block at
           each window, 64x64 or reflect-padded to 96x96, htb_tail,
           dwconv5x5 forward and dx through ``dwconv_vjp``), with its calls
           a step, and dwconv5x5 at a tile's (1, 192, 192, 360); then the
           Fusion gate at DenseSR's width (C = 64): its training step's
           (2, 64, 64, 64), an eval image's (1, 96, 120, 64) and a 192x192
           tile's; then HAT's window attention (win_attn: window 16,
           unshifted, shifted by 8, and the overlapping 24 square) on a
           1088x1920 map with its calls a HAT frame, and on a 192x192
           tile.  In
           float32 (TF32 off)
           within 2e-4 x max(1, max|plain|), and in bfloat16, where the
           kernel must stay within twice the plain bfloat16 version's
           distance from the float32 plain version (or 4 bf16 ulps of the
           output scale); then its time (CUDA events, warmed) in bfloat16
           and float32, the plain version's, the bound (bfloat16 bytes at
           3.35 TB/s, or operations at 989 TFLOP/s on the tensor cores and
           67 TFLOP/s for float32 work on the FP32 pipes, whichever is
           larger; for the training step's cases float32 bytes, and every
           operation on the FP32 pipes) and, where one PyTorch call
           computes the same function, that call's time (for the x4
           head's conv_up2 and tails: one and two cuDNN ``F.conv2d`` calls
           over the shuffle materialized before the timing, no
           activation); each case's line adds its TFLOP/s and share of its
           bound in both types.
           Then htb_tail's tail launch alone (htb_tail_out_wg) at a
           192x192 tile and at a 192x1920 band of the frame, bfloat16 with
           the statistics: its device ms beside the call's, the plain
           version's and the tail's bound.  Then one dwconv5x5 dx through
           ``dwconv_vjp`` under
           torch.profiler, which must launch one device kernel (the
           device-side copy of its span is no kernel), and the
           Fusion gate's gradients through ``KernelFunction`` at DenseSR's
           step against the plain path's (1e-6, deterministic cuDNN);
  split    device time of each kernel launch of one fusion_pools and one
           fused_fusion call at a 192x192 tile (bfloat16 and float32) and
           at the frame (bfloat16), of one scc_block call at
           every window of a 192x192 tile (bfloat16 and float32) and at
           the frame's windows 4 and 48, of one htb_tail call (with and
           without stats) at a tile and at the frame, and of one htb_fused
           call at the frame's windows 4 and 8 (launch A against launch B)
           beside the unfused pair on the same inputs (scc_block at the
           same window, then htb_tail_stats) (torch.profiler), one
           ``split ...`` line each;
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
  train    first the flagship's bfloat16 step (parameters and Adam's state
           float32, no loss scaling) against the plain bfloat16 path for 3
           Adam steps, the plain path taking the kernel path's updated
           weights before each (a stale packed weight would show from step
           2): each step's L1 loss and every gradient within max(floor,
           3x the plain path's move when the LR batch moves by one
           bfloat16 ulp; a gradient's error relative to max(its norm,
           1e-3 of the whole gradient's)), with its control (the
           gradients x 1.1) rejected; then
           training steps of the full flagship in float32 and in bfloat16
           through ``train_state.make_train_step`` (L1 loss, Adam 2e-5,
           betas (0.9, 0.99)) on seeded batches, LR (2, 64, 64, 3) -> HR
           (2, 256, 256, 3): 2 warm-up steps, then 5 timed (median and min
           ms, LR MP/s, peak device memory, every launch counter checked
           per step); one more step split into forward, backward and
           optimizer by CUDA events and one under torch.profiler (device
           busy time, idle share); the same 2 + 5 steps on the plain path
           (``plain_versions()``) as a yardstick;
  runner   the experiment runner as ``python -m sisr_tpu_torch hitsir_pro``
           builds it (the full flagship in float32, L1, Adam, batch 2, crop
           64, two spawned loader workers, weights from param_synth) on
           image folders synthesized under build/smoke/runner: 2 epochs of
           train (BSRGAN-degraded crops) and eval (Y-PSNR/SSIM; LR 96x120 on
           the whole forward, 256x320 on BandedHeadSR's 2 packed bands),
           the same command resumed to epoch 3 (model, optimizer state,
           the cosine lr), then test mode on the best checkpoint.  Every
           train step must launch what a ``train`` step does, every eval
           and test image what its route does; each SR of the last evals
           within 1e-3 of the plain model (float32, TF32 off), the logged
           metrics the port's psnr / ssim of those SRs, every log and
           checkpoint parsed back; epoch and eval seconds, steps/s and the
           share of a train epoch spent waiting on the loader;
  heads    the flagship's widths and depth (weights from param_synth) with
           each other head of the reference: pixelshuffle x4 and x2,
           pixelshuffledirect x4, and the nearest+conv head after the plain
           3x3 conv_first, on a 192x192 tile in float32 and bfloat16: every
           launch counter checked per forward, the wall ms (median of 3),
           and the kernel path against the plain model at the whole-model
           bars (float32 within 1e-3 max abs and 5e-5 rms, TF32 off;
           bfloat16 >= min(44, plain bfloat16 - 3) dB);
  hat      HAT x4 at its published widths (weights from param_synth) in
           bfloat16 on the 1080p frame (LR 1080x1920, reflect-padded to
           1088x1920 inside the model): every forward's launches exactly 42
           win_attn and 80 conv3x3 (``HAT_FORWARD``), the wall ms (median
           of 3), peak device memory, and the kernel path against the plain
           model (float32, TF32 off) at the heads phase's bfloat16 bar;
           then ``infer.upscale`` (TiledSR, tile 192) on a 200x260 image,
           42 win_attn launches a tile;
  dat      DAT x4 at its published widths (weights from param_synth,
           seeded BatchNorm statistics) in bfloat16 on the 1080p frame (LR
           1080x1920, zero-padded to 1088x1920 inside the spatial
           attention's kernel): every forward's launches exactly 18
           win_attn, 18 chan_attn and 8 conv3x3 (``DAT_FORWARD``), the wall
           ms (median of 3), peak device memory, and the kernel path
           against the plain model (float32, TF32 off) at the heads phase's
           bfloat16 bar; then ``infer.upscale`` (TiledSR, tile 192) on a
           200x260 image, ``DAT_FORWARD`` launches a tile;
  gan      the GAN fine-tune: ``train_state.make_gan_train_step`` over the
           flagship in float32, UNetDiscriminatorSN(64) and a random
           full-width VGG19 (L1 + 1.0 perceptual + 0.1 adversarial, Adam
           2e-5, betas (0.9, 0.99), batch 2, LR 64 -> HR 256), first the
           kernel path against the plain path from the same state on one
           batch, TF32 off (g_loss and d_loss within 1e-4 relative; every
           generator gradient at the train check's bar, its noise probed
           on the GAN loss; the discriminator's parameters and u, v after
           the step within 5e-5 + 1e-3 relative); then 2 warm + 5 timed
           steps on each path with PyTorch's TF32 defaults (median ms, peak
           memory, launches checked per step), one kernel-path step split
           into its G phase, G optimizer, D phase and D optimizer by CUDA
           events and one profiled; then ``python -m sisr_tpu_torch
           hitsir_pro_gan``'s experiment on the runner's folders (under
           build/smoke/gan, LPIPS from random weights written there): 1
           epoch, the resume to epoch 2 from the discriminator's checkpoint
           (both models, both optimizers' state, the lr), test mode; every
           step's and image's launches, the last eval's SRs within 1e-3 of
           the plain model, d_loss, discriminator_lr, a real LPIPS column
           and both checkpoints parsed back; then ``python -m
           sisr_tpu_torch.lpips``'s function on two synthesized 256x320
           PNGs, the card against the CPU (float32, 1e-5 relative);
  families DenseSR at its experiment's defaults (C = 64, the multi-size
           extraction, SCA, the Fusion gate, num_blocks (4, 4); flax's init
           from seed 0): its float32 training step against the plain path
           (the L1 loss 1e-5, every gradient at the train check's bar, the
           step's SR at the whole-model bars) with a control (one packed
           tap of the gate 2^-8 relative off must fail them), a 192x192
           tile in float32 and bfloat16 at the whole-model bars; its
           bfloat16 step against the plain bfloat16 path for 3 Adam steps
           at the train phase's bfloat16 bars (control: the gradients x
           1.1); UNetSR at
           its defaults, the card's float32 forward against the CPU's
           (1e-4); deform_conv2d, deform_attn and upfirdn2d against the CPU
           (1e-5).  Then, counted: 2 warm + 5 timed training steps of each
           family (and Dense's plain path, and Dense in bfloat16: the
           gate's kernels under autograd) with every launch checked per
           step (Dense: the gate's two once; UNet: none), and one step of
           each split by CUDA events and one profiled (device busy);
           ``main("dense" | "unet", ...)`` on folders synthesized under
           build/smoke/families (1 epoch, test mode; every step's and
           image's launches, the eval SR within 1e-3 of the plain model);
           and one float32 step of the flagship with each of HiTSIR's
           options (drop_path_rate=0.1, ape, 3conv, use_checkpoint), its
           launches as the routing rule says;
  mesh     the multi-device layer (parallel/mesh.py) through
           ``mesh.spawn`` (the flagship's weights and the inputs saved
           under build/smoke/mesh for every rank): (a) one rank in an
           NCCL group of one: TiledSR.sharded_call at 480x640 in bfloat16
           and float32 and BandedHeadSR.sharded_call at 256x320 in
           float32 against their single-process calls, 3 float32 DP steps
           (batch 2, LR 64, TF32 off) each against make_train_step's from
           the same state (the loss 1e-5 relative, each gradient at the
           train check's bar); (b) two gloo ranks sharing the card (NCCL
           refuses two ranks on one device): the 480x640 tiles (6 a rank),
           the 256x320 bands (2 a rank) and the bfloat16 1080p frame
           (align 64: sharded_plan's 16 bands of 68, 8 a rank) against the
           single-process calls (float32 1e-5 max abs; bfloat16 2^-5 of the
           output's scale, as two single-process bfloat16 calls already
           differ by up to 1.56e-2), the
           ranks' outputs equal, every rank's launches as its tiles or
           bands give; the DP step (1 image a rank) against the
           single-process step of the batch (the loss 1e-5, each gradient
           at its bar), its control (the gradients summed, not averaged,
           must fail the bars), the ranks' parameters bit-identical after 3
           Adam steps; the same DP step with every dropout of HiTSIR on
           (rate 0.1 each, masks from a CUDA generator seeded alike on both
           ranks) against the single process's step on the whole batch
           (the loss 1e-5, each gradient at its bar, and the mean of the
           per-image gradients with their rows' masks at 1e-5), the ranks'
           parameters and generators equal after 3 steps, its control
           (each rank drawing its own slice's masks) failing the bars, and
           in (a) the same steps on the one NCCL rank; the all_reduce of
           the gradients and of the frame's
           canvas (through gloo's host copy) timed; (c)
           ``hitsir_pro_experiment(n_devices=2)`` on the two ranks, each in
           a directory of its own, for one epoch on folders synthesized
           there: the loss within 1e-4 relative of the single-process
           run's, rank 1's directory empty.  Two ranks on one card measure
           correctness and the collectives' cost, not scaling;
  profile  one bfloat16 and one float32 tile, and a bfloat16 1080p frame
           without and with fused_htb, under torch.profiler: device time
           by kernel, device busy time against the wall time;
  check    a 192x192 tile of each request through the plain model on the
           card (``plain_versions()``): float32 kernels within 1e-3 max abs;
           bfloat16 kernels >= 44 dB PSNR (mean squared error over the
           tiles) against the float32 plain model, or, where the plain
           bfloat16 model itself stays below 47 dB (these synthesized
           weights amplify any rounding), within 3 dB of it.  Then
           BandedHeadSR on 256x320 and 250x330: float32 within 1e-5 of the
           whole forward and 1e-3 of the plain model, bfloat16 at the same
           PSNR bar, fused_htb within 1e-4 of the unfused model, and
           bfloat16 fused_htb at the bfloat16 PSNR bar.  Then the
           training step (float32, TF32 off) from the same weights and
           two batches on the kernel and the plain path: the L1 losses within
           1e-5 relative, every parameter's gradient finite and within a
           relative norm error of max(1e-3, 3x the plain path's own move
           when the input or every weight moves by one float32 ulp, or the
           input by 1e-6 relative); as its control, the same step with a
           fault planted in dwconv5x5's backward (dx from the unflipped
           filter; dx 2^-8 relative too large) must fail that bar; and the
           losses of 5 Adam steps within 1e-4 relative.

``--ab BASE`` runs no phase: it times conv3x3 (the four model shapes at a
tile and a training step), conv3x3_shuffled and the tails (a tile, the
frame's head band, a training step), dwconv5x5 (forward and dx at both maps),
scc_block (every window of a tile, the frame's windows 4 and 48),
htb_tail and htb_tail_stats (a tile, the frame), htb_fused (a tile's and
the frame's windows 4 and 8) and at the frame the unfused pair on its
inputs, and the Fusion gate (fusion_pools and fused_fusion at a tile, the
frame and a training step) in bfloat16 and float32, and the bfloat16 serving
requests of 1 and 12 tiles (wall ms, median of three, and device busy ms
under torch.profiler), from the package in the checkout BASE and from this
one, one process each, in the order base, this, this, base; the first base
and this runs also print their launch split; then a ``{"ab": ...}`` line
(exit 0, no result line).

Prints the card's name and power limit, ``{"whole": ...}``, ``{"train":
...}``, ``{"runner": ...}``, ``{"heads": ...}``, ``{"hat": ...}``, ``{"dat":
...}``, ``{"gan": ...}``, ``{"families": ...}``, ``{"mesh": ...}`` and ``{"kernels": [...]}`` lines
and, as the
last line when every phase passed,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result line, when there is no CUDA card or any
check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_BF16_FLOPS = 989e12                       # H100 SXM, dense
PEAK_F32_FLOPS = 67e12                         # H100 SXM, FP32 outside the tensor cores
SPIN_CYCLES_PER_S = 1.98e9                     # H100 SXM boost clock, for torch.cuda._sleep
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
    "dwconv5x5": ("sisr_tpu_torch/csrc/dwconv.cu", "sisr_tpu/ops/pallas/dwconv.py:74"),
    "win_attn": ("sisr_tpu_torch/csrc/win_attn.cu",
                 "none: HAT's and DAT's window attention (models/hat.py, models/dat.py), "
                 "which the JAX package lacks"),
    "chan_attn": ("sisr_tpu_torch/csrc/chan_attn.cu",
                  "none: DAT's channel attention's whole-image sums (models/dat.py), which "
                  "the JAX package lacks"),
}
# kernels of models/hat.py and models/dat.py alone, which none of the
# HiT-SIR paths below runs
HAT_ONLY = ("win_attn", "chan_attn")
# HAT x4's attention calls on a 1080p frame: (shift, key window, calls)
HAT_ATTN = ((0, 16, 18), (8, 16, 18), (0, 24, 6))
# DAT x4's spatial attention calls on a 1080p frame (both branches a call):
# (shift, calls); and its channel attention's sums, 18 a frame
DAT_ATTN = (((0, 0), 9), ((4, 16), 9))
DAT_CHAN = 18
# the training step: the flagship in float32 at the reference's crop (LR 64,
# x4) and the command line's batch 2; launches of each kernel per step (the
# forward runs 36 blocks of scc_block + htb_tail, no stats tail; the tails'
# backward runs dwconv5x5 twice each: its recomputed forward and dx)
TRAIN_BATCH, TRAIN_LR = 2, 64
TRAIN_WARM, TRAIN_STEPS = 2, 5
PER_STEP = {"conv3x3": 9, "conv3x3_shuffled": 1, "conv3x3_shuffled_tail": 1,
            "conv3x3_shuffled_tail_packed": 0, "fusion_pools": 1, "fused_fusion": 1,
            "scc_block": 36, "htb_tail": 36, "htb_tail_stats": 0, "htb_fused": 0,
            "dwconv5x5": 72}
# declared and checkpointed by the reference but never read (reference
# models/hit_sir_pro.py:62): their gradient stays None on both paths
UNUSED_PARAMS = ("conv_first.norm.weight", "conv_first.norm.bias")


def log(msg: str) -> None:
    print(msg, flush=True)


def on_plain(fn, plain: bool = True):
    """``fn``, run inside ``plain_versions()`` where ``plain``: every kernel
    function then runs its plain version (the yardstick on the card)."""
    from sisr_tpu_torch.ops.kernels.autograd import plain_versions

    def call(*args, **kwargs):
        with plain_versions():
            return fn(*args, **kwargs)

    return call if plain else fn


def time_ms(fn, target_s: float = 0.25, max_iters: int = 50, min_iters: int = 3) -> float:
    """Mean device ms of ``fn`` over a warmed run of launches (CUDA events).
    The device first spins for as long as one call took on the host clock
    times the calls (at most 0.1 s), so that the host queues the calls
    ahead of the device and a call shorter than its launch overhead is
    timed on the device, not at the host's launch rate."""
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
    torch.cuda._sleep(int(min(n * est, 0.1) * SPIN_CYCLES_PER_S))
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
    (``flops32``: float32 work the function keeps in float32).  ``library``
    is one PyTorch call (or, labelled so, a few) for the same work, timed on
    ``library_prep(inputs)``, made before the timing.  ``scope``
    is "tile" (a 192x192 tile's shapes) or "frame" (the 1080p frame's);
    ``count`` is the calls a tile or a frame makes at this shape."""

    def __init__(self, kernel, label, count, make, call, nbytes, flops,
                 library=None, flops32=0.0, scope="tile", library_prep=None):
        self.kernel, self.label, self.count = kernel, label, count
        self.make, self.call, self.nbytes, self.flops = make, call, nbytes, flops
        self.library, self.flops32, self.scope = library, flops32, scope
        # what the library call takes, made from the inputs before it is timed
        self.library_prep = library_prep or (lambda ins: ins)

    def plain(self, ins):
        """The call on the plain versions."""
        return on_plain(self.call)(ins)

    def t_ops(self) -> float:
        """Least ms for the bfloat16 run's operations: each type at its
        peak, the two pipes side by side."""
        return max(self.flops / PEAK_BF16_FLOPS, self.flops32 / PEAK_F32_FLOPS) * 1e3

    def t_ops32(self) -> float:
        """Least ms for the float32 run's operations, all on the FP32 pipes
        (the float32 kernels do not use TF32)."""
        return (self.flops + self.flops32) / PEAK_F32_FLOPS * 1e3


def _gen(seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *s: torch.randn(*s, generator=g, device="cuda")


def _bx(b):
    """A label's batch prefix: "" for one image, "2x" for two."""
    return f"{b}x" if b > 1 else ""


def conv_cases(shapes, scope="tile", b=1):
    """shapes: (h, w, cin, cout, act, res, calls); ``b`` images."""
    import torch.nn.functional as F
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3

    cases = []
    for h, w, cin, cout, act, res, n in shapes:
        def make(dt, h=h, w=w, cin=cin, cout=cout, res=res):
            rn = _gen(h * 7 + cin + cout)
            ins = [rn(b, h, w, cin), rn(b, h, w, cout) if res else None,
                   rn(3, 3, cin, cout) / math.sqrt(9 * cin), rn(cout) * 0.1]
            return [None if t is None else t.to(dt) for t in ins]

        def call(ins, act=act):
            y, r, k, b = ins
            return conv3x3(y, r, k, b, act)

        def library(ins):
            y, r, k, b = ins
            return F.conv2d(y.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b, padding=1)

        def nbytes(es, h=h, w=w, cin=cin, cout=cout, res=res):
            return es * (b * h * w * cin + 9 * cin * cout + cout
                         + b * h * w * cout * (2 if res else 1))

        cases.append(Case("conv3x3",
                          f"{_bx(b)}{h}x{w} {cin}->{cout} {act}{' +res' if res else ''}",
                          n, make, call, nbytes, 2.0 * b * h * w * 9 * cin * cout, library,
                          scope=scope))
    return cases


def _shuffled(yp):
    """The phase-major x2 shuffle of yp, materialized (NHWC)."""
    from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle_phase_major

    return pixel_shuffle_phase_major(yp, 2).contiguous()


def _nchw_conv(x, k, b):
    """One cuDNN convolution on NHWC tensors (channels-last views)."""
    import torch.nn.functional as F

    return F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b, padding=1)


def shuffled_case(h2, w2, count, scope="tile", b=1):
    """conv_up2 of the packed x4 head: yp (b, h2, w2, 256) -> (b, 2h2, 2w2,
    256).  Library: one ``F.conv2d`` (cuDNN) over the shuffle materialized
    before the timing, without the leaky ReLU."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import conv3x3_shuffled

    f = 64

    def make(dt):
        rn = _gen(11)
        ins = [rn(b, h2, w2, 4 * f), rn(3, 3, f, 4 * f) / math.sqrt(9 * f), rn(4 * f) * 0.1]
        return [t.to(dt) for t in ins]

    return Case("conv3x3_shuffled",
                f"yp {_bx(b)}{h2}x{w2}x256 -> {2 * h2}x{2 * w2} 64->256 leaky2", count, make,
                lambda ins: conv3x3_shuffled(*ins, "leaky2"),
                lambda es: es * (5 * b * h2 * w2 * 4 * f + 9 * f * 4 * f + 4 * f),
                2.0 * 4 * b * h2 * w2 * 9 * f * 4 * f,
                library=lambda ins: _nchw_conv(*ins), scope=scope,
                library_prep=lambda ins: [_shuffled(ins[0])] + ins[1:])


def tail_case(h2, w2, count, packed=False, scope="tile", b=1):
    """conv_hr + conv_last of the packed x4 head over yp (b, h2, w2, 256),
    plain or with the output packed 16 pixels to a row.  Library: two
    ``F.conv2d`` calls (cuDNN, conv_hr then conv_last) over the shuffle
    materialized before the timing, without the leaky ReLU between them."""
    from sisr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_shuffled_tail,
                                                    conv3x3_shuffled_tail_packed)

    f = 64
    fn = conv3x3_shuffled_tail_packed if packed else conv3x3_shuffled_tail
    hout, wout = 2 * h2, 2 * w2

    def make(dt):
        rn = _gen(12)
        ins = [rn(b, h2, w2, 4 * f), rn(3, 3, f, f) / math.sqrt(9 * f), rn(f) * 0.1,
               rn(3, 3, f, 3) / math.sqrt(9 * f), rn(3) * 0.1]
        return [t.to(dt) for t in ins]

    def library(ins):
        x, k1, b1, k2, b2 = ins
        hr = _nchw_conv(x, k1, b1)
        return _nchw_conv(hr.permute(0, 2, 3, 1), k2, b2)

    out = f"{hout}x{wout // 16}x48" if packed else f"{hout}x{wout}x3"
    return Case("conv3x3_shuffled_tail_packed" if packed else "conv3x3_shuffled_tail",
                f"yp {_bx(b)}{h2}x{w2}x256 -> {out} 64->64->3", count, make,
                lambda ins: fn(ins[0], ins[1], ins[2], "leaky2", ins[3], ins[4]),
                lambda es: es * (b * h2 * w2 * 4 * f + 9 * f * f + f + 9 * f * 3 + 3
                                 + b * hout * wout * 3),
                2.0 * b * hout * wout * 9 * f * (f + 3), library=library, scope=scope,
                library_prep=lambda ins: [_shuffled(ins[0])] + ins[1:])


def fusion_cases(h, w, scope="tile", nb=1, c=180, count=1):
    """The Fusion gate (a, b nb x h x w x c: the flagship's 180, DenseSR's
    64): the pools alone, and the whole gate (pools, maps, gate) with its
    packed weights made once, as the model keeps them; ``count`` calls a
    scope.  Operations, per UA k of three:

    - pools (float32): 19 per input element (a + b; sum and max over C, H
      and W of a, a + b, b);
    - maps: per row of h_att (W rows) and w_att (H rows), three outputs
      (the folded map and two border corrections) of three taps of a C x C
      product: 2 * 3 * 3 * C^2 each, 2 * 27 * (H + W) * C^2 in all, one
      (N, 3C) x (3C, 3C) product per UA and side, on the tensor cores in
      the bfloat16 run (``flops``) and on the FP32 pipes in the float32
      run; the 18-tap convs of the pools (float32),
      2 * 18 * 3 * (H*W + (H + W) * C);
    - gate: base = p27 @ k1blk, nine nonzero taps per UA and output element,
      bfloat16 by bfloat16 in the bfloat16 run: 2 * 9 * 3 per output
      element; then 20 float32 operations per output element (six adds of
      the maps, three sigmoids at three, five for the gate)."""
    from sisr_tpu_torch.ops.kernels.fusion_ops import fused_fusion, fusion_pools, pack_params

    def make_ab(dt):
        rn = _gen(21)
        return [rn(nb, h, w, c).to(dt) for _ in range(2)]

    def make_fused(dt):
        rn = _gen(22)
        raws = tuple(((rn(3, 3, 2, 1) / 4.0, 0.01 * rn(1)), (rn(3, 3, 2, 1) / 4.0, 0.01 * rn(1)),
                      (rn(3, 3, 2, 1) / 4.0, 0.01 * rn(1)),
                      (rn(3, 3, c, c) / math.sqrt(9 * c), 0.01 * rn(c))) for _ in range(3))
        a, b = make_ab(dt)
        return [a, b, raws, pack_params(raws, c, dt)]

    pool_bytes = lambda es: nb * (es * (2 * h * w * c + 6 * h * w + 6 * h * c) + 4 * 6 * w * c)
    pool_ops = 19.0 * nb * h * w * c
    fold_ops = nb * 2.0 * 27 * (h + w) * c * c
    conv_ops = nb * 2.0 * 18 * 3 * (h * w + (h + w) * c)
    fused = Case("fused_fusion", f"a, b {_bx(nb)}{h}x{w}x{c}, pools + maps + gate", count,
                 make_fused,
                 lambda ins: fused_fusion(*ins),
                 lambda es: (es * (3 * nb * h * w * c + 3 * 18 * c * c + 27 * 3 * c)
                             + 4 * (3 * 3 * 18 + 9 + 3 * c)),
                 2.0 * 9 * 3 * nb * h * w * c + fold_ops,
                 flops32=pool_ops + conv_ops + 20.0 * nb * h * w * c, scope=scope)
    return [Case("fusion_pools", f"a, b {_bx(nb)}{h}x{w}x{c}", count, make_ab,
                 lambda ins: fusion_pools(*ins), pool_bytes,
                 0.0, flops32=pool_ops, scope=scope), fused]


def _tail_inputs(rn, c, ch):
    """The HTB tail's weights: LN1, fc1, dwconv, fc2, LN2."""
    return [1 + 0.05 * rn(c), 0.01 * rn(c), rn(c, ch) / math.sqrt(c), 0.01 * rn(ch),
            rn(5, 5, ch) / 5.0, 0.01 * rn(ch), rn(ch, c) / math.sqrt(ch), 0.01 * rn(c),
            1 + 0.05 * rn(c), 0.01 * rn(c)]


def htb_cases(h, w, variants, pad=(0, 0), scope="tile", b=1):
    """variants: (stats, calls); attn is ``pad`` (rows, columns) larger
    than the shortcut (a window-padded SCC output); ``b`` images."""
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail, htb_tail_stats

    c, ch = 180, 360
    cases = []
    for stats, n in variants:
        def make(dt):
            rn = _gen(5)
            ins = [rn(b, h + pad[0], w + pad[1], c), rn(b, h, w, c)] + _tail_inputs(rn, c, ch)
            return [t.to(dt) for t in ins]

        fn = htb_tail_stats if stats else htb_tail

        def call(ins, fn=fn):
            return fn(*ins)

        def nbytes(es, stats=stats):
            weights = 2 * c * ch + 25 * ch + 2 * ch + 6 * c
            stat = 4 * b * (2 * h * w + 2 * c) if stats else 0
            return es * (3 * b * h * w * c + weights) + stat

        flops = 2.0 * b * h * w * (2 * c * ch + 25 * ch)
        label = f"{_bx(b)}{h}x{w} C={c} Ch={ch}{' +stats' if stats else ''}"
        cases.append(Case("htb_tail", label + (f", attn {h + pad[0]}x{w + pad[1]}"
                                               if any(pad) else ""),
                          n, make, call, nbytes, flops, scope=scope))
    return cases


def _scc_inputs(rn, dt, h, w, win, base=8, c=180, heads=6, b=1):
    """x and the SCC arguments of one block (as the model derives them)."""
    import torch
    from sisr_tpu_torch.ops.kernels.scc_attention import (blockdiag_kgen, head_mask,
                                                          pooling_matrix)

    half, d = c // 2, c // (2 * heads)
    bh = min(win, base)
    lb, big_l, rh = bh * bh, win * win, win // bh
    x = rn(b, h, w, c)
    sca = (rn(9, c) / 3.0, 0.01 * rn(c), rn(9, c) / 3.0, 0.01 * rn(c),
           0.3 * rn(b, 1, 1, c), 0.3 * rn(b, 1, 1, c))
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


def scc_cases(shapes, scope="tile", b=1):
    """shapes: (h, w, window, calls); ``b`` images."""
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    heads = 6
    cases = []
    for h, w, win, n in shapes:
        lb, big_l = min(win, 8) ** 2, win * win

        def make(dt, h=h, w=w, win=win):
            return _scc_inputs(_gen(win), dt, h, w, win, b=b)

        def call(ins, win=win):
            return scc_block(*ins, heads, (win, win))

        nb, flops = _scc_work(b * h, w, win)
        cases.append(Case("scc_block", f"{_bx(b)}{h}x{w} window {win} "
                          f"(L={big_l}, l_base={lb})",
                          n, make, call, lambda es, nb=nb: es * nb, flops, scope=scope))
    return cases


def dwconv_cases(shapes, scope):
    """The 5x5 depthwise conv, shapes (b, h, w, c, calls per step of each):
    the forward, and dx as the backward computes it (``dwconv_vjp``: the
    kernel on dy with the filter flipped in both spatial axes and a zero
    bias), held against plain autograd's dx of the plain version.  Work:
    one element in and one out, 25 FMAs on the FP32 pipes per output
    element.  The library calls: the grouped ``F.conv2d`` on the permuted
    tensor (what the plain version calls), and for dx
    ``F.conv_transpose2d`` of dy with the same filter."""
    import torch
    import torch.nn.functional as F
    from sisr_tpu_torch.ops.kernels.autograd import in_plain_versions
    from sisr_tpu_torch.ops.kernels.dwconv import (_kernel, depthwise_conv_reference,
                                                   dwconv5x5, dwconv_vjp)

    def plain_dx(x, w, b, dy):
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            return torch.autograd.grad(depthwise_conv_reference(xg, w, b), xg, dy)[0]

    def call_dx(ins):
        if in_plain_versions():
            return plain_dx(*ins)
        return dwconv_vjp(_kernel, ins[:3], (True, False, False), (ins[3],))[0]

    cases = []
    for b, h, w, c, n in shapes:
        def make(dt, b=b, h=h, w=w, c=c, dx=False):
            rn = _gen(40 + h)
            ins = [rn(b, h, w, c), rn(5, 5, c) / 5.0, 0.01 * rn(c)]
            if dx:
                ins.append(rn(b, h, w, c))
            return [t.to(dt) for t in ins]

        def library(ins, c=c):
            x, wt, bias = ins[:3]
            wt = wt.permute(2, 0, 1).unsqueeze(1)
            if len(ins) == 4:
                return F.conv_transpose2d(ins[3].permute(0, 3, 1, 2), wt, padding=2, groups=c)
            return F.conv2d(x.permute(0, 3, 1, 2), wt, bias, padding=2, groups=c)

        nbytes = lambda es, b=b, h=h, w=w, c=c: es * (2 * b * h * w * c + 26 * c)
        ops = 2.0 * 25 * b * h * w * c
        cases.append(Case("dwconv5x5", f"{b}x{h}x{w}x{c} forward", n, make,
                          lambda ins: dwconv5x5(*ins),
                          nbytes, 0.0, library, flops32=ops, scope=scope))
        cases.append(Case("dwconv5x5", f"{b}x{h}x{w}x{c} dx (dwconv_vjp)", n,
                          lambda dt, make=make: make(dt, dx=True), call_dx,
                          nbytes, 0.0, library, flops32=ops, scope=scope))
    return cases


def htb_fused_cases(h, w, shapes, scope="frame", pair=False):
    """The whole degenerate-window HTB: shapes (window, threaded stats,
    calls); both emit the next block's stats, as the flagship's do.  Work:
    the SCC block's, with its channel branch in the reassociated form
    (2 * 2 * L * C/2 a token) and its spatial branch kept in float32 in
    the cheaper of its two forms (scores and their product, 2 * 2 * L *
    C/2 a token, or the linear one, q M + bias VP with M = KP^T VP / d a
    window, 2 * (2 * C/2 * d + L * C/2)), plus the tail's; bytes: x, the
    SCC and tail weights, out and the stats (x2 and h are
    intermediates).  With ``pair``, each shape also gives the unfused pair
    on the same inputs (scc_block, then htb_tail_stats; calls 0, the same
    work), the chain the fused blocks replace."""
    import torch
    from sisr_tpu_torch.ops.kernels.ffn import htb_tail_stats
    from sisr_tpu_torch.ops.kernels.htb_block import htb_fused
    from sisr_tpu_torch.ops.kernels.scc_block import scc_block

    c, ch, heads, half = 180, 360, 6, 90
    d = half // heads
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

        def call(ins, win=win):
            return htb_fused(*ins[:11], heads, (win, win), *ins[11:], emit_stats=True)

        def chain(ins, win=win):
            attn = scc_block(*ins[:11], heads, (win, win))
            return htb_tail_stats(attn, ins[0], *ins[11:])

        nb, _ = _scc_work(h, w, win)
        weights = 2 * c * ch + 25 * ch + 2 * ch + 6 * c
        tc = 2.0 * h * w * (18 * c + c * half + 2 * big_l * half + c * c + 2 * c * ch + 25 * ch)
        f32 = 2.0 * h * w * min(2 * big_l * half, 2 * half * d + big_l * half)
        label = (f"{h}x{w} window {win} (L={big_l}) +stats"
                 + (", threaded stats" if threaded else ""))
        nbytes = (lambda es, nb=nb, threaded=threaded: es * (nb + weights)
                  + 4 * (2 * h * w + 2 * c) + (4 * 2 * h * w if threaded else 0))
        cases.append(Case("htb_fused", label, n, make, call, nbytes, tc, flops32=f32,
                          scope=scope))
        if pair:
            cases.append(Case("htb_fused", label + ", unfused pair (scc_block, htb_tail_stats)",
                              0, make, chain, nbytes, tc, flops32=f32, scope=scope))
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
    never gives it (calls 0: checked and timed, outside the tile sums),
    among them the unfused pair that each htb_fused call replaces, on its
    inputs."""
    h, w = FRAME_ALIGNED
    rows = BAND_ROWS_1080 + 4
    up48 = lambda n: -(-n // 48) * 48     # the 48-window blocks pad 1088 to 1104
    return ([tail_case(2 * rows, 2 * w, 8, packed=True, scope="frame")]
            + htb_fused_cases(h, w, ((4, False, 6), (8, True, 6)), pair=True)
            + scc_cases([(h, w, 4, 0), (up48(h), up48(w), 48, 0)], scope="frame")
            + htb_cases(h, w, ((True, 0),), pad=(up48(h) - h, 0), scope="frame")
            + conv_cases([(h, w, 180, 180, "none", True, 0)], scope="frame")
            + fusion_cases(h, w, scope="frame")
            + [shuffled_case(rows, w, 0, scope="frame")])


STEP_WINDOWS = (4, 8, 16, 32, 48, 64)   # each RHTB's six blocks


def step_cases():
    """Every kernel shape a training step (batch 2, LR 64x64, float32)
    launches, with its calls a step (they sum to ``PER_STEP``): the body's
    convs and the x4 head at batch 2, the Fusion gate, scc_block at each
    window (the window-48 block reflect-pads 64x64 to 96x96, the others
    pad none), htb_tail (the window-48 blocks' attn 96x96), dwconv5x5's
    forward and dx; and dwconv5x5 at a tile's (1, 192, 192, 360) (calls
    0)."""
    n, b = TRAIN_LR, TRAIN_BATCH
    pad = lambda win: -(-n // win) * win
    return (conv_cases([(n, n) + c for c in TILE_CONVS], scope="step", b=b)
            + [shuffled_case(n, n, 1, scope="step", b=b),
               tail_case(2 * n, 2 * n, 1, scope="step", b=b)]
            + fusion_cases(n, n, scope="step", nb=b)
            + scc_cases([(pad(win), pad(win), win, 6) for win in STEP_WINDOWS],
                        scope="step", b=b)
            + htb_cases(n, n, ((False, 30),), scope="step", b=b)
            + htb_cases(n, n, ((False, 6),), pad=(pad(48) - n, pad(48) - n), scope="step",
                        b=b)
            + dwconv_cases([(b, n, n, 360, 36), (1, TILE, TILE, 360, 0)], scope="step"))


def win_attn_cases():
    """HAT's window attention (C = 180, 6 heads of 30, window 16) at a
    1080p frame's map (1088 x 1920) with its calls a frame (``HAT_ATTN``),
    and at a 192 x 192 tile (calls 0).  Work: q, k and v read once and the
    output written once; QK^T and the product with v on the tensor cores
    (2 x 2 x keys x C a pixel)."""
    from sisr_tpu_torch.ops.kernels.win_attn import win_attn

    c, heads = 180, 6
    cases = []
    for (h, w), scope, counted in ((FRAME_ALIGNED, "hat_frame", True), ((TILE, TILE), "tile",
                                                                        False)):
        for shift, wk, n in HAT_ATTN:
            def make(dt, h=h, w=w, wk=wk):
                rn = _gen(60 + wk)
                return [rn(1, h, w, 3 * c).to(dt), 0.5 * rn(heads, 256, wk * wk)]

            def call(ins, shift=shift, wk=wk):
                return win_attn(*ins, heads, 16, shift, wk)

            kind = "overlapping" if wk > 16 else ("shifted" if shift else "unshifted")
            cases.append(Case("win_attn", f"{h}x{w} {kind} (256 queries, {wk * wk} keys)",
                              n if counted else 0, make, call,
                              lambda es, h=h, w=w: es * 4 * h * w * c,
                              4.0 * h * w * wk * wk * c, scope=scope))
    return cases + dat_attn_cases()


def dat_attn_cases():
    """DAT's spatial attention (C = 180, two branches of 3 heads of 30 in
    8 x 32 and 32 x 8 windows, the map zero-padded to 1088 x 1920 in the
    kernel) and its channel attention's whole-image sums, on a 1080p
    frame's map (1080 x 1920) with their calls a frame.  Work: the window
    attention's as HAT's (256 keys); the sums' q and k read once, the Gram
    and the norms (2 (C d + 2C) a pixel)."""
    from sisr_tpu_torch.ops.kernels.chan_attn import chan_attn
    from sisr_tpu_torch.ops.kernels.win_attn import win_attn

    c, heads, (h, w) = 180, 6, FRAME
    cases = []
    for shift, n in DAT_ATTN:
        def make(dt, shift=shift):
            rn = _gen(70 + shift[0])
            return [rn(1, h, w, 3 * c).to(dt), 0.5 * rn(heads, 256, 256)]

        def call(ins, shift=shift):
            return win_attn(*ins, heads // 2, (8, 32), shift, 0, 2, 32)

        kind = "shifted" if shift[0] else "unshifted"
        cases.append(Case("win_attn", f"{h}x{w} DAT {kind} (8x32 + 32x8, 256 keys)", n, make,
                          call, lambda es: es * 4 * h * w * c, 4.0 * h * w * 256 * c,
                          scope="dat_frame"))
    cases.append(Case("chan_attn", f"{h}x{w} DAT sums (6 heads of 30)", DAT_CHAN,
                      lambda dt: [_gen(75)(1, h, w, 3 * c).to(dt)],
                      lambda ins: chan_attn(*ins, heads), lambda es: es * 2 * h * w * c,
                      2.0 * h * w * (c * 30 + 2 * c), scope="dat_frame"))
    return cases


# DenseSR at its experiment's defaults (dense_experiment.py: C = 64, the
# multi-size extraction, SCA and the Fusion gate, num_blocks (4, 4)): the
# gate once a forward, at the training step's batch and at the eval images
DENSE_C = 64
DENSE_EVAL_LR = (96, 120)


def dense_cases():
    """The Fusion gate at DenseSR's width: the training step's (2, 64, 64,
    64) (one call a step), and an eval image's (1, 96, 120, 64) and a
    bfloat16-served 192x192 tile's (1, 192, 192, 64) (calls 0: checked and
    timed, outside the step's sums)."""
    n, b = TRAIN_LR, TRAIN_BATCH
    return (fusion_cases(n, n, scope="dense", nb=b, c=DENSE_C)
            + fusion_cases(*DENSE_EVAL_LR, scope="dense", c=DENSE_C, count=0)
            + fusion_cases(TILE, TILE, scope="dense", c=DENSE_C, count=0))


def check_fusion_backward(failures: list) -> dict:
    """The Fusion gate's gradients at DenseSR's training step (2, 64, 64,
    64), float32 (TF32 off, cuDNN's deterministic algorithms): through
    ``KernelFunction`` (the kernels forward, the plain version's vjp
    backward) against the plain path's, for a, b and every raw parameter,
    within 1e-6 relative norm (the backward recomputes the plain forward
    from the same saved inputs)."""
    import torch
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.utils.precision import exact_mode

    n, b = TRAIN_LR, TRAIN_BATCH
    (case,) = [c for c in fusion_cases(n, n, scope="dense", nb=b, c=DENSE_C)
               if c.kernel == "fused_fusion"]
    a, bb, raws, packed = case.make(torch.float32)
    dy = _gen(23)(b, n, n, DENSE_C)
    leaves = [a, bb] + [t for ua in raws for kb in ua for t in kb]
    for t in leaves:
        t.requires_grad_(True)
    grads, launched = [], []
    with exact_mode(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                  deterministic=True, allow_tf32=False):
        for call in (case.call, case.plain):
            before = build.launches["fused_fusion"]
            out = call([a, bb, raws, packed])
            grads.append(torch.autograd.grad(out, leaves, dy))
            launched.append(build.launches["fused_fusion"] - before)
    rel = [float((g - r).norm() / r.norm().clamp_min(1e-30)) for g, r in zip(*grads)]
    ok = max(rel) <= 1e-6 and launched == [1, 0] and all(
        bool(torch.isfinite(g).all()) for g in grads[0])
    log(f"  fused_fusion backward through KernelFunction, a, b {b}x{n}x{n}x{DENSE_C} float32: "
        f"{len(rel)} gradients, worst relative norm error {max(rel):.2e} (bar 1e-6), launches "
        f"{launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("fused_fusion's backward at DenseSR's step against the plain path")
    return dict(worst_rel=max(rel), gradients=len(rel))


def run_kernels(failures: list) -> tuple:
    """Hold every kernel against its plain version; time both.  Returns
    (rows, extra): rows[(kernel, scope)] sums a kernel's cases over a tile,
    a frame or a training step, weighted by their calls; extra[kernel]
    lists its cases of no calls (shapes its path's unit never gives it)."""
    import torch
    from sisr_tpu_torch.utils.precision import exact_mode

    f32, b16 = torch.float32, torch.bfloat16
    rows, extra = {}, {}
    steps = step_cases()
    per_step = {k: sum(c.count for c in steps if c.kernel == k) for k in PER_STEP}
    if per_step != PER_STEP:
        failures.append(f"the step's cases make {per_step} calls, a step launches {PER_STEP}")
    for case in tile_cases() + frame_cases() + steps + dense_cases() + win_attn_cases():
        # a frame case runs for seconds: time it over one call after the warm-up
        few = dict(min_iters=1) if case.scope in ("frame", "hat_frame", "dat_frame") else {}
        try:
            with exact_mode():
                ins32 = case.make(f32)
                got = case.call(ins32)
                ref = case.plain(ins32)
                torch.cuda.synchronize()
                e32 = _errs(got, ref)
                finite = all(bool(torch.isfinite(t).all()) for t in _flat(got))
                del got, ref
                ins16 = case.make(b16)
                got16 = case.call(ins16)
                ref16 = case.plain(ins16)
                truth = case.plain(_upcast(ins16))
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
            ms = time_ms(lambda: case.call(ins16), **few)
            plain_ms = time_ms(lambda: case.plain(ins16), max_iters=10, **few)
            lib_ms = lib32 = None
            if case.library:
                lib16 = case.library_prep(ins16)
                lib_ms = time_ms(lambda: case.library(lib16), **few)
                del lib16
            del ins16
            with exact_mode():
                ms32 = time_ms(lambda: case.call(ins32), **few)
                plain32 = time_ms(lambda: case.plain(ins32), max_iters=10, **few)
                if case.library:
                    lib32_ins = case.library_prep(ins32)
                    lib32 = time_ms(lambda: case.library(lib32_ins), **few)
                    del lib32_ins
            del ins32
            torch.cuda.empty_cache()
            t_bytes = case.nbytes(2) / HBM_BYTES_PER_S * 1e3
            t_ops = case.t_ops()
            t_bytes32, t_ops32 = case.nbytes(4) / HBM_BYTES_PER_S * 1e3, case.t_ops32()
            ops = case.flops + case.flops32
            rate = (f"| bf16 {ops / ms / 1e9:.1f} TFLOP/s {max(t_bytes, t_ops) / ms:.1%} of "
                    f"bound, f32 {ops / ms32 / 1e9:.1f} TFLOP/s "
                    f"{max(t_bytes32, t_ops32) / ms32:.1%} of bound ")
            log(f"  {case.kernel:21s} {case.label:44s} f32 err {err32:.3e} "
                f"{'ok' if ok32 else 'FAIL'} | bf16 err vs plain {err16:.3e}, vs f32 "
                f"{err16_k:.3e} (plain bf16 vs f32 {err16_p:.3e}) {'ok' if ok16 else 'FAIL'} "
                f"| bf16 ms {ms:.4f} plain {plain_ms:.4f} "
                f"lib {'-' if lib_ms is None else f'{lib_ms:.4f}'} | f32 ms {ms32:.4f} "
                f"plain {plain32:.4f} lib {'-' if lib32 is None else f'{lib32:.4f}'} "
                f"| bound bf16 {max(t_bytes, t_ops):.4f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}) f32 "
                f"{max(t_bytes32, t_ops32):.4f} {rate}x{case.count}/{case.scope} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"kernel {case.kernel} {case.label} disagrees with its plain version")
            if case.count == 0:
                extra.setdefault(case.kernel, []).append(dict(
                    shape=case.label, scope=case.scope, max_abs_err=err32, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, ms_f32=ms32, plain_ms_f32=plain32,
                    library_ms_f32=lib32, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bound_ms_f32=max(t_bytes32, t_ops32)))
                continue
            row = rows.setdefault((case.kernel, case.scope), dict(
                err=0.0, ms=0.0, plain=0.0, lib=0.0, ms32=0.0, plain32=0.0, lib32=0.0,
                has_lib=case.library is not None, t_bytes=0.0, t_ops=0.0, t_bytes32=0.0,
                t_ops32=0.0))
            row["err"] = max(row["err"], err32)
            for key, value in (("ms", ms), ("plain", plain_ms), ("lib", lib_ms or 0.0),
                               ("ms32", ms32), ("plain32", plain32), ("lib32", lib32 or 0.0),
                               ("t_bytes", t_bytes), ("t_ops", t_ops),
                               ("t_bytes32", t_bytes32), ("t_ops32", t_ops32)):
                row[key] += case.count * value
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
            "htb_fused": "::htb_fused_", "dwconv5x5": "::dwconv_"}


def _profiled(fn, warm: bool = True) -> tuple:
    """(wall ms, [(device ms, count, kernel name), ...] largest first) of
    one ``fn()`` under torch.profiler, after one unprofiled call unless
    ``warm`` is False."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's own row repeats its kernels' time,
    # and so does a user annotation's (the optimizer's step) on the device
    return wall, sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                         and not getattr(e, "is_user_annotation", False)),
                        reverse=True)


def profile_call(fn, warm: bool = True) -> dict:
    """Where the time of one ``fn()`` goes: device time by kernel name
    (torch.profiler), device busy time against the call's wall time;
    after one unprofiled call unless ``warm`` is False."""
    wall, rows = _profiled(fn, warm)
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
            ref = on_plain(m32)(tile).clamp(0, 1)
            err = max(err, float((m32(tile).clamp(0, 1) - ref).abs().max()))
            outs = {
                "k16": m16(tile).float(),
                "p16": on_plain(m16)(tile).float(),
                # how far these weights let any bfloat16 forward come: the
                # float32 plain model fed the bf16-rounded input, and with
                # bf16-rounded weights
                "in": on_plain(m32)(tile.to(torch.bfloat16).float()),
                "w": on_plain(rounded)(tile),
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
    so not bit-equal); bfloat16 fused_htb banded vs the float32 plain
    model at the same PSNR bar."""
    import torch
    from sisr_tpu_torch.parallel.tiling import BandedHeadSR
    from sisr_tpu_torch.utils.precision import exact_mode

    m16, m32 = served["models"]["bfloat16"], served["models"]["float32"]
    m32f, m16f = flagship("float32", m32, True), flagship("bfloat16", m16, True)
    g = torch.Generator(device="cuda").manual_seed(2)
    reqs = SMALL[1:]
    imgs = [torch.rand((h, w, 3), generator=g, device="cuda") for h, w in reqs]
    err = dict(whole=0.0, plain=0.0, fused=0.0)
    sq = dict(k16=0.0, p16=0.0, f16=0.0)
    with torch.inference_mode(), exact_mode():
        for img in imgs:
            banded = BandedHeadSR(m32, BAND_ROWS)(img)
            whole = m32(img[None])[0]
            plain = on_plain(m32)(img[None])[0].clamp(0, 1)
            err["whole"] = max(err["whole"], float((banded - whole).abs().max()))
            err["plain"] = max(err["plain"], float((banded.clamp(0, 1) - plain).abs().max()))
            fused = BandedHeadSR(m32f, BAND_ROWS)(img)
            err["fused"] = max(err["fused"], float((fused - banded).abs().max()))
            outs = {"k16": BandedHeadSR(m16, BAND_ROWS, out_dtype=torch.float32)(img),
                    "f16": BandedHeadSR(m16f, BAND_ROWS, out_dtype=torch.float32)(img),
                    "p16": on_plain(m16)(img[None])[0].float()}
            for k, y in outs.items():
                sq[k] += float(((y.clamp(0, 1) - plain) ** 2).mean()) / len(imgs)
    db = {k: 10 * math.log10(1.0 / max(v, 1e-20)) for k, v in sq.items()}
    bar16 = min(44.0, db["p16"] - 3.0)
    oks = dict(whole=err["whole"] <= 1e-5, plain=err["plain"] <= 1e-3,
               fused=err["fused"] <= 1e-4, bf16=db["k16"] >= bar16,
               fused16=db["f16"] >= bar16)
    mark = lambda k: "ok" if oks[k] else "FAIL"
    log(f"  over {', '.join(f'{h}x{w}' for h, w in reqs)}, f32: banded vs whole forward "
        f"max abs {err['whole']:.3e} (bar 1e-5) {mark('whole')}; vs the plain whole model "
        f"{err['plain']:.3e} (bar 1e-3) {mark('plain')}; fused_htb vs unfused "
        f"{err['fused']:.3e} (bar 1e-4) {mark('fused')}")
    log(f"  bf16 banded vs f32 plain: {db['k16']:.2f} dB PSNR (bar {bar16:.2f}: "
        f"{'44 dB' if bar16 == 44.0 else 'plain bf16 - 3 dB'}) {mark('bf16')}; "
        f"bf16 fused_htb banded vs f32 plain: {db['f16']:.2f} dB {mark('fused16')}; "
        f"bf16 plain vs f32 plain: {db['p16']:.2f} dB")
    if not all(oks.values()):
        failures.append("whole-image check against the whole forward and the plain model")


def train_model(dtype: str = "float32"):
    """The flagship computing in ``dtype`` on the card (parameters float32),
    weights from ``utils/param_synth.py`` with seed 0."""
    from sisr_tpu_torch import infer

    model = infer.create_model(dtype, "cuda")
    infer.synth_weights(model, seed=0)
    return model


def train_batches(n: int, seed: int) -> list:
    """n seeded (LR, HR) batches: (2, 64, 64, 3) and (2, 256, 256, 3) in
    [0, 1] (the reference's crop 64 x4 at the command line's batch 2; the
    repo has no dataset)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (TRAIN_BATCH, TRAIN_LR, TRAIN_LR, 3)
    hr = (TRAIN_BATCH, 4 * TRAIN_LR, 4 * TRAIN_LR, 3)
    return [(torch.rand(shape, generator=g, device="cuda"),
             torch.rand(hr, generator=g, device="cuda")) for _ in range(n)]


def adam(model):
    """``hitsir_pro_experiment``'s optimizer: Adam 2e-5, betas (0.9, 0.99)."""
    from sisr_tpu_torch.configs.model_config import get_optimizer

    return get_optimizer("Adam", model.parameters(), 2e-5,
                         {"weight_decay": 0, "betas": [0.9, 0.99]})


def run_train(failures: list) -> dict:
    """The bfloat16 step's check against the plain path (``bf16_step_check``,
    3 Adam steps), then training steps of the flagship through
    ``make_train_step`` in float32 and in bfloat16: 2 warm, 5 timed with
    every launch counter checked per step, on the kernel path then the
    plain path; one profiled kernel-path step of each type split by CUDA
    events into forward, backward and optimizer.  Returns the kernel
    paths' launches over their timed steps."""
    import statistics

    import torch
    from sisr_tpu_torch.ops.kernels import build, ffn, scc_block
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    routes = {f"scc_block window {w}": scc_block.wgmma_path(
        torch.bfloat16, 180, 6, w * w, min(w, 8) ** 2) for w in STEP_WINDOWS}
    routes["htb_tail"] = ffn.wgmma_path(torch.bfloat16, 180, 360)
    log(f"  bfloat16 step shapes on wgmma: {routes}")
    summary = {"bfloat16_check": bf16_step_check(failures, lambda: train_model("bfloat16"),
                                                 "flagship"),
               "bfloat16_wgmma_routes": routes}
    counts = dict.fromkeys(build.launches, 0)
    mp = TRAIN_BATCH * TRAIN_LR * TRAIN_LR / 1e6
    for dt in ("float32", "bfloat16"):
        for label, plain in (("kernels", False), ("plain", True)):
            model = train_model(dt)
            opt = adam(model)
            step = on_plain(make_train_step(model, l1_loss, opt), plain)
            batches = train_batches(TRAIN_WARM + TRAIN_STEPS, seed=0)
            for lr_img, hr_img in batches[:TRAIN_WARM]:
                step(lr_img, hr_img)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            ms, losses = [], []
            want = {k: 0 if plain else PER_STEP.get(k, 0) for k in build.launches}
            for lr_img, hr_img in batches[TRAIN_WARM:]:
                before = dict(build.launches)
                t0 = time.perf_counter()
                loss = step(lr_img, hr_img)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
                got = {k: build.launches[k] - before[k] for k in build.launches}
                if got != want or not math.isfinite(losses[-1]):
                    failures.append(f"train {dt} {label}: loss {losses[-1]}, launches {got}, "
                                    f"want {want}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            med = statistics.median(ms)
            row = dict(median_ms=med, min_ms=min(ms), runs_ms=ms, lr_mp_per_s=mp / (med / 1e3),
                       peak_gib=peak, losses=losses)
            # the float32 rows keep their earlier place in the line
            (summary if dt == "float32" else summary.setdefault(dt, {}))[label] = row
            log(f"  {label:7s} {TRAIN_STEPS} steps (batch {TRAIN_BATCH}, LR {TRAIN_LR}x{TRAIN_LR} "
                f"-> HR {4 * TRAIN_LR}x{4 * TRAIN_LR}, {dt}): median {med:.1f} ms, min "
                f"{min(ms):.1f} ms, {row['lr_mp_per_s']:.4f} LR MP/s, peak {peak:.2f} "
                f"GiB, L1 losses {', '.join(f'{v:.5f}' for v in losses)}")
            if not plain:
                for k, v in build.launches.items():
                    counts[k] += v
                row["launches_per_step"] = {k: v // TRAIN_STEPS
                                            for k, v in build.launches.items()}
                log(f"  launches per step: {row['launches_per_step']} (want {PER_STEP})")
                split = row["split"] = profile_step(model, opt, *batches[-1])
                # the profiler slows the host: the busy time against the unprofiled median
                split["idle_share_of_median"] = 1 - split["busy_ms"] / med
                log(f"  device busy {split['busy_ms']:.1f} ms against the {med:.1f} ms median "
                    f"{dt} step: {100 * split['idle_share_of_median']:.1f}% idle")
            del model, opt, step
            torch.cuda.empty_cache()
    summary["plain_over_kernels"] = summary["plain"]["median_ms"] / summary["kernels"]["median_ms"]
    bf = summary["bfloat16"]
    bf["plain_over_kernels"] = bf["plain"]["median_ms"] / bf["kernels"]["median_ms"]
    bf["float32_over_bfloat16"] = summary["kernels"]["median_ms"] / bf["kernels"]["median_ms"]
    log(f"  plain path / kernel path step time: float32 {summary['plain_over_kernels']:.2f}x, "
        f"bfloat16 {bf['plain_over_kernels']:.2f}x; float32 / bfloat16 kernel path "
        f"{bf['float32_over_bfloat16']:.2f}x")
    log(json.dumps({"train": summary}))
    return counts


def profile_step(model, opt, lr_img, hr_img) -> dict:
    """Two more kernel-path steps: one with CUDA events between its forward
    (with the loss), backward and optimizer update, one under
    torch.profiler (which slows the host) for the device busy time."""
    import torch
    from sisr_tpu_torch.train.losses import l1_loss

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def one():
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = l1_loss(model(lr_img, deterministic=False), hr_img)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()

    one()
    torch.cuda.synchronize()
    split = dict(forward_ms=ev[0].elapsed_time(ev[1]), backward_ms=ev[1].elapsed_time(ev[2]),
                 optimizer_ms=ev[2].elapsed_time(ev[3]))
    log(f"  one more step: forward {split['forward_ms']:.1f} ms, backward "
        f"{split['backward_ms']:.1f} ms, optimizer {split['optimizer_ms']:.1f} ms (CUDA events)")
    log(f"[profile] one {str(model.dtype).split('.')[-1]} training step of "
        f"{type(model).__name__}")
    prof = profile_call(one, warm=False)
    split.update(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                 idle_share=1 - prof["busy_ms"] / prof["wall_ms"], kernels_ms=prof["kernels_ms"])
    return split


def step_grads(model, lr_img, hr_img, plain: bool):
    """The L1 loss of one training forward (on the plain versions where
    ``plain``), every parameter's gradient (None where the forward does not
    read it) and the forward's SR."""
    from sisr_tpu_torch.train.losses import l1_loss

    model.zero_grad(set_to_none=True)
    sr = on_plain(model, plain)(lr_img, deterministic=False)
    loss = l1_loss(sr, hr_img)
    loss.backward()
    return float(loss.detach()), {k: None if p.grad is None else p.grad.clone()
                                  for k, p in model.named_parameters()}, sr.detach()


def _ulp_move(t, seed: int):
    """``t`` with every element one float32 ulp up or down at random."""
    import torch

    g = torch.Generator(device=t.device).manual_seed(seed)
    up = torch.rand(t.shape, generator=g, device=t.device) < 0.5
    return torch.nextafter(t, torch.where(up, torch.inf, -torch.inf))


def probe_grads(plain_model, lr_img, hr_img, make=None) -> list:
    """The plain path's gradients after moves at float32's rounding level:
    the LR batch one ulp up or down at random (two seeds) and by 1e-6
    relative; every weight one ulp up or down at random (two seeds), a
    move at every layer as the kernels' own rounding is.  ``make`` builds
    a model of ``plain_model``'s kind (default: the flagship's
    ``train_model``)."""
    import torch

    grads = [step_grads(plain_model, x, hr_img, True)[1]
             for x in (_ulp_move(lr_img, 11), _ulp_move(lr_img, 12), lr_img * (1 + 1e-6))]
    moved = (make or train_model)()
    for seed in (13, 14):
        with torch.no_grad():
            for i, (p, q) in enumerate(zip(moved.parameters(), plain_model.parameters())):
                p.copy_(_ulp_move(q, seed * 1000 + i))
        grads.append(step_grads(moved, lr_img, hr_img, True)[1])
    return grads


# a gradient's bar is max(1e-3, NOISE_MULT x its noise): the largest
# error/noise of the sound kernel path over the checked batches was 1.85
# (NVIDIA H100 80GB HBM3, 700.00 W); 3 leaves a margin of 1.6x over it
NOISE_MULT = 3.0


@contextlib.contextmanager
def planted_fault(kind: str):
    """The check's control: the training step with a fault planted in
    dwconv5x5's backward (which no forward output shows), for as long as
    the context lasts.  "unflipped": dx from the filter unflipped;
    "half-ulp": dx 2^-8 relative too large (half a bfloat16 ulp).  The
    HTB tails' recompute runs it inside their CUDA graphs, which replay the
    code they captured: they are dropped on entry and on exit."""
    from sisr_tpu_torch.ops.kernels import dwconv
    from sisr_tpu_torch.ops.kernels.autograd import drop_graphs

    fn = dwconv.DWCONV5X5
    sound = fn.vjp
    drop_graphs()

    def unflipped(kernel, leaves, need, grads):
        x, w, b = leaves
        return sound(kernel, (x, w.flip((0, 1)), b), need, grads)

    def half_ulp(kernel, leaves, need, grads):
        dx, dw, db = sound(kernel, leaves, need, grads)
        return None if dx is None else dx * (1 + 2.0 ** -8), dw, db

    fn.vjp = {"unflipped": unflipped, "half-ulp": half_ulp}[kind]
    try:
        yield
    finally:
        fn.vjp = sound
        drop_graphs()


def _over_bars(grads: dict, ref: dict, bars: dict, floor: float = 0.0) -> tuple:
    """(rows, failures) of ``grads`` against the plain path's ``ref``: each
    error relative to max(|ref|, ``floor``)."""
    import torch

    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(max(floor, 1e-30)))
    rows, bad = [], []
    for k, g in grads.items():
        r = ref[k]
        if k in UNUSED_PARAMS:
            if g is not None or r is not None:
                bad.append(f"{k} has a gradient")
            continue
        if g is None or r is None or not bool(torch.isfinite(g).all()):
            bad.append(f"{k}: gradient None or not finite")
            continue
        noise, bar = bars[k]
        rows.append(dict(name=k, err=rel(g, r), noise=noise, bar=bar))
        if rows[-1]["err"] > bar:
            bad.append(f"{k}: relative norm error {rows[-1]['err']:.2e} > bar {bar:.2e}")
    return rows, bad


def gradient_agreement(kernel_model, plain_model, lr_img, hr_img,
                       faults=("unflipped", "half-ulp"), make=None) -> dict:
    """The kernel path's gradients against the plain path's, float32 with
    TF32 off, from the same weights and batch.  A parameter's bar is a
    relative norm error of max(1e-3, NOISE_MULT x its noise), where its
    noise is the largest relative move of the plain path's own gradient
    under ``probe_grads``' five moves: gradients that are large sums that
    cancel (pooling biases, k-generation, squeeze-excite and position-bias
    MLPs of some blocks) move by up to several 1e-2 when the input moves
    by one ulp, so no float32 implementation holds them to 1e-3; the
    kernels' rounding moves them by as much.  Then the same kernel-path
    step under each planted fault, which the bars must reject: a kind of
    ``planted_fault``, or in a dict of label to a context manager's
    factory.  ``make`` as ``probe_grads``'.  Returns the losses and SRs,
    per-parameter rows, the failures and, per fault, its rows, failures,
    loss error and SR."""
    from sisr_tpu_torch.utils.precision import exact_mode

    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    if not isinstance(faults, dict):
        faults = {kind: (lambda kind=kind: planted_fault(kind)) for kind in faults}
    with exact_mode():
        loss_k, got, sr_k = step_grads(kernel_model, lr_img, hr_img, False)
        loss_p, ref, sr_p = step_grads(plain_model, lr_img, hr_img, True)
        moved = probe_grads(plain_model, lr_img, hr_img, make)
        planted = {}
        for kind, fault in faults.items():
            with fault():
                planted[kind] = step_grads(kernel_model, lr_img, hr_img, False)
    bars = {}
    for k, r in ref.items():
        if r is not None and all(m[k] is not None for m in moved):
            noise = max(rel(m[k], r) for m in moved)
            bars[k] = (noise, max(1e-3, NOISE_MULT * noise))
    rows, bad = _over_bars(got, ref, bars)
    controls = {kind: dict(zip(("rows", "bad"), _over_bars(g, ref, bars)),
                           loss_err=abs(loss - loss_p) / abs(loss_p), sr=sr)
                for kind, (loss, g, sr) in planted.items()}
    return dict(loss_kernels=loss_k, loss_plain=loss_p,
                loss_err=abs(loss_k - loss_p) / abs(loss_p), rows=rows, bad=bad,
                controls=controls, sr_kernels=sr_k, sr_plain=sr_p)


def run_train_check(failures: list) -> None:
    """The kernel path against the plain path on the training step, from
    the same weights, on two batches: the L1 losses within 1e-5 relative;
    every parameter's gradient finite and within its bar
    (``gradient_agreement``); then the losses of 5 L1 Adam steps within
    1e-4 relative."""
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step
    from sisr_tpu_torch.utils.precision import exact_mode

    models = {ref: train_model() for ref in (False, True)}
    ok = True
    for seed in (3, 5):
        res = gradient_agreement(models[False], models[True], *train_batches(1, seed=seed)[0],
                                 faults=("unflipped", "half-ulp") if seed == 3 else ())
        rows, bad = res["rows"], res["bad"]
        ok = ok and res["loss_err"] <= 1e-5 and not bad
        worst = max(rows, key=lambda r: r["err"])
        tight = max(rows, key=lambda r: r["err"] / r["bar"])
        over = [r for r in rows if r["err"] > 1e-3]
        ratio = max((r["err"] / r["noise"] for r in over), default=0.0)
        log(f"  batch {seed}: L1 loss {res['loss_kernels']:.7f} vs plain "
            f"{res['loss_plain']:.7f} (rel {res['loss_err']:.2e}, bar 1e-5); {len(rows)} "
            f"gradients finite; {len(rows) - len(over)} within 1e-3, {len(over)} beyond it "
            f"(their error at most {ratio:.2f}x their noise); worst {worst['err']:.2e} "
            f"({worst['name']}, noise {worst['noise']:.2e}); nearest its bar "
            f"{tight['err']:.2e} of {tight['bar']:.2e} ({tight['name']}); {len(bad)} failed")
        for line in bad[:10]:
            log(f"    {line}")
        for kind, c in res["controls"].items():
            seen = bool(c["bad"])
            ok = ok and seen
            top = max(c["rows"], key=lambda r: r["err"] / r["bar"])
            log(f"  control, dwconv5x5 dx {kind}: loss rel {c['loss_err']:.2e}; "
                f"{len(c['bad'])} of {len(c['rows'])} gradients over their bar, worst "
                f"{top['err']:.2e} of {top['bar']:.2e} ({top['err'] / top['bar']:.1f}x, "
                f"{top['name']}) {'rejected' if seen else 'FAIL: the check passes it'}")
    steps = {}
    with exact_mode():
        for ref, model in models.items():
            step = on_plain(make_train_step(model, l1_loss, adam(model)), ref)
            steps[ref] = [float(step(*b)) for b in train_batches(5, seed=4)]
    step_err = max(abs(a - b) / abs(b) for a, b in zip(steps[False], steps[True]))
    ok = ok and step_err <= 1e-4
    log(f"  5 L1 Adam steps: kernels {', '.join(f'{v:.6f}' for v in steps[False])}; plain "
        f"{', '.join(f'{v:.6f}' for v in steps[True])}; worst rel {step_err:.2e} (bar 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("training step check against the plain path")


# a bfloat16 gradient's error is relative to max(|g|, BF16_REL_FLOOR x |the
# whole gradient|) (tests/test_torch_bf16_train.py's normalisation: a
# gradient a thousandth of the whole is a sum that cancels, its relative
# error rounding noise) and its bar max(BF16_FLOOR, NOISE_MULT x its noise),
# the noise the plain bfloat16 path's largest move when the LR batch moves
# by one bfloat16 ulp (BF16_PROBES seeds); the loss's bar max(BF16_LOSS_FLOOR,
# NOISE_MULT x the loss's move).  Probes that also moved every weight by a
# bfloat16 ulp gave bars no 10% fault reaches, and a fault planted in
# dwconv5x5's backward (dx 10% too large) stays under these bars: its share
# of a gradient is below bfloat16's noise (NVIDIA H100 80GB HBM3, 700.00 W)
BF16_FLOOR, BF16_LOSS_FLOOR, BF16_REL_FLOOR, BF16_PROBES, BF16_STEPS = 1e-2, 1e-4, 1e-3, 4, 3


def _bf16_move(t, seed: int):
    """``t`` with every element x (1 +- 2^-8) at random: one bfloat16 ulp
    (a float32 ulp rarely moves the input's bfloat16 rounding)."""
    import torch

    g = torch.Generator(device=t.device).manual_seed(seed)
    up = torch.rand(t.shape, generator=g, device=t.device) < 0.5
    return t * torch.where(up, 1 + 2.0 ** -8, 1 - 2.0 ** -8)


def bf16_step_check(failures: list, make, label: str, steps: int = BF16_STEPS,
                    card: str = "") -> dict:
    """``steps`` Adam steps (L1, 2e-5) of ``make()``'s bfloat16 model on the
    kernel path, the plain path (``plain_versions()``) taking the kernel
    path's weights and optimizer state before each step (the parameters
    change in place: a stale packed weight would pass step 1 and fail
    after it), cuDNN deterministic.  Each step: the L1 loss and every
    gradient against the plain path's at their bars (``BF16_*``, probed on
    that step).  At the first step the control, which the bars must
    reject: the kernel path's gradients x 1.1."""
    import torch

    kernel, plain = make(), make()
    opt_k, opt_p = adam(kernel), adam(plain)
    out, ok = dict(steps=[]), True
    for i, (lr_img, hr_img) in enumerate(train_batches(steps, seed=9)):
        with exact_deterministic():
            plain.load_state_dict(kernel.state_dict())
            opt_p.load_state_dict(opt_k.state_dict())
            loss_p, ref, _ = step_grads(plain, lr_img, hr_img, True)
            moved = [step_grads(plain, _bf16_move(lr_img, 100 * i + j), hr_img, True)
                     for j in range(BF16_PROBES)]
            loss_k, got, _ = step_grads(kernel, lr_img, hr_img, False)
        floor = BF16_REL_FLOOR * float(torch.sqrt(sum(r.square().sum() for r in ref.values()
                                                      if r is not None)))
        rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(floor))
        bars = {}
        for k, r in ref.items():
            if r is not None and all(m[1][k] is not None for m in moved):
                noise = max(rel(m[1][k], r) for m in moved)
                bars[k] = (noise, max(BF16_FLOOR, NOISE_MULT * noise))
        rows, bad = _over_bars(got, ref, bars, floor)
        loss_noise = max(abs(m[0] - loss_p) / abs(loss_p) for m in moved)
        loss_bar = max(BF16_LOSS_FLOOR, NOISE_MULT * loss_noise)
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        worst = max(rows, key=lambda r: r["err"] / r["bar"])
        # over the gradients past the floor (under it the noise may be 0)
        ratio = max((r["err"] / r["noise"] for r in rows if r["err"] > BF16_FLOOR),
                    default=0.0)
        row = dict(loss_kernels=loss_k, loss_plain=loss_p, loss_rel_err=loss_err,
                   loss_bar=loss_bar, grads=len(rows), grads_over=len(bad),
                   worst_over_bar=worst, max_err_over_noise=ratio)
        ok = ok and loss_err <= loss_bar and not bad
        log(f"  {label} bf16 step {i + 1}: L1 loss {loss_k:.6f} vs plain {loss_p:.6f} (rel "
            f"{loss_err:.2e}, bar {loss_bar:.2e}); {len(rows)} gradients, nearest its bar "
            f"{worst['err']:.2e} of {worst['bar']:.2e} ({worst['name']}), error / noise at "
            f"most {ratio:.2f}; {len(bad)} over "
            f"{'ok' if loss_err <= loss_bar and not bad else 'FAIL'} {card}")
        for line in bad[:5]:
            log(f"    {line}")
        if i == 0:
            c_rows, c_bad = _over_bars({k: None if g is None else 1.1 * g
                                        for k, g in got.items()}, ref, bars, floor)
            row["control_over"] = len(c_bad)
            ok = ok and bool(c_bad)
            top = sorted(c_rows, key=lambda r: r["err"] / r["bar"])[-3:]
            log(f"  control, the gradients x 1.1: {len(c_bad)} of {len(c_rows)} gradients over "
                f"their bar {'rejected' if c_bad else 'FAIL: the check passes it'}; nearest: "
                + ", ".join(f"{r['name']} {r['err']:.2e} / {r['bar']:.2e}" for r in top))
        out["steps"].append(row)
        opt_k.step()
    if not ok:
        failures.append(f"{label} bfloat16 training step against the plain path, or a control")
    out["ok"] = ok
    del kernel, plain, opt_k, opt_p
    torch.cuda.empty_cache()
    return out


# --- the runner: the command line's experiment, train, eval, resume, test ----

# hitsir_pro_experiment as ``python -m sisr_tpu_torch hitsir_pro`` builds it
# (its defaults: the full flagship, L1, Adam 2e-5, batch 2, crop 64, float32,
# two spawned loader workers) on folders synthesized under build/smoke/runner:
# 4 train images (the BSRGAN degradation needs the 256 crop and a margin) and
# 2 eval/test images whose LR areas, 96x120 and 256x320, fall on either side
# of the band area: one runs the whole forward, one BandedHeadSR (2 bands)
RUNNER_TRAIN = ((320, 320),) * 4          # HR (h, w)
RUNNER_EVAL = ((384, 480), (1024, 1280))
RUNNER_BAND_AREA = 200 * 200
RUNNER_EPOCHS = 2                         # then a resume to epoch 3, then test mode
RUNNER_KERNELS = tuple(k for k in SOURCES if k != "htb_fused" and k not in HAT_ONLY)


def runner_folders(root, train=RUNNER_TRAIN, evals=RUNNER_EVAL) -> None:
    """PNG folders data/{train/setA, eval/setB, test/setB} under ``root``
    with HR images of the sizes ``train`` and ``evals`` (eval and test),
    smooth seeded images (a coarse random grid, bicubic-upsampled)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, sizes in (("train", train), ("eval", evals), ("test", evals)):
        d = root / "data" / split / ("setA" if split == "train" else "setB")
        d.mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            coarse = (rng.random((h // 16, w // 16, 3)) * 255).astype(np.uint8)
            Image.fromarray(coarse).resize((w, h), Image.BICUBIC).save(d / f"im{i}.png")


def instrument(exp, rec: dict) -> None:
    """Wrap ``exp``'s train, train_batch, eval, _infer_one, eval_batch and
    save_model_weights to record each epoch's seconds (and within them the
    checkpoint writes, the inference and the metrics), each step's
    launches, and each eval's and test's images (lr, sr, hr arrays and
    launches) in ``rec``."""
    import torch
    from sisr_tpu_torch.ops.kernels import build

    train, batch, evaluate, infer_one, eval_batch, save = (
        exp.train, exp.train_batch, exp.eval, exp._infer_one, exp.eval_batch,
        exp.save_model_weights)
    spent = dict(save=0.0, metrics=0.0)

    def delta(before):
        return {k: build.launches[k] - before[k] for k in build.launches}

    def timed_train():
        n, saved, t0 = len(rec["steps"]), spent["save"], time.perf_counter()
        train()
        torch.cuda.synchronize()
        rec["train"].append(dict(epoch=exp.start_epoch, s=time.perf_counter() - t0,
                                 steps=len(rec["steps"]) - n, loader_wait_s=exp.train_wait_s,
                                 step_s=exp.train_step_s, save_s=spent["save"] - saved,
                                 loss=exp.epoch_loss.avg))

    def counted_batch(lr_imgs, hr_imgs):
        before = dict(build.launches)
        batch(lr_imgs, hr_imgs)
        rec["steps"].append(delta(before))

    def timed_eval(start_epoch=None):
        rec["images"], saved, metrics = [], spent["save"], spent["metrics"]
        t0 = time.perf_counter()
        evaluate(start_epoch)
        rec["eval"].append(dict(epoch=start_epoch or exp.start_epoch,
                                s=time.perf_counter() - t0, images=len(rec["images"]),
                                infer_s=sum(im["s"] for im in rec["images"]),
                                metrics_s=spent["metrics"] - metrics,
                                save_s=spent["save"] - saved))
        rec["evals"].append(rec["images"])

    def counted_infer(lr_img):
        before, t0 = dict(build.launches), time.perf_counter()
        sr = infer_one(lr_img)
        rec["images"].append(dict(lr=lr_img, sr=sr, s=time.perf_counter() - t0,
                                  launches=delta(before)))
        return sr

    def kept_eval_batch(hr_img, sr_img):
        rec["images"][-1]["hr"] = hr_img
        t0 = time.perf_counter()
        eval_batch(hr_img, sr_img)
        spent["metrics"] += time.perf_counter() - t0

    def timed_save(path):
        t0 = time.perf_counter()
        save(path)
        spent["save"] += time.perf_counter() - t0

    exp.train, exp.train_batch, exp.eval = timed_train, counted_batch, timed_eval
    exp._infer_one, exp.eval_batch, exp.save_model_weights = (counted_infer, kept_eval_batch,
                                                             timed_save)


def image_counts(exp, lr_img) -> dict:
    """Launches of one eval image: the whole forward (one head), or
    BandedHeadSR's bands at or above the band area."""
    h, w = lr_img.shape[1:3]
    if h * w >= exp.eval_band_area:
        _, _, pos, packed = exp._banded_eval.plan(h, w)
        return expected_counts(h, w, len(pos), packed, False)
    return expected_counts(h, w, 1, False, False)


def check_images(exp, images: list, failures: list, label: str, plain: bool,
                 card: str) -> None:
    """Each image's launches; with ``plain``, its SR against the plain
    model (float32, TF32 off) within 1e-3 max abs."""
    import numpy as np
    import torch
    from sisr_tpu_torch.utils.precision import exact_mode

    for im in images:
        want = image_counts(exp, im["lr"])
        ok_count = im["launches"] == want
        err = None
        if plain:
            x = torch.from_numpy(im["lr"]).to(exp.device)
            with torch.inference_mode(), exact_mode():
                ref = on_plain(exp.model)(x).clamp(0, 1).float().cpu().numpy()
            err = float(np.abs(ref - im["sr"]).max())
        shape = im["lr"].shape[1:3]
        log(f"  {label} LR {shape[0]}x{shape[1]}: {im['s']:.2f} s, launches "
            f"{'ok' if ok_count else im['launches']}"
            + ("" if err is None else f", max |SR - plain| {err:.2e}") + f" [{card}]")
        if not ok_count:
            failures.append(f"runner {label} {shape}: launches {im['launches']}, want {want}")
        if err is not None and not err <= 1e-3:
            failures.append(f"runner {label} {shape}: SR {err:.2e} from the plain model")


def check_logged_metrics(exp, images: list, failures: list) -> None:
    """The last eval's logged PSNR / SSIM: the port's psnr / ssim of the
    SR images it recorded (Y channel, averaged as AverageMeter does)."""
    from sisr_tpu_torch.data.transforms import convert_image
    from sisr_tpu_torch.ops.metrics import psnr, ssim
    from sisr_tpu_torch.utils.meters import AverageMeter

    p, s = AverageMeter(), AverageMeter()
    for im in images:
        hr_y = convert_image(im["hr"][0], "[0,1]", "y-channel")
        sr_y = convert_image(im["sr"][0], "[0,1]", "y-channel")
        p.update(psnr(hr_y, sr_y, 1.0), 1)
        s.update(ssim(hr_y, sr_y, 1.0), 1)
    row = exp.psnr_ssim_lpips_log[-1]
    if (float(row[1]), float(row[2])) != (p.avg, s.avg):
        failures.append(f"runner: logged metrics {row} are not psnr {p.avg}, ssim {s.avg}")


def check_runner_files(root, exp, failures: list) -> dict:
    """Every log and checkpoint of the run exists and parses back; returns
    the parsed logs."""
    import torch

    logs = root / exp.model_config.log_folder
    weights = root / exp.model_config.checkpoint_folder
    epochs = exp.model_config.epochs

    def rows(name):
        return [line.split() for line in (logs / name).read_text().splitlines()
                if line.strip()]

    parsed = {}
    try:
        loss = rows("loss_log.txt")
        parsed["loss"] = [float(r[1].split(":")[1]) for r in loss]
        metrics = rows("psnr_ssim_lpips_log.txt")
        parsed["psnr_ssim"] = [(float(r[1]), float(r[2]), float(r[3])) for r in metrics]
        parsed["best"] = [float(v) for v in rows("best_epoch_psnr_ssim_lpips_log.txt")[0]]
        lrs = [r[0] for r in rows("lr_log.txt")]
        parsed["lr_epochs"] = [int(r.split(",")[0].split(":")[1]) for r in lrs]
        secs = rows("train_eval_seconds_consume_log.txt")
        parsed["seconds"] = [(float(r[1].split("训练时长:")[1]), float(r[2].split("验证时长:")[1]))
                             for r in secs]
        parsed["total_s"] = float(rows("total_seconds_consume_log.txt")[0][0])
        parsed["params"] = int((logs / "模型参数量.txt").read_text().split(":")[1])
        ok = ([r[0] for r in loss] == [f"epoch:{e:05d}" for e in range(1, epochs + 1)]
              and [r[0] for r in metrics] == [r[0] for r in loss]
              and parsed["lr_epochs"] == list(range(1, epochs + 2))
              and len(secs) == epochs and all(r[3] == "验证数据集:setB" for r in secs)
              and parsed["params"] == sum(p.numel() for p in exp.model.parameters())
              and all(math.isfinite(v) for v in parsed["loss"])
              and all(math.isfinite(v) for r in parsed["psnr_ssim"] for v in r))
        if not ok:
            failures.append(f"runner logs: {parsed}")
        keys = set(exp.model.state_dict())
        for name in ("new_epoch_model.pth", "best_psnr_model.pth", "best_ssim_model.pth",
                     "best_psnr_ssim_lpips_model.pth"):
            dic = torch.load(weights / name, map_location="cpu", weights_only=True)
            if set(dic["model"]) != keys or not dic["optimizer"]["state"]:
                failures.append(f"runner checkpoint {name}: keys or optimizer state")
        parsed["new_epoch_start_epoch"] = int(torch.load(
            weights / "new_epoch_model.pth", map_location="cpu",
            weights_only=True)["start_epoch"])
        if parsed["new_epoch_start_epoch"] != epochs:
            failures.append(f"runner: new_epoch_model.pth at epoch "
                            f"{parsed['new_epoch_start_epoch']}, want {epochs}")
    except (OSError, ValueError, IndexError, KeyError):
        failures.append(f"runner logs or checkpoints: {traceback.format_exc()}")
    return parsed


def run_runner(failures: list, card: str) -> dict:
    """The experiment runner on the card: 2 epochs of train + eval from
    synthesized weights, a resume to epoch 3 (model, optimizer state and
    the cosine learning rate), then test mode on the best checkpoint.
    Returns the launches over the whole phase."""
    import os
    import shutil
    from pathlib import Path

    import torch
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.__main__ import experiment_kwargs, parse_args
    from sisr_tpu_torch.configs.model_config import get_scheduler
    from sisr_tpu_torch.experiments.hitsir_pro_experiment import hitsir_pro_experiment
    from sisr_tpu_torch.ops.kernels import build

    root = Path(__file__).resolve().parent / "build" / "smoke" / "runner"
    shutil.rmtree(root, ignore_errors=True)
    runner_folders(root)
    kw = experiment_kwargs(parse_args(
        ["hitsir_pro", "--epochs", str(RUNNER_EPOCHS), "--train-sets", "setA",
         "--eval-sets", "setB", "--test-sets", "setB"]))
    kw.update(progress=False, eval_band_area=RUNNER_BAND_AREA, run=False)
    rec = dict(train=[], steps=[], eval=[], images=[], evals=[])
    want_step = {k: PER_STEP.get(k, 0) for k in build.launches}
    summary = dict(card=card)
    cwd = os.getcwd()
    os.chdir(root)
    exps = []
    try:
        build.reset_launches()
        exp = hitsir_pro_experiment(**kw)
        exps.append(exp)
        infer.synth_weights(exp.model, seed=0)
        instrument(exp, rec)
        # the spawned loader workers start (and import torch) before the
        # first epoch: timed apart, so that the epochs show the steady state
        t0 = time.perf_counter()
        for loader in exp.train_loaders:
            loader._ensure_pool()
        summary["loader_start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        exp.run()
        summary["first_run_s"] = time.perf_counter() - t0
        for epoch, images in enumerate(rec["evals"], 1):
            check_images(exp, images, failures, f"eval epoch {epoch}", epoch == RUNNER_EPOCHS,
                         card)
        check_logged_metrics(exp, rec["images"], failures)

        # the resume: the same command with --epochs 3
        kw.update(epochs=RUNNER_EPOCHS + 1)
        resumed = hitsir_pro_experiment(**kw)
        exps.append(resumed)
        opt_a, opt_b = exp.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
        same_opt = opt_a["state"].keys() == opt_b["state"].keys() and all(
            torch.equal(opt_a["state"][i][k], opt_b["state"][i][k])
            for i in opt_a["state"] for k in opt_a["state"][i])
        same_model = all(torch.equal(a, b) for a, b in
                         zip(exp.model.state_dict().values(), resumed.model.state_dict().values()))
        lr = resumed.state.optimizer.param_groups[0]["lr"]
        want_lr = get_scheduler(2e-5, 1e-7, RUNNER_EPOCHS + 1)(RUNNER_EPOCHS)
        log(f"  resume: start_epoch {resumed.start_epoch}, optimizer state "
            f"{'equal' if same_opt else 'DIFFERS'}, model {'equal' if same_model else 'DIFFERS'}"
            f", lr {lr!r} (want {want_lr!r})")
        if not (resumed.start_epoch == RUNNER_EPOCHS + 1 and same_opt and same_model
                and len(opt_b["state"]) > 0 and lr == want_lr):
            failures.append("runner resume: start_epoch, optimizer state, model or lr")
        exp.close()
        exps.remove(exp)
        del exp, opt_a, opt_b
        instrument(resumed, rec)
        for loader in resumed.train_loaders:
            loader._ensure_pool()
        resumed.run()
        check_images(resumed, rec["images"], failures, f"eval epoch {RUNNER_EPOCHS + 1}", True,
                     card)
        check_logged_metrics(resumed, rec["images"], failures)
        summary["logs"] = check_runner_files(root, resumed, failures)

        # test mode on the best checkpoint
        kw.update(is_test=True)
        tested = hitsir_pro_experiment(**kw)
        exps.append(tested)
        instrument(tested, rec)
        rec["images"], t0 = [], time.perf_counter()
        tested.run()
        summary["test_s"] = time.perf_counter() - t0
        check_images(tested, rec["images"], failures, "test", False, card)
        result = Path(tested.result_path) / "setB"
        tlog = (result / "test_log.txt").read_text().split()
        summary["test_psnr"], summary["test_ssim"] = (float(tlog[0].split(":")[1]),
                                                      float(tlog[1].split(":")[1]))
        written = all((result / f"im{i}_{tag}.png").exists()
                      for i in range(len(RUNNER_EVAL)) for tag in ("hr", "sr"))
        if not (written and len(rec["images"]) == len(RUNNER_EVAL)
                and math.isfinite(summary["test_psnr"]) and math.isfinite(summary["test_ssim"])):
            failures.append(f"runner test stage: PNGs {written}, log {tlog}")
        counts = dict(build.launches)
    finally:
        for e in exps:
            e.close()
        os.chdir(cwd)

    bad = [s for s in rec["steps"] if s != want_step]
    if bad or not rec["steps"]:
        failures.append(f"runner: {len(bad)} of {len(rec['steps'])} train steps launch "
                        f"otherwise than the train phase's {PER_STEP}: {bad[:1]}")
    summary["epochs"] = []
    for tr, ev in zip(rec["train"], rec["eval"]):
        busy = tr["loader_wait_s"] + tr["step_s"]
        row = dict(epoch=tr["epoch"], train_s=tr["s"], steps=tr["steps"],
                   steps_per_s=tr["steps"] / tr["s"], loader_wait_s=tr["loader_wait_s"],
                   step_s=tr["step_s"], loader_wait_share=tr["loader_wait_s"] / busy,
                   train_checkpoint_s=tr["save_s"], loss=tr["loss"], eval_s=ev["s"],
                   eval_images=ev["images"], eval_s_per_image=ev["s"] / max(ev["images"], 1),
                   eval_infer_s=ev["infer_s"], eval_metrics_s=ev["metrics_s"],
                   eval_checkpoint_s=ev["save_s"])
        summary["epochs"].append(row)
        log(f"  epoch {row['epoch']}: train {row['train_s']:.3f} s ({row['steps']} steps, "
            f"{row['steps_per_s']:.3f} steps/s; waiting on the loader {row['loader_wait_s']:.3f}"
            f" s against {row['step_s']:.3f} s in steps: host share "
            f"{100 * row['loader_wait_share']:.1f}%; checkpoint {row['train_checkpoint_s']:.3f}"
            f" s), eval {row['eval_s']:.3f} s ({row['eval_images']} images: inference "
            f"{row['eval_infer_s']:.3f} s, metrics {row['eval_metrics_s']:.3f} s, best "
            f"checkpoints {row['eval_checkpoint_s']:.3f} s), L1 {row['loss']:.5f} [{card}]")
        if not math.isfinite(row["loss"]):
            failures.append(f"runner epoch {row['epoch']}: loss {row['loss']}")
    summary["launches"] = counts
    log(f"  loader workers' start: {summary['loader_start_s']:.3f} s [{card}]")
    log(f"  test stage: {summary['test_s']:.2f} s for {len(RUNNER_EVAL)} images, Y-PSNR "
        f"{summary['test_psnr']:.4f} dB, SSIM {summary['test_ssim']:.5f} [{card}]")
    log(f"  launches over the phase: {counts}")
    log(json.dumps({"runner": summary}))
    return counts


# --- the other heads: the flagship's widths with each head of the reference --

# (label, HiTSIR overrides of flagship_config): the pixel-shuffle heads x4
# and x2, the one-step head, and the nearest+conv head after the plain
# shallow conv
HEADS = (("pixelshuffle x4", dict(upsampler="pixelshuffle", upscale=4)),
         ("pixelshuffle x2", dict(upsampler="pixelshuffle", upscale=2)),
         ("pixelshuffledirect x4", dict(upsampler="pixelshuffledirect", upscale=4)),
         ("nearest+conv, plain conv_first", dict(is_mult_size_conv_feat_extract=False)))


def head_counts(over: dict) -> dict:
    """Launches of one 192x192 tile's forward with the head ``over``: the
    body's as a tile's (``PER_TILE``); conv3x3 runs conv_after_body, and
    conv_before_upsample where the head has one; only the nearest+conv
    head runs the packed x4 head (conv_up1 on conv3x3, conv_up2, the tail)."""
    from sisr_tpu_torch.ops.kernels import build

    up = over.get("upsampler", "nearest+conv")
    want = dict.fromkeys(build.launches, 0)
    want.update(PER_TILE)
    if up != "nearest+conv":
        want.update(conv3x3=7 + (up == "pixelshuffle"), conv3x3_shuffled=0,
                    conv3x3_shuffled_tail=0)
    return want


def _psnr_db(a, b) -> float:
    return 10 * math.log10(1.0 / max(float(((a - b) ** 2).mean()), 1e-20))


def run_heads(failures: list, card: str) -> dict:
    """Each head of ``HEADS`` at the flagship's widths and depth (weights
    from param_synth, seed 0) on a 192x192 tile, float32 and bfloat16:
    every launch counter checked per forward, the wall ms (median of 3),
    then the kernel path as timed (PyTorch's defaults) against the plain
    model (float32, TF32 off):
    float32 within 1e-3 max abs and 5e-5 rms, bfloat16 >= min(44, plain
    bfloat16 - 3) dB.  Returns the launches over the phase."""
    import statistics

    import torch
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.utils.precision import exact_mode

    g = torch.Generator(device="cuda").manual_seed(2)
    tile = torch.rand((1, TILE, TILE, 3), generator=g, device="cuda")
    summary = {}
    build.reset_launches()
    for label, over in HEADS:
        models = {}
        for dt in ("float32", "bfloat16"):
            model = HiTSIR(**flagship_config(**over), dtype=getattr(torch, dt))
            model = model.to("cuda").eval()
            infer.synth_weights(model, seed=0)
            models[dt] = model
        want = head_counts(over)
        row = dict(params=sum(p.numel() for p in models["float32"].parameters()))
        with torch.inference_mode():
            for dt, model in models.items():
                model(tile)                       # warm
                torch.cuda.synchronize()
                ms, ok = [], True
                for _ in range(3):
                    before = dict(build.launches)
                    t0 = time.perf_counter()
                    out = model(tile)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    got = {k: build.launches[k] - before[k] for k in build.launches}
                    scale = over.get("upscale", 4)
                    ok = ok and (got == want and bool(torch.isfinite(out).all())
                                 and tuple(out.shape) == (1, TILE * scale, TILE * scale, 3))
                if not ok:
                    failures.append(f"heads {label} {dt}: shape/finite/launches "
                                    f"{ {k: v for k, v in got.items() if v} }, want "
                                    f"{ {k: v for k, v in want.items() if v} }")
                row[dt] = dict(median_ms=statistics.median(ms), runs_ms=ms,
                               launches={k: v for k, v in got.items() if v})
            # the kernel path under PyTorch's defaults, as timed and served
            err = models["float32"](tile).clamp(0, 1)
            k16 = models["bfloat16"](tile).float().clamp(0, 1)
            with exact_mode():
                ref = on_plain(models["float32"])(tile).clamp(0, 1)
                p16 = on_plain(models["bfloat16"])(tile).float().clamp(0, 1)
            err = (err - ref).abs()
        row.update(max_abs=float(err.max()), rms=float(err.square().mean().sqrt()),
                   db_bf16=_psnr_db(k16, ref), db_plain_bf16=_psnr_db(p16, ref))
        bar16 = min(44.0, row["db_plain_bf16"] - 3.0)
        ok = row["max_abs"] < 1e-3 and row["rms"] < 5e-5 and row["db_bf16"] >= bar16
        log(f"  {label:31s} {row['params']:,} params: f32 {row['float32']['median_ms']:.1f} ms"
            f", bf16 {row['bfloat16']['median_ms']:.1f} ms ({TILE}x{TILE}, wall median of 3); "
            f"f32 vs plain max abs {row['max_abs']:.3e} (bar 1e-3), rms {row['rms']:.3e} "
            f"(bar 5e-5); bf16 {row['db_bf16']:.2f} dB (bar {bar16:.2f}; plain bf16 "
            f"{row['db_plain_bf16']:.2f}) {'ok' if ok else 'FAIL'} [{card}]")
        log(f"    launches a forward: {row['float32']['launches']}")
        if not ok:
            failures.append(f"heads {label}: the kernel path against the plain model")
        summary[label] = row
        del models
        torch.cuda.empty_cache()
    counts = dict(build.launches)
    log(f"  launches over the phase: {counts}")
    log(json.dumps({"heads": summary}))
    return counts


# --- HAT x4: the 1080p frame through models/hat.py -----------------------------

# one HAT x4 forward's launches (6 RHAGs of 6 HABs and an OCAB): each
# attention on win_attn; each HAB's two CAB convs, each RHAG's conv,
# conv_after_body and conv_before_upsample on conv3x3; no other kernel
HAT_FORWARD = {"win_attn": sum(n for *_, n in HAT_ATTN), "conv3x3": 80}
HAT_KERNELS = tuple(HAT_FORWARD)
# an LR image that TiledSR cuts into 192 tiles (overlap 16), as
# ``python -m sisr_tpu_torch.infer --arch hat`` serves it
HAT_TILED_LR = (200, 260)


def run_hat(failures: list, card: str) -> dict:
    """HAT x4 at its published widths (weights from param_synth, seed 0)
    in bfloat16 on the 1080p frame (LR 1080x1920, which the model
    reflect-pads to 1088x1920): each forward's launches exactly
    ``HAT_FORWARD``, the wall ms (median of 3) and the peak device memory;
    the kernel path (PyTorch's defaults) against the plain model (float32,
    TF32 off) at the heads phase's bfloat16 bar, >= min(44, plain bfloat16
    - 3) dB; then one ``HAT_TILED_LR`` image through ``infer.upscale``
    (TiledSR, tile 192): ``HAT_FORWARD`` launches a tile.  Returns the
    launches over the phase."""
    import statistics

    import torch
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.models.hat import HAT
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.utils.precision import exact_mode

    g = torch.Generator(device="cuda").manual_seed(19)
    frame = torch.rand((1, *FRAME, 3), generator=g, device="cuda")
    models = {}
    for dt in ("bfloat16", "float32"):
        model = HAT(dtype=getattr(torch, dt)).to("cuda").eval()
        infer.synth_weights(model, seed=0)
        models[dt] = model
    m16 = models["bfloat16"]
    want = dict.fromkeys(build.launches, 0)
    want.update(HAT_FORWARD)
    row = dict(params=sum(p.numel() for p in m16.parameters()), lr=list(FRAME))
    build.reset_launches()
    with torch.inference_mode():
        m16(frame)                                # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, bad = [], []
        for _ in range(3):
            before = dict(build.launches)
            t0 = time.perf_counter()
            out = m16(frame)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: build.launches[k] - before[k] for k in build.launches}
            if got != want:
                bad.append({k: v for k, v in got.items() if v})
        row.update(median_ms=statistics.median(ms), runs_ms=ms,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches={k: v for k, v in got.items() if v})
        shape = (1, 4 * FRAME[0], 4 * FRAME[1], 3)
        if bad or tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            failures.append(f"hat frame: shape {tuple(out.shape)} (want {shape}), finite, "
                            f"launches {bad[:1]} (want {HAT_FORWARD})")
        k16 = out.float().clamp(0, 1)
        del out
        with exact_mode():
            ref = on_plain(models["float32"])(frame).clamp(0, 1)
            p16 = on_plain(m16)(frame).float().clamp(0, 1)
        row.update(db_bf16=_psnr_db(k16, ref), db_plain_bf16=_psnr_db(p16, ref),
                   max_abs_vs_plain_bf16=float((k16 - p16).abs().max()))
        del k16, ref, p16
        bar16 = min(44.0, row["db_plain_bf16"] - 3.0)
        ok = row["db_bf16"] >= bar16
        log(f"  HAT x4 {row['params']:,} params, LR {FRAME[0]}x{FRAME[1]} bf16: "
            f"{row['median_ms']:.1f} ms (wall median of 3), peak {row['peak_gib']:.2f} GiB; "
            f"launches a forward {row['launches']} (want {HAT_FORWARD}); against the plain "
            f"float32 model {row['db_bf16']:.2f} dB (bar {bar16:.2f}; plain bf16 "
            f"{row['db_plain_bf16']:.2f}), max abs against plain bf16 "
            f"{row['max_abs_vs_plain_bf16']:.3e} {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            failures.append("hat frame: the kernel path against the plain model")
        # the command line's route: infer.upscale over TiledSR's 192 tiles
        lr = torch.rand((*HAT_TILED_LR, 3), generator=g, device="cuda")
        before = build.launches["win_attn"]
        sr = infer.upscale(m16, lr)
        tiles = (build.launches["win_attn"] - before) / HAT_FORWARD["win_attn"]
        row["tiled"] = dict(lr=list(HAT_TILED_LR), tiles=tiles)
        shape = (4 * HAT_TILED_LR[0], 4 * HAT_TILED_LR[1], 3)
        log(f"  infer.upscale over TiledSR(tile 192), LR {HAT_TILED_LR[0]}x{HAT_TILED_LR[1]}: "
            f"{tiles} tiles of {HAT_FORWARD['win_attn']} win_attn launches, "
            f"shape {tuple(sr.shape)}")
        if (tiles < 1 or tiles != int(tiles) or tuple(sr.shape) != shape
                or not bool(torch.isfinite(sr).all())):
            failures.append(f"hat tiled: {tiles} tiles' launches, shape {tuple(sr.shape)}")
    del models, m16
    torch.cuda.empty_cache()
    counts = dict(build.launches)
    log(f"  launches over the phase: {counts}")
    log(json.dumps({"hat": row}))
    return counts


# --- DAT x4: the 1080p frame through models/dat.py -----------------------------

# one DAT x4 forward's launches (6 groups of 3 spatial and 3 channel blocks):
# each spatial attention's two branches in one win_attn launch, each channel
# attention's whole-image sums on chan_attn; the group convs, conv_after_body
# and conv_before_upsample on conv3x3; no other kernel
DAT_FORWARD = {"win_attn": sum(n for _, n in DAT_ATTN), "chan_attn": DAT_CHAN, "conv3x3": 8}
DAT_KERNELS = tuple(DAT_FORWARD)


def dat_statistics(model, seed: int) -> None:
    """Seeded BatchNorm running statistics (means 0.1 N(0, 1), variances
    1 + U(0, 0.5)), so that folding them into the convs is no identity."""
    import torch

    g = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
        elif name.endswith("running_var"):
            buf.copy_(1.0 + 0.5 * torch.rand(buf.shape, generator=g))


def run_dat(failures: list, card: str) -> dict:
    """DAT x4 at its published widths (weights from param_synth, seed 0,
    BatchNorm statistics from ``dat_statistics``) in bfloat16 on the 1080p
    frame (LR 1080x1920, which the spatial attention takes as zero-padded
    to 1088x1920 in the kernel): each forward's launches exactly
    ``DAT_FORWARD``, the wall ms (median of 3) and the peak device memory;
    the kernel path (PyTorch's defaults) against the plain model (float32,
    TF32 off) at the heads phase's bfloat16 bar, >= min(44, plain bfloat16
    - 3) dB; then one ``HAT_TILED_LR`` image through ``infer.upscale``
    (TiledSR, tile 192): ``DAT_FORWARD`` launches a tile.  Returns the
    launches over the phase."""
    import statistics

    import torch
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.models.dat import DAT
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.utils.precision import exact_mode

    g = torch.Generator(device="cuda").manual_seed(23)
    frame = torch.rand((1, *FRAME, 3), generator=g, device="cuda")
    models = {}
    for dt in ("bfloat16", "float32"):
        model = DAT(dtype=getattr(torch, dt)).eval()
        infer.synth_weights(model, seed=0)
        dat_statistics(model, seed=0)
        models[dt] = model.to("cuda")
    m16 = models["bfloat16"]
    want = dict.fromkeys(build.launches, 0)
    want.update(DAT_FORWARD)
    row = dict(params=sum(p.numel() for p in m16.parameters()), lr=list(FRAME))
    build.reset_launches()
    with torch.inference_mode():
        m16(frame)                                # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, bad = [], []
        for _ in range(3):
            before = dict(build.launches)
            t0 = time.perf_counter()
            out = m16(frame)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: build.launches[k] - before[k] for k in build.launches}
            if got != want:
                bad.append({k: v for k, v in got.items() if v})
        row.update(median_ms=statistics.median(ms), runs_ms=ms,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches={k: v for k, v in got.items() if v})
        shape = (1, 4 * FRAME[0], 4 * FRAME[1], 3)
        if bad or tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            failures.append(f"dat frame: shape {tuple(out.shape)} (want {shape}), finite, "
                            f"launches {bad[:1]} (want {DAT_FORWARD})")
        k16 = out.float().clamp(0, 1)
        del out
        with exact_mode():
            ref = on_plain(models["float32"])(frame).clamp(0, 1)
            p16 = on_plain(m16)(frame).float().clamp(0, 1)
        row.update(db_bf16=_psnr_db(k16, ref), db_plain_bf16=_psnr_db(p16, ref),
                   max_abs_vs_plain_bf16=float((k16 - p16).abs().max()))
        del k16, ref, p16
        bar16 = min(44.0, row["db_plain_bf16"] - 3.0)
        ok = row["db_bf16"] >= bar16
        log(f"  DAT x4 {row['params']:,} params, LR {FRAME[0]}x{FRAME[1]} bf16: "
            f"{row['median_ms']:.1f} ms (wall median of 3), peak {row['peak_gib']:.2f} GiB; "
            f"launches a forward {row['launches']} (want {DAT_FORWARD}); against the plain "
            f"float32 model {row['db_bf16']:.2f} dB (bar {bar16:.2f}; plain bf16 "
            f"{row['db_plain_bf16']:.2f}), max abs against plain bf16 "
            f"{row['max_abs_vs_plain_bf16']:.3e} {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            failures.append("dat frame: the kernel path against the plain model")
        # the command line's route: infer.upscale over TiledSR's 192 tiles
        lr = torch.rand((*HAT_TILED_LR, 3), generator=g, device="cuda")
        before = dict(build.launches)
        sr = infer.upscale(m16, lr)
        per = {k: build.launches[k] - before[k] for k in DAT_FORWARD}
        tiles = per["win_attn"] / DAT_FORWARD["win_attn"]
        row["tiled"] = dict(lr=list(HAT_TILED_LR), tiles=tiles, launches=per)
        shape = (4 * HAT_TILED_LR[0], 4 * HAT_TILED_LR[1], 3)
        log(f"  infer.upscale over TiledSR(tile 192), LR {HAT_TILED_LR[0]}x{HAT_TILED_LR[1]}: "
            f"{tiles} tiles, launches {per}, shape {tuple(sr.shape)}")
        if (tiles < 1 or tiles != int(tiles) or tuple(sr.shape) != shape
                or per != {k: int(tiles) * n for k, n in DAT_FORWARD.items()}
                or not bool(torch.isfinite(sr).all())):
            failures.append(f"dat tiled: launches {per} ({tiles} tiles), shape "
                            f"{tuple(sr.shape)}")
    del models, m16
    torch.cuda.empty_cache()
    counts = dict(build.launches)
    log(f"  launches over the phase: {counts}")
    log(json.dumps({"dat": row}))
    return counts


# --- the GAN fine-tune: the two-optimizer step and its runner ----------------

GAN_WARM, GAN_STEPS = 2, 5
# the D state after a step: |kernel - plain| <= GAN_D_ATOL + GAN_D_RTOL |plain|
# (the reference's D steps' bar, tests/test_gan_components.py)
GAN_D_ATOL, GAN_D_RTOL = 5e-5, 1e-3


def gan_parts():
    """The GAN step's other networks on the card, seeded: the reference's
    UNetDiscriminatorSN(64) in train mode, and the perceptual loss over a
    random full-width VGG19 (the repo holds no pretrained weights)."""
    import torch
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN
    from sisr_tpu_torch.models.vgg import PerceptualLoss

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        d = UNetDiscriminatorSN(64)
        torch.manual_seed(0)
        perceptual = PerceptualLoss()
    return d.to("cuda").train(), perceptual.to("cuda")


def gan_grads(g, d, perceptual, lr_img, hr_img, stale_uv: bool = False) -> tuple:
    """The plain path's gradients of one GAN step without its optimizer
    updates, against a copy of ``d``: the generator's of the G phase's
    loss, then the discriminator's of the D phase (u, v advancing on the
    copy, as in the step).  ``stale_uv`` plants the check's control fault:
    the D phase starts from u, v as they were before the G phase's
    forward."""
    import copy

    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import (gan_discriminator_backward,
                                                  gan_generator_loss)

    d_run = copy.deepcopy(d).requires_grad_(False)
    g.zero_grad(set_to_none=True)
    sr = on_plain(g)(lr_img, deterministic=False)
    gan_generator_loss(sr, hr_img, d_run, l1_loss, perceptual).backward()
    if stale_uv:
        d_run = copy.deepcopy(d)
    gan_discriminator_backward(d_run.requires_grad_(True), hr_img, sr)
    return _grads(g), _grads(d_run)


def _grads(model) -> dict:
    return {k: None if p.grad is None else p.grad.clone() for k, p in model.named_parameters()}


def run_gan_check(failures: list, card: str) -> dict:
    """The GAN step on the kernel path against the plain path from the
    same generator, discriminator (with u, v) and VGG19, on one seeded
    batch, float32 with TF32 off: g_loss and d_loss within 1e-4 relative;
    every generator and discriminator gradient within max(1e-3,
    NOISE_MULT x the plain path's own move under one-ulp moves of the LR
    batch or the generator's weights, or the batch by 1e-6 relative); the
    discriminator's parameters and u, v after the step within 5e-5 abs +
    1e-3 rel (a bar that one Adam step at 2e-5 cannot cross: the D
    gradients hold the D phase).  The control: the D phase from stale
    u, v must fail the D gradients' bars.  Then the kernel step once more
    under PyTorch's defaults (cuDNN TF32 on for D and the VGG19), its
    losses against the exact plain step's, for the record."""
    import copy

    import torch
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_gan_train_step
    from sisr_tpu_torch.utils.precision import exact_mode

    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    lr_img, hr_img = train_batches(1, seed=7)[0]

    def run(g, d, plain):
        # hitsir_pro_gan_experiment's settings: L1 + 1.0 perceptual + 0.1
        # adversarial, Adam 2e-5, betas (0.9, 0.99) for both networks
        step = on_plain(make_gan_train_step(g, d, l1_loss, perceptual, adam(g), adam(d)),
                        plain)
        g_loss, d_loss = step(lr_img, hr_img)
        return dict(g_loss=float(g_loss), d_loss=float(d_loss), grads=_grads(g),
                    d_grads=_grads(d), d_state={k: v.clone() for k, v in d.state_dict().items()})

    with exact_mode():
        d0, perceptual = gan_parts()
        plain = train_model()
        base = gan_grads(plain, d0, perceptual, lr_img, hr_img)
        moved = [gan_grads(plain, d0, perceptual, x, hr_img)
                 for x in (_ulp_move(lr_img, 11), _ulp_move(lr_img, 12), lr_img * (1 + 1e-6))]
        shifted = train_model()
        for seed in (13, 14):
            with torch.no_grad():
                for i, (p, q) in enumerate(zip(shifted.parameters(), plain.parameters())):
                    p.copy_(_ulp_move(q, seed * 1000 + i))
            moved.append(gan_grads(shifted, d0, perceptual, lr_img, hr_img))
        del shifted
        stale = gan_grads(plain, d0, perceptual, lr_img, hr_img, stale_uv=True)[1]
        res = dict(kernels=run(train_model(), copy.deepcopy(d0), False),
                   plain=run(plain, copy.deepcopy(d0), True))
    tf32 = run(train_model(), copy.deepcopy(d0), False)
    bars = [{}, {}]
    for j, bar in enumerate(bars):
        for k, r in base[j].items():
            if r is not None and all(m[j][k] is not None for m in moved):
                noise = max(rel(m[j][k], r) for m in moved)
                bar[k] = (noise, max(1e-3, NOISE_MULT * noise))
    rows, bad = _over_bars(res["kernels"]["grads"], res["plain"]["grads"], bars[0])
    d_rows, d_bad = _over_bars(res["kernels"]["d_grads"], res["plain"]["d_grads"], bars[1])
    # the probes' losses are the step's two phases: the plain step's
    # gradients stay within the bars of the probes' unmoved ones
    unlike = (_over_bars(res["plain"]["grads"], base[0], bars[0])[1]
              + _over_bars(res["plain"]["d_grads"], base[1], bars[1])[1])
    control = _over_bars(stale, base[1], bars[1])[1]
    k_d, p_d = res["kernels"]["d_state"], res["plain"]["d_state"]
    d_over = {k: float(((k_d[k] - v).abs() - GAN_D_RTOL * v.abs()).max())
              for k, v in p_d.items()}
    d_worst = max(d_over, key=d_over.get)
    loss_err = {k: abs(res["kernels"][k] - res["plain"][k]) / abs(res["plain"][k])
                for k in ("g_loss", "d_loss")}
    tf32_err = {k: abs(tf32[k] - res["plain"][k]) / abs(res["plain"][k])
                for k in ("g_loss", "d_loss")}
    worst = max(rows, key=lambda r: r["err"])
    tight = max(rows, key=lambda r: r["err"] / r["bar"])
    d_worst_grad = max(d_rows, key=lambda r: r["err"])
    d_tight = max(d_rows, key=lambda r: r["err"] / r["bar"])
    ok = (all(v <= 1e-4 for v in loss_err.values()) and not bad and not d_bad
          and d_over[d_worst] <= GAN_D_ATOL and not unlike and bool(control))
    log(f"  GAN step (TF32 off): g_loss {res['kernels']['g_loss']:.7f} vs plain "
        f"{res['plain']['g_loss']:.7f} (rel {loss_err['g_loss']:.2e}), d_loss "
        f"{res['kernels']['d_loss']:.7f} vs {res['plain']['d_loss']:.7f} (rel "
        f"{loss_err['d_loss']:.2e}; bar 1e-4); {len(rows)} generator gradients, worst "
        f"{worst['err']:.2e} ({worst['name']}, noise {worst['noise']:.2e}), nearest its bar "
        f"{tight['err']:.2e} of {tight['bar']:.2e} ({tight['name']}), {len(bad)} failed; "
        f"{len(d_rows)} discriminator gradients, worst {d_worst_grad['err']:.2e} "
        f"({d_worst_grad['name']}, noise {d_worst_grad['noise']:.2e}), nearest its bar "
        f"{d_tight['err']:.2e} of {d_tight['bar']:.2e} ({d_tight['name']}), {len(d_bad)} "
        f"failed; the plain step's vs the probe's: {len(unlike)} over their bar; D state "
        f"worst |k - p| - 1e-3 |p| {d_over[d_worst]:.2e} ({d_worst}; bar 5e-5) "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    log(f"  control, the D phase from stale u, v: {len(control)} of {len(d_rows)} "
        f"discriminator gradients over their bar (must be > 0)")
    log(f"  the kernel step under PyTorch's defaults (cuDNN TF32 on) against the exact "
        f"plain step: g_loss rel {tf32_err['g_loss']:.2e}, d_loss rel "
        f"{tf32_err['d_loss']:.2e} (recorded, not a bar) [{card}]")
    for line in (bad + d_bad + unlike)[:10]:
        log(f"    {line}")
    if not ok:
        failures.append("GAN step check against the plain path")
    return dict(loss_err=loss_err, worst_grad=worst, tightest=tight,
                d_worst_grad=d_worst_grad, d_tightest=d_tight, d_worst=d_over[d_worst],
                plain_vs_probe_over_bar=len(unlike), failed=len(bad) + len(d_bad),
                stale_uv_over_bar=len(control), tf32_loss_err=tf32_err)


def gan_split(step, g_opt, d_opt, lr_img, hr_img) -> dict:
    """One more kernel-path GAN step, ``step`` itself, with CUDA events
    recorded by hooks on the two optimizers' ``step``: the G phase (the
    generator's forward, the three losses, the backward) ends where G's
    optimizer starts, the D phase (two forwards and backwards) where D's
    starts."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    hooks = []
    for opt, i in ((g_opt, 1), (d_opt, 3)):
        hooks.append(opt.register_step_pre_hook(lambda *_, i=i: ev[i].record()))
        hooks.append(opt.register_step_post_hook(lambda *_, i=i: ev[i + 1].record()))
    ev[0].record()
    try:
        step(lr_img, hr_img)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    names = ("g_phase_ms", "g_optimizer_ms", "d_phase_ms", "d_optimizer_ms")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def run_gan_steps(failures: list, card: str) -> dict:
    """GAN steps of the flagship in float32 (TF32 as PyTorch sets it: on
    for cuDNN's convolutions, off for matmuls) through
    ``make_gan_train_step``: 2 warm, 5 timed, every launch counter checked
    per step (the train phase's ``PER_STEP``: the discriminator and the
    VGG launch no kernel of ours), on the kernel path then the plain path;
    one more kernel-path step split by CUDA events and one profiled."""
    import statistics

    import torch
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_gan_train_step

    summary = dict(card=card, tf32_cudnn=torch.backends.cudnn.allow_tf32,
                   tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    mp = TRAIN_BATCH * TRAIN_LR * TRAIN_LR / 1e6
    for label, plain in (("kernels", False), ("plain", True)):
        g = train_model()
        d, perceptual = gan_parts()
        g_opt, d_opt = adam(g), adam(d)
        step = on_plain(make_gan_train_step(g, d, l1_loss, perceptual, g_opt, d_opt), plain)
        batches = train_batches(GAN_WARM + GAN_STEPS, seed=0)
        for lr_img, hr_img in batches[:GAN_WARM]:
            step(lr_img, hr_img)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = {k: 0 if plain else PER_STEP.get(k, 0) for k in build.launches}
        ms, losses = [], []
        for lr_img, hr_img in batches[GAN_WARM:]:
            before = dict(build.launches)
            t0 = time.perf_counter()
            g_loss, d_loss = step(lr_img, hr_img)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append((float(g_loss), float(d_loss)))
            got = {k: build.launches[k] - before[k] for k in build.launches}
            if got != want or not all(math.isfinite(v) for v in losses[-1]):
                failures.append(f"gan step {label}: losses {losses[-1]}, launches {got}, "
                                f"want {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(ms)
        row = summary[label] = dict(median_ms=med, min_ms=min(ms), runs_ms=ms,
                                    lr_mp_per_s=mp / (med / 1e3), peak_gib=peak,
                                    losses=losses)
        log(f"  {label:7s} {GAN_STEPS} GAN steps (batch {TRAIN_BATCH}, LR {TRAIN_LR} -> HR "
            f"{4 * TRAIN_LR}, float32): median {med:.1f} ms, min {min(ms):.1f} ms, "
            f"{row['lr_mp_per_s']:.4f} LR MP/s, peak {peak:.2f} GiB; (g_loss, d_loss) "
            + ", ".join(f"({a:.5f}, {b:.5f})" for a, b in losses) + f" [{card}]")
        if not plain:
            row["launches_per_step"] = {k: v for k, v in want.items() if v}
            log(f"  launches per step (each checked): {row['launches_per_step']}")
            row["split"] = split = gan_split(step, g_opt, d_opt, *batches[-1])
            log("  one more step: " + ", ".join(f"{k[:-3].replace('_', ' ')} {v:.1f} ms"
                                               for k, v in split.items()) + " (CUDA events)")
            log("[profile] one float32 GAN step")
            prof = profile_call(lambda: step(*batches[-1]), warm=False)
            row["profile"] = dict(prof, idle_share_of_median=1 - prof["busy_ms"] / med)
        del g, d, perceptual, step, g_opt, d_opt
        torch.cuda.empty_cache()
    summary["plain_over_kernels"] = summary["plain"]["median_ms"] / summary["kernels"]["median_ms"]
    log(f"  plain path / kernel path GAN step time: {summary['plain_over_kernels']:.2f}x")
    return summary


def lpips_file(path) -> None:
    """Random LPIPSVgg weights (its heads non-negative, as lpips's), seeded,
    written where ``lpips_weights_path`` reads them: the repo holds no
    pretrained LPIPS."""
    import torch
    from sisr_tpu_torch.models.vgg import LPIPSVgg

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        lp = LPIPSVgg()
    with torch.no_grad():
        for i in range(5):
            getattr(lp, f"lin{i}").model[1].weight.abs_()
    torch.save(lp.state_dict(), path)


def check_gan_files(root, exp, failures: list) -> dict:
    """The GAN run's logs and both checkpoints parse back: loss and d_loss
    each epoch, the lr log's discriminator_lr, a real LPIPS value each
    eval (not the 1.0 sentinel), the generator's and the discriminator's
    checkpoints at the last epoch (the discriminator's with its u, v)."""
    import torch

    logs = root / exp.model_config.log_folder
    weights = root / exp.model_config.checkpoint_folder
    epochs = exp.model_config.epochs

    def rows(name):
        return [line.split() for line in (logs / name).read_text().splitlines()
                if line.strip()]

    parsed = {}
    try:
        loss = rows("loss_log.txt")
        parsed["loss"] = [(float(r[1].split(":")[1]), float(r[2].split(":")[1])) for r in loss]
        lrs = [" ".join(r) for r in rows("lr_log.txt")]
        parsed["lr_log"] = lrs
        metrics = rows("psnr_ssim_lpips_log.txt")
        parsed["psnr_ssim_lpips"] = [tuple(float(v) for v in r[1:4]) for r in metrics]
        ok = ([r[0] for r in loss] == [f"epoch:{e:05d}" for e in range(1, epochs + 1)]
              and all(r[2].startswith("d_loss:") for r in loss)
              and all(math.isfinite(v) for r in parsed["loss"] for v in r)
              and all("discriminator_lr:" in r for r in lrs[1:]) and len(lrs) == epochs + 1
              and [r[0] for r in metrics] == [r[0] for r in loss]
              and all(math.isfinite(v) for r in parsed["psnr_ssim_lpips"] for v in r)
              and all(r[2] != 1.0 for r in parsed["psnr_ssim_lpips"]))
        if not ok:
            failures.append(f"gan runner logs: {parsed}")
        for name, model in (("new_epoch_model.pth", exp.model),
                            ("discriminator_new_epoch_model.pth", exp.discriminator)):
            dic = torch.load(weights / name, map_location="cpu", weights_only=True)
            if (set(dic) != {"start_epoch", "model", "optimizer"} or dic["start_epoch"] != epochs
                    or set(dic["model"]) != set(model.state_dict())
                    or not dic["optimizer"]["state"]):
                failures.append(f"gan runner checkpoint {name}: {set(dic)}, epoch "
                                f"{dic.get('start_epoch')}")
        parsed["d_has_uv"] = "conv1.weight_u" in exp.discriminator.state_dict()
    except (OSError, ValueError, IndexError, KeyError):
        failures.append(f"gan runner logs or checkpoints: {traceback.format_exc()}")
    return parsed


def run_gan_runner(failures: list, card: str) -> dict:
    """``python -m sisr_tpu_torch hitsir_pro_gan``'s experiment (the full
    flagship in float32, UNetDiscriminatorSN(64), a random VGG19, batch 2,
    crop 64, two spawned loader workers; LPIPS from random weights the
    phase writes) on the runner's folders under build/smoke/gan: 1 epoch,
    the same command resumed to epoch 2 (from the discriminator's
    checkpoint: both models, both optimizers' state, the lr), then test
    mode.  Every train step launches what a GAN step does, every eval and
    test image what its route does; the last eval's SRs within 1e-3 of the
    plain model."""
    import os
    import shutil
    from pathlib import Path

    import torch
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.__main__ import experiment_kwargs, main as port_main, parse_args
    from sisr_tpu_torch.configs.model_config import get_scheduler
    from sisr_tpu_torch.ops.kernels import build

    root = Path(__file__).resolve().parent / "build" / "smoke" / "gan"
    shutil.rmtree(root, ignore_errors=True)
    runner_folders(root)
    lpips_path = root / "lpips_vgg.pth"
    lpips_file(lpips_path)
    kw = experiment_kwargs(parse_args(
        ["hitsir_pro_gan", "--epochs", "1", "--train-sets", "setA", "--eval-sets", "setB",
         "--test-sets", "setB"]))
    kw.update(progress=False, eval_band_area=RUNNER_BAND_AREA, run=False,
              lpips_weights_path=str(lpips_path))
    rec = dict(train=[], steps=[], eval=[], images=[], evals=[])
    want_step = {k: PER_STEP.get(k, 0) for k in build.launches}
    summary = dict(card=card)
    cwd = os.getcwd()
    os.chdir(root)
    exps = []
    try:
        exp = port_main("hitsir_pro_gan", **kw)
        exps.append(exp)
        infer.synth_weights(exp.model, seed=0)
        instrument(exp, rec)
        for loader in exp.train_loaders:
            loader._ensure_pool()
        t0 = time.perf_counter()
        exp.run()
        summary["first_run_s"] = time.perf_counter() - t0
        check_images(exp, rec["images"], failures, "gan eval epoch 1", False, card)

        kw.update(epochs=2)
        resumed = port_main("hitsir_pro_gan", **kw)
        exps.append(resumed)

        def same(a, b):
            return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

        def same_opt(a, b):
            sa, sb = a.state_dict()["state"], b.state_dict()["state"]
            return sa.keys() == sb.keys() and len(sa) > 0 and all(same(sa[i], sb[i]) for i in sa)

        checks = dict(
            epoch=resumed.start_epoch == 2,
            generator=same(exp.model.state_dict(), resumed.model.state_dict()),
            discriminator=same(exp.discriminator.state_dict(),
                               resumed.discriminator.state_dict()),
            g_optimizer=same_opt(exp.state.optimizer, resumed.state.optimizer),
            d_optimizer=same_opt(exp.d_state.optimizer, resumed.d_state.optimizer),
            lr=(resumed.state.optimizer.param_groups[0]["lr"]
                == resumed.d_state.optimizer.param_groups[0]["lr"]
                == get_scheduler(2e-5, 1e-7, 2)(1)))
        log(f"  resume: {checks}")
        if not all(checks.values()):
            failures.append(f"gan runner resume: {checks}")
        exp.close()
        exps.remove(exp)
        del exp
        instrument(resumed, rec)
        for loader in resumed.train_loaders:
            loader._ensure_pool()
        resumed.run()
        check_images(resumed, rec["images"], failures, "gan eval epoch 2", True, card)
        summary["logs"] = check_gan_files(root, resumed, failures)

        kw.update(is_test=True)
        tested = port_main("hitsir_pro_gan", **kw)
        exps.append(tested)
        instrument(tested, rec)
        rec["images"], t0 = [], time.perf_counter()
        tested.run()
        summary["test_s"] = time.perf_counter() - t0
        check_images(tested, rec["images"], failures, "gan test", False, card)
        tlog = (Path(tested.result_path) / "setB" / "test_log.txt").read_text().split()
        summary["test"] = [float(c.split(":")[1]) for c in tlog[:3]]
        if not (all(math.isfinite(v) for v in summary["test"]) and summary["test"][2] != 1.0):
            failures.append(f"gan runner test stage: {tlog}")
    finally:
        for e in exps:
            e.close()
        os.chdir(cwd)

    bad = [s for s in rec["steps"] if s != want_step]
    if bad or not rec["steps"]:
        failures.append(f"gan runner: {len(bad)} of {len(rec['steps'])} train steps launch "
                        f"otherwise than a GAN step's {PER_STEP}: {bad[:1]}")
    summary["epochs"] = [dict(epoch=tr["epoch"], train_s=tr["s"], steps=tr["steps"],
                              loader_wait_s=tr["loader_wait_s"], step_s=tr["step_s"],
                              checkpoint_s=tr["save_s"], g_loss=tr["loss"], eval_s=ev["s"],
                              eval_infer_s=ev["infer_s"], eval_metrics_s=ev["metrics_s"],
                              eval_checkpoint_s=ev["save_s"])
                         for tr, ev in zip(rec["train"], rec["eval"])]
    for row in summary["epochs"]:
        log(f"  GAN epoch {row['epoch']}: train {row['train_s']:.3f} s ({row['steps']} steps: "
            f"{row['step_s']:.3f} s in steps, {row['loader_wait_s']:.3f} s waiting on the "
            f"loader, generator checkpoint {row['checkpoint_s']:.3f} s), eval "
            f"{row['eval_s']:.3f} s (inference {row['eval_infer_s']:.3f} s, metrics with "
            f"LPIPS {row['eval_metrics_s']:.3f} s, best checkpoints "
            f"{row['eval_checkpoint_s']:.3f} s), g_loss {row['g_loss']:.5f} [{card}]")
    log(f"  GAN test stage: {summary['test_s']:.2f} s for {len(RUNNER_EVAL)} images, Y-PSNR "
        f"{summary['test'][0]:.4f} dB, SSIM {summary['test'][1]:.5f}, LPIPS "
        f"{summary['test'][2]:.5f} [{card}]")
    return summary


LPIPS_IMAGE = (256, 320)


def run_lpips(failures: list, card: str) -> dict:
    """``python -m sisr_tpu_torch.lpips``'s function (``calculate_lpips``)
    on two synthesized PNGs with the random LPIPS weights of ``lpips_file``:
    on the card against the CPU (float32, TF32 off, 1e-5 relative); the
    self-LPIPS 0; the card's call timed."""
    import shutil
    from pathlib import Path

    import numpy as np
    from PIL import Image
    from sisr_tpu_torch import lpips

    root = Path(__file__).resolve().parent / "build" / "smoke" / "lpips"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.default_rng(3)
    paths = [str(root / f"im{i}.png") for i in range(2)]
    for path in paths:
        Image.fromarray((rng.random((*LPIPS_IMAGE, 3)) * 255).astype(np.uint8)).save(path)
    weights = str(root / "lpips.pth")
    lpips_file(weights)
    got = lpips.calculate_lpips(*paths, weights, device="cuda")
    cpu = lpips.calculate_lpips(*paths, weights, device="cpu")
    self_lpips = lpips.calculate_lpips(paths[0], None, weights, device="cuda")
    model = lpips.lpips_model(weights, "cuda")
    a, b = (lpips.load_image(p) for p in paths)
    ms = time_ms(lambda: lpips.lpips_of(model, a, b))
    rel = abs(got - cpu) / abs(cpu)
    ok = rel <= 1e-5 and self_lpips == 0.0
    log(f"  lpips {LPIPS_IMAGE[0]}x{LPIPS_IMAGE[1]}: card {got:.8f}, CPU {cpu:.8f} (rel {rel:.2e}, "
        f"bar 1e-5), self {self_lpips}; {ms:.2f} ms a pair on the card (float32, TF32 off) "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        failures.append(f"lpips on the card {got} against the CPU {cpu}, self {self_lpips}")
    return dict(card_value=got, cpu_value=cpu, rel_err=rel, self_lpips=self_lpips, ms=ms)


def run_gan(failures: list, card: str) -> dict:
    """The GAN phase: the step's check against the plain path, its times,
    then the runner.  Returns the launches of the timed steps and the
    runner (the check's launches compare the kernels with the plain path
    and are not counted)."""
    from sisr_tpu_torch.ops.kernels import build

    summary = dict(check=run_gan_check(failures, card))
    build.reset_launches()
    summary["step"] = run_gan_steps(failures, card)
    summary["runner"] = run_gan_runner(failures, card)
    counts = dict(build.launches)
    summary["lpips"] = run_lpips(failures, card)
    summary["launches"] = counts
    log(f"  launches over the GAN steps and the runner: {counts}")
    log(json.dumps({"gan": summary}))
    return counts


# --- the UNet and Dense families, HiTSIR's options, the library ops ----------

# the families at their experiments' defaults (dense_experiment.py,
# unet_experiment.py); a Dense forward runs the Fusion gate once, a UNet
# forward no kernel (JAX computes its convs, norms and attention outside
# Pallas)
DENSE_DEFAULTS = dict(is_sa_attn=True, is_fusion=True, is_mult_size_conv_feat_extract=True,
                      num_blocks=(4, 4), skip_blocks=(0,), middle_channels=DENSE_C)
PER_FORWARD = {"dense": {"fusion_pools": 1, "fused_fusion": 1}, "unet": {}}
# the families' runner folders: 4 train images (2 steps an epoch) and one
# eval and one test image of LR 96x120 (the UNet's attention holds an L x L
# score matrix, as JAX's: 0.53 GB in float32 at 11,520 tokens)
FAMILY_TRAIN = ((320, 320),) * 4
FAMILY_EVAL = ((384, 480),)
# HiTSIR's options, one float32 training step each on the flagship: the
# launches a step makes against PER_STEP's.  drop_path's linspace leaves
# the first of the 36 blocks at rate 0, so its tail keeps the kernel (and
# its backward's two dwconv5x5 launches); the others' tails run plain.
# 3conv turns the six RHTB convs plain; use_checkpoint runs each block's
# scc_block and htb_tail again in the backward
OPTIONS = (("drop_path_rate=0.1", dict(drop_path_rate=0.1),
            dict(htb_tail=1, dwconv5x5=2)),
           ("ape, img_size=64", dict(ape=True, img_size=TRAIN_LR), {}),
           ("resi_connection='3conv'", dict(resi_connection="3conv"), dict(conv3x3=3)),
           ("use_checkpoint", dict(use_checkpoint=True), dict(scc_block=72, htb_tail=72)))


def family_model(family: str, dtype: str = "float32"):
    """The family at its experiment's defaults on the card, flax's
    initialization drawn from seed 0 as the experiment draws it."""
    import torch
    from sisr_tpu_torch.models.dense_sr import DenseSR
    from sisr_tpu_torch.models.unet_sr import UNetSR

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DenseSR(**DENSE_DEFAULTS) if family == "dense" else UNetSR()
    model.dtype = getattr(torch, dtype)
    return model.to("cuda")


def family_want(family: str) -> dict:
    from sisr_tpu_torch.ops.kernels import build

    return {k: PER_FORWARD[family].get(k, 0) for k in build.launches}


def fusion_fault():
    """The Dense check's control: ``pack_params`` with one tap of the gate
    UA's H-pool conv (packed ``c2w[1, 2]``) 2^-8 relative too large, for as
    long as the context lasts.  The kernel reads it in the forward; the
    backward (the plain version's vjp from the raw weights) does not."""
    from sisr_tpu_torch.models import hit_sir_pro

    sound = hit_sir_pro.pack_params

    def faulty(raws, c, dt):
        packed = list(sound(raws, c, dt))
        packed[1] = packed[1].clone()
        packed[1][1, 2] *= 1 + 2.0 ** -8
        return tuple(packed)

    return _swapped(hit_sir_pro, "pack_params", faulty)


@contextlib.contextmanager
def _swapped(owner, name: str, value):
    sound = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, sound)


def _whole_model_bars(out, ref) -> tuple:
    """(max abs, rms, ok) of a float32 output against the plain model's:
    ``test_model_parity.py``'s 1e-3 and 5e-5."""
    err = (out.float() - ref.float()).abs()
    mx, rms = float(err.max()), float(err.square().mean().sqrt())
    return mx, rms, mx < 1e-3 and rms < 5e-5


def run_dense_check(failures: list, card: str) -> dict:
    """DenseSR's training step, kernel path against the plain path from the
    same weights and batch (float32, TF32 off): the L1 loss within 1e-5
    relative, every gradient within its bar (``gradient_agreement``), the
    step's SR at the whole-model bars; as the control, the same step with
    ``fusion_fault`` must fail them (the gradients see a forward fault of the
    gate only through L1's signs: the loss and SR bars carry it).  Then a
    192x192 tile in float32 (whole-model bars) and bfloat16 (min(44, plain
    bfloat16 - 3) dB) against the float32 plain model, its launches checked."""
    import torch
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.utils.precision import exact_mode

    kernel, plain = family_model("dense"), family_model("dense")
    res = gradient_agreement(kernel, plain, *train_batches(1, seed=3)[0],
                             faults={"fusion-tap": fusion_fault},
                             make=lambda: family_model("dense"))
    mx, rms, sr_ok = _whole_model_bars(res["sr_kernels"], res["sr_plain"])
    worst = max(res["rows"], key=lambda r: r["err"])
    ok = res["loss_err"] <= 1e-5 and not res["bad"] and sr_ok
    log(f"  Dense step: L1 loss {res['loss_kernels']:.7f} vs plain {res['loss_plain']:.7f} "
        f"(rel {res['loss_err']:.2e}, bar 1e-5); {len(res['rows'])} gradients, worst "
        f"{worst['err']:.2e} ({worst['name']}, bar {worst['bar']:.2e}), {len(res['bad'])} over "
        f"their bar; SR max abs {mx:.2e}, rms {rms:.2e} {'ok' if ok else 'FAIL'} [{card}]")
    c = res["controls"]["fusion-tap"]
    cmx, crms, c_sr_ok = _whole_model_bars(c["sr"], res["sr_plain"])
    rejected = bool(c["bad"]) or c["loss_err"] > 1e-5 or not c_sr_ok
    log(f"  control, Fusion gate packed c2w[1, 2] x (1 + 2^-8): loss rel {c['loss_err']:.2e}, "
        f"{len(c['bad'])} gradients over their bar, SR max abs {cmx:.2e}, rms {crms:.2e} "
        f"{'rejected' if rejected else 'FAIL: the check passes it'}")
    if not (ok and rejected):
        failures.append("Dense training step against the plain path, or its control")
    summary = dict(loss_err=res["loss_err"], worst_grad=worst, grads_over=len(res["bad"]),
                   sr_max_abs=mx, sr_rms=rms,
                   control=dict(loss_err=c["loss_err"], grads_over=len(c["bad"]),
                                sr_max_abs=cmx, sr_rms=crms, rejected=rejected))
    del kernel, plain
    g = torch.Generator(device="cuda").manual_seed(2)
    tile = torch.rand((1, TILE, TILE, 3), generator=g, device="cuda")
    models = {dt: family_model("dense", dt).eval() for dt in ("float32", "bfloat16")}
    want = family_want("dense")
    with torch.inference_mode():
        outs = {}
        for dt, model in models.items():
            before = dict(build.launches)
            outs[dt] = model(tile).float()
            got = {k: build.launches[k] - before[k] for k in build.launches}
            if got != want or not bool(torch.isfinite(outs[dt]).all()):
                failures.append(f"Dense {dt} tile: launches {got} or not finite")
        with exact_mode():
            ref = on_plain(models["float32"])(tile)
            p16 = on_plain(models["bfloat16"])(tile).float()
    mx, rms, ok32 = _whole_model_bars(outs["float32"], ref)
    db16, db_plain = _psnr_db(outs["bfloat16"], ref), _psnr_db(p16, ref)
    bar16 = min(44.0, db_plain - 3.0)
    ok = ok32 and db16 >= bar16
    log(f"  Dense {TILE}x{TILE} tile: f32 vs plain max abs {mx:.3e} (bar 1e-3), rms {rms:.3e} "
        f"(bar 5e-5); bf16 {db16:.2f} dB (bar {bar16:.2f}; plain bf16 {db_plain:.2f}) "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        failures.append("Dense tile against the plain model")
    summary["tile"] = dict(max_abs=mx, rms=rms, db_bf16=db16, db_plain_bf16=db_plain)
    return summary


def run_unet_check(failures: list, card: str) -> dict:
    """UNetSR at its defaults: the card's float32 forward of the training
    batch (2, 64, 64, 3) against the CPU's, TF32 off, within 1e-4 max abs;
    no kernel launched."""
    import torch
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.utils.precision import exact_mode

    model = family_model("unet").eval()
    lr_img = train_batches(1, seed=6)[0][0]
    before = dict(build.launches)
    with torch.inference_mode(), exact_mode():
        got = model(lr_img).cpu()
        want = model.to("cpu")(lr_img.cpu())
    err = float((got - want).abs().max())
    ok = err <= 1e-4 and dict(build.launches) == before and bool(torch.isfinite(got).all())
    log(f"  UNet float32 forward, LR {TRAIN_BATCH}x{TRAIN_LR}x{TRAIN_LR}: card vs CPU max abs "
        f"{err:.2e} (bar 1e-4), no launch {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        failures.append("UNet forward on the card against the CPU")
    return dict(max_abs_vs_cpu=err)


def run_library_ops(failures: list, card: str) -> dict:
    """deform_conv2d (v1, v2), deform_attn and upfirdn2d on the card
    against the CPU, float32 (TF32 off), at ``test_deform.py``'s and
    ``test_aux_ops.py``'s shapes, within 1e-5."""
    import torch
    from sisr_tpu_torch.ops.deform import deform_attn, deform_conv2d
    from sisr_tpu_torch.ops.stylegan_ops import upfirdn2d
    from sisr_tpu_torch.utils.precision import exact_mode

    g = torch.Generator().manual_seed(7)
    rn = lambda *s: torch.randn(*s, generator=g)
    x, w, b = rn(2, 7, 6, 4), rn(3, 3, 4, 5) * 0.3, rn(5)
    off, mask = rn(2, 7, 6, 18) * 1.5, torch.rand(2, 7, 6, 9, generator=g)
    q, kv, aoff = rn(1, 5, 6, 8), rn(1, 2, 5, 6, 16), rn(1, 2, 5, 6, 36) * 1.5
    img, fir = rn(2, 7, 9, 3), rn(4, 4)
    cases = {"deform_conv2d v2": lambda d: deform_conv2d(x.to(d), off.to(d), w.to(d), b.to(d),
                                                         mask.to(d)),
             "deform_conv2d v1": lambda d: deform_conv2d(x.to(d), off.to(d), w.to(d), b.to(d)),
             "deform_attn": lambda d: deform_attn(q.to(d), kv.to(d), aoff.to(d),
                                                  attention_heads=2, deformable_groups=2),
             "upfirdn2d": lambda d: upfirdn2d(img.to(d), fir.to(d), up=2, down=1, pad=(2, 1))}
    errs = {}
    with exact_mode():
        for name, fn in cases.items():
            errs[name] = float((fn("cuda").cpu() - fn("cpu")).abs().max())
    ok = all(e <= 1e-5 for e in errs.values())
    log(f"  library ops, card vs CPU max abs: "
        f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (bar 1e-5) "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        failures.append(f"library ops on the card against the CPU: {errs}")
    return errs


def run_family_steps(failures: list, card: str) -> dict:
    """Each family at its defaults through ``make_train_step`` (L1, Adam 2e-5,
    betas (0.9, 0.99)), float32, batch 2, LR 64 -> HR 256: 2 warm + 5 timed
    steps (median and min ms, LR MP/s, peak memory after collecting the
    earlier phases' garbage, with what stays allocated before the steps),
    every launch counter checked per step (Dense: fusion_pools and
    fused_fusion once; UNet: none), then one step split by CUDA events and
    one profiled
    (``profile_step``: device busy, idle share); Dense's plain path too, as
    a yardstick, and Dense in bfloat16 (the gate's kernels under autograd
    in bfloat16)."""
    import gc
    import statistics

    import torch
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    summary = {}
    mp = TRAIN_BATCH * TRAIN_LR * TRAIN_LR / 1e6
    for family, plain, dt in (("dense", False, "float32"), ("dense", True, "float32"),
                              ("unet", False, "float32"), ("dense", False, "bfloat16")):
        label = f"{family}{' plain' if plain else ''}{' bf16' if dt != 'float32' else ''}"
        model = family_model(family, dt)
        opt = adam(model)
        step = on_plain(make_train_step(model, l1_loss, opt), plain)
        batches = train_batches(TRAIN_WARM + TRAIN_STEPS, seed=0)
        for lr_img, hr_img in batches[:TRAIN_WARM]:
            step(lr_img, hr_img)
        torch.cuda.synchronize()
        # the peak counts every live tensor: collect the earlier phases' garbage
        # first, and record what stays allocated besides this family's steps
        gc.collect()
        base = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        want = {k: 0 for k in build.launches} if plain else family_want(family)
        ms, losses = [], []
        for lr_img, hr_img in batches[TRAIN_WARM:]:
            before = dict(build.launches)
            t0 = time.perf_counter()
            loss = step(lr_img, hr_img)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            got = {k: build.launches[k] - before[k] for k in build.launches}
            if got != want or not math.isfinite(losses[-1]):
                failures.append(f"{label} step: loss {losses[-1]}, launches {got}, want {want}")
        med = statistics.median(ms)
        summary[label] = dict(params=sum(p.numel() for p in model.parameters()), median_ms=med,
                              min_ms=min(ms), runs_ms=ms, lr_mp_per_s=mp / (med / 1e3),
                              peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                              allocated_before_gib=base, losses=losses)
        log(f"  {label:11s} {summary[label]['params']:,} params, {TRAIN_STEPS} steps (batch "
            f"{TRAIN_BATCH}, LR {TRAIN_LR} -> HR {4 * TRAIN_LR}, {dt}): median {med:.1f} ms, "
            f"min {min(ms):.1f} ms, {summary[label]['lr_mp_per_s']:.4f} LR MP/s, peak "
            f"{summary[label]['peak_gib']:.2f} GiB ({base:.2f} allocated before the steps), "
            f"L1 {', '.join(f'{v:.5f}' for v in losses)} [{card}]")
        if not plain:
            split = summary[label]["split"] = profile_step(model, opt, *batches[-1])
            split["idle_share_of_median"] = 1 - split["busy_ms"] / med
            log(f"  {label}: device busy {split['busy_ms']:.1f} ms against the {med:.1f} ms "
                f"median step: {100 * split['idle_share_of_median']:.1f}% idle")
        del model, opt, step
        torch.cuda.empty_cache()
    return summary


def run_family_runners(failures: list, card: str) -> dict:
    """``main("dense", ...)`` and ``main("unet", ...)`` of the port (the
    families' experiments at their defaults: float32, batch 2, crop 64,
    two spawned loader workers) on folders synthesized under
    build/smoke/families: 1 epoch, then test mode.  Every step and every
    eval and test image launches what a forward of the family does; the
    eval SR (whole image, LR 96x120) within 1e-3 of the plain model; the
    logs and checkpoints parsed back."""
    import os
    import shutil
    from pathlib import Path

    import numpy as np
    import torch
    from sisr_tpu_torch.__main__ import main as port_main
    from sisr_tpu_torch.utils.precision import exact_mode

    root = Path(__file__).resolve().parent / "build" / "smoke" / "families"
    shutil.rmtree(root, ignore_errors=True)
    runner_folders(root, FAMILY_TRAIN, FAMILY_EVAL)
    summary = {}
    cwd = os.getcwd()
    os.chdir(root)
    exps = []
    try:
        for family in ("dense", "unet"):
            kw = dict(epochs=1, train_data_name_list=["setA"], eval_data_name_list=["setB"],
                      test_data_name_list=["setB"], progress=False, run=False)
            rec = dict(train=[], steps=[], eval=[], images=[], evals=[])
            exp = port_main(family, is_test=False, **kw)
            exps.append(exp)
            instrument(exp, rec)
            t0 = time.perf_counter()
            for loader in exp.train_loaders:
                loader._ensure_pool()
            loader_s = time.perf_counter() - t0
            exp.run()
            want = family_want(family)
            bad = [s for s in rec["steps"] if s != want]
            for im in rec["images"]:
                x = torch.from_numpy(im["lr"]).to(exp.device)
                with torch.inference_mode(), exact_mode():
                    ref = on_plain(exp.model)(x).clamp(0, 1).float().cpu().numpy()
                im["err"] = float(np.abs(ref - im["sr"]).max())
            ok = (not bad and rec["steps"] and all(im["launches"] == want and im["err"] <= 1e-3
                                                  for im in rec["images"])
                  and math.isfinite(exp.epoch_loss.avg))
            logs = root / exp.model_config.log_folder
            row = [r.split() for r in (logs / "psnr_ssim_lpips_log.txt").read_text().splitlines()]
            ck = torch.load(root / exp.model_config.checkpoint_folder / "new_epoch_model.pth",
                            map_location="cpu", weights_only=True)
            ok = ok and set(ck["model"]) == set(exp.model.state_dict()) and len(row) == 1
            exp.close()
            exps.remove(exp)
            tested = port_main(family, is_test=True, **kw)
            exps.append(tested)
            instrument(tested, rec)
            rec["images"], t0 = [], time.perf_counter()
            tested.run()
            test_s = time.perf_counter() - t0
            tlog = (Path(tested.result_path) / "setB" / "test_log.txt").read_text().split()
            test = [float(c.split(":")[1]) for c in tlog[:2]]
            ok = ok and all(im["launches"] == want for im in rec["images"]) and all(
                math.isfinite(v) for v in test) and len(rec["images"]) == len(FAMILY_EVAL)
            tr, ev = rec["train"][0], rec["eval"][0]
            summary[family] = dict(loader_start_s=loader_s, train_s=tr["s"], steps=tr["steps"],
                                   step_s=tr["step_s"], loader_wait_s=tr["loader_wait_s"],
                                   train_checkpoint_s=tr["save_s"], loss=tr["loss"],
                                   eval_s=ev["s"], eval_infer_s=ev["infer_s"],
                                   eval_checkpoint_s=ev["save_s"],
                                   eval_psnr_ssim=[float(v) for v in row[0][1:3]],
                                   eval_sr_vs_plain=max(im.get("err", 0.0)
                                                        for im in rec["evals"][0]),
                                   test_s=test_s, test_psnr_ssim=test)
            log(f"  main({family!r}): train {tr['s']:.3f} s ({tr['steps']} steps, {tr['step_s']:.3f}"
                f" s in steps, {tr['loader_wait_s']:.3f} s waiting on the loader, checkpoint "
                f"{tr['save_s']:.3f} s), eval {ev['s']:.3f} s (inference {ev['infer_s']:.3f} s, "
                f"SR vs plain {summary[family]['eval_sr_vs_plain']:.2e}), test {test_s:.2f} s "
                f"(Y-PSNR {test[0]:.4f} dB, SSIM {test[1]:.5f}); L1 {tr['loss']:.5f}; loader "
                f"start {loader_s:.2f} s {'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                failures.append(f"main({family!r}): steps {bad[:1]}, images "
                                f"{[(im['launches'], im.get('err')) for im in rec['evals'][0]]}")
            tested.close()
            exps.remove(tested)
    finally:
        for e in exps:
            e.close()
        os.chdir(cwd)
    return summary


def run_options(failures: list, card: str) -> dict:
    """HiTSIR's options on the flagship (default init, seed 0), one float32
    training step each through ``make_train_step``: finite, and launching
    PER_STEP with ``OPTIONS``' changes (the routing rule: in training,
    drop-path runs a tail plain, 3conv its convs plain)."""
    import torch
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    lr_img, hr_img = train_batches(1, seed=8)[0]
    summary = {}
    for label, over, change in OPTIONS:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = HiTSIR(**flagship_config(), **over)
        model = model.to("cuda")
        step = make_train_step(model, l1_loss, adam(model))
        before = dict(build.launches)
        t0 = time.perf_counter()
        loss = float(step(lr_img, hr_img))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        got = {k: build.launches[k] - before[k] for k in build.launches}
        want = {k: change.get(k, PER_STEP.get(k, 0)) for k in build.launches}
        ok = got == want and math.isfinite(loss)
        summary[label] = dict(loss=loss, first_step_s=s, launches={k: v for k, v in got.items()
                                                                    if v})
        log(f"  flagship, {label}: L1 {loss:.5f}, first step {s:.2f} s, launches "
            f"{'as the routing rule says' if ok else f'{got}, want {want}'} "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            failures.append(f"flagship {label}: loss {loss}, launches {got}, want {want}")
        del model, step
        torch.cuda.empty_cache()
    return summary


def run_families(failures: list, card: str) -> dict:
    """The families phase: the checks (Dense's step and tiles, the UNet on
    the card against the CPU, the library ops), then the main path with
    the counts at 0: the families' timed steps, their runners, HiTSIR's
    options.  Returns the main path's launches."""
    from sisr_tpu_torch.ops.kernels import build

    summary = dict(dense_check=run_dense_check(failures, card),
                   dense_bf16_check=bf16_step_check(
                       failures, lambda: family_model("dense", "bfloat16"), "Dense", card=card),
                   unet_check=run_unet_check(failures, card),
                   library_ops=run_library_ops(failures, card))
    build.reset_launches()
    summary["steps"] = run_family_steps(failures, card)
    summary["runners"] = run_family_runners(failures, card)
    summary["options"] = run_options(failures, card)
    counts = dict(build.launches)
    summary["launches"] = counts
    log(f"  launches over the families' steps, runners and the options' steps: {counts}")
    log(json.dumps({"families": summary}))
    return counts


# --- the multi-device layer: sharded tiles and bands, data parallelism -------

# (a) NCCL at world size 1 in one spawned rank; (b) and (c) two gloo ranks
# that share the card (NCCL refuses two ranks on one device): correctness
# and the collectives' cost, not scaling
MESH_TILES = (480, 640)           # 12 tiles of 192: 6 a rank on two ranks
MESH_BANDS = (256, 320)           # align 4, bands of 64: 4, 2 a rank
# the 1080p frame at align 64, band_rows 120: sharded_plan's 16 bands of
# 68 (not plan()'s 8 of 136), 8 a rank
MESH_FRAME_BANDS = 16
MESH_STEPS = 3
MESH_TRAIN = ((320, 320),) * 2    # the DP runner: 1 step of batch 2, 1 image a rank
MESH_EVAL = ((384, 480),)         # LR 96x120: the whole forward
MESH_KERNELS = RUNNER_KERNELS
# a sharded call against the single-process call: float32 within 1e-5
# (JAX's bar); bfloat16 within 2^-5 of the output's scale: two calls of
# the single-process bfloat16 path already differ by up to 1.56e-2 on an
# NVIDIA H100 80GB HBM3 at 700 W (htb_tail's wgmma stats sum with float
# atomics, and a last-bit move grows through 36 blocks), so 2^-6 would fail
# on that alone
MESH_BARS = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
# the DP step with every dropout of HiTSIR on (drop, value drop, drop-path),
# its masks from a CUDA generator seeded alike on every rank: in training the
# value dropout runs every SCC plain, the dropouts every tail plain (JAX's
# routing), so the step launches the convs, the head and the Fusion gate
MESH_RATES = dict(drop_rate=0.1, value_drop_rate=0.1, drop_path_rate=0.1)
MESH_DROP_SEED = 17
MESH_DROP_WANT = {"conv3x3": 9, "conv3x3_shuffled": 1, "conv3x3_shuffled_tail": 1,
                  "fusion_pools": 1, "fused_fusion": 1}


@contextlib.contextmanager
def exact_deterministic():
    """TF32 off (``exact_mode``) and cuDNN's deterministic algorithms: the
    same inputs give the same bits in every process."""
    import torch
    from sisr_tpu_torch.utils.precision import exact_mode

    with exact_mode(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                  deterministic=True, allow_tf32=False):
        yield


def drop_grads(model, lr_img, hr_img, rng, plain: bool = False) -> tuple:
    """The L1 loss and every gradient of one training forward of ``model``
    (on the plain versions where ``plain``) whose dropout masks come from
    ``rng`` (``make_train_step``'s forward)."""
    from sisr_tpu_torch.train.losses import l1_loss

    model.zero_grad(set_to_none=True)
    loss = l1_loss(on_plain(model, plain)(lr_img, deterministic=False, generator=rng),
                   hr_img)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()
                                  if p.grad is not None}


def mesh_reference(root) -> None:
    """What every rank loads from ``root``: the flagship's float32 weights
    (param_synth seed 0), the inputs, and the single-process training step
    (kernel path, TF32 off, cuDNN deterministic): on the whole batch its
    loss and each gradient, with each gradient's bar as
    ``gradient_agreement`` sets it (max(1e-3, NOISE_MULT x the plain path's
    largest move under ``probe_grads``' moves and under the batch split
    the ranks make: the mean of the per-image gradients)); and the mean of
    the kernel path's per-image gradients, which the ranks' averaged
    gradients must equal.  The same two for the step with ``MESH_RATES``'
    dropouts from a generator seeded ``MESH_DROP_SEED``: on the whole batch
    (one process draws every mask), and per image with the masks of that
    image's rows of the batch's draw (``DropoutRng(g, i, 2)``), with its
    bars set as the step's: the plain path's largest move, with the same
    masks, under ``probe_grads``' moves and that batch split."""
    import torch
    from sisr_tpu_torch.ops.dropout import DropoutRng

    model = train_model()
    g = torch.Generator().manual_seed(5)
    batch = tuple(t.cpu() for t in train_batches(1, 7)[0])
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, root / "flagship.pt")
    torch.save(dict(tiles=torch.rand((*MESH_TILES, 3), generator=g),
                    bands=torch.rand((*MESH_BANDS, 3), generator=g),
                    frame=torch.rand((*FRAME, 3), generator=g), batch=batch),
               root / "inputs.pt")
    lr, hr = (t.cuda() for t in batch)
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    split = lambda m, plain: [step_grads(m, lr[i:i + 1], hr[i:i + 1], plain)[1]
                              for i in range(TRAIN_BATCH)]
    mean = lambda gs: {k: None if gs[0][k] is None else sum(g[k] for g in gs) / len(gs)
                       for k in gs[0]}
    with exact_deterministic():
        loss, grads, _ = step_grads(model, lr, hr, False)
        split_mean = mean(split(model, False))
        plain = train_model()
        _, ref, _ = step_grads(plain, lr, hr, True)
        moved = probe_grads(plain, lr, hr) + [mean(split(plain, True))]
    noise = {k: max(rel(m[k], r) for m in moved) for k, r in ref.items() if r is not None}
    cpu = lambda gs: {k: g.cpu() for k, g in gs.items() if g is not None}
    drop = mesh_model(model.state_dict(), "float32", **MESH_RATES).train()
    seeded = lambda: torch.Generator(device="cuda").manual_seed(MESH_DROP_SEED)
    with exact_deterministic():
        drop_loss, drop_all = drop_grads(drop, lr, hr, seeded())
        halves = {}
        for plain in (False, True):
            halves[plain] = mean([drop_grads(drop, lr[i:i + 1], hr[i:i + 1],
                                             DropoutRng(seeded(), i, 2), plain)[1]
                                  for i in range(TRAIN_BATCH)])
        whole_plain = drop_grads(drop, lr, hr, seeded(), True)[1]
        drop_moved = [halves[True]] + [drop_grads(drop, x, hr, seeded(), True)[1] for x in (
            _ulp_move(lr, 11), _ulp_move(lr, 12), lr * (1 + 1e-6))]
        shifted = mesh_model(model.state_dict(), "float32", **MESH_RATES).train()
        for seed in (13, 14):
            with torch.no_grad():
                for i, (p, q) in enumerate(zip(shifted.parameters(), drop.parameters())):
                    p.copy_(_ulp_move(q, seed * 1000 + i))
            drop_moved.append(drop_grads(shifted, lr, hr, seeded(), True)[1])
    drop_noise = {k: max(rel(m[k], r) for m in drop_moved) for k, r in whole_plain.items()}
    torch.save(dict(loss=loss, grads=cpu(grads), split_mean=cpu(split_mean), noise=noise,
                    bars={k: max(1e-3, NOISE_MULT * n) for k, n in noise.items()},
                    drop_loss=drop_loss, drop_grads=cpu(drop_all),
                    drop_split_mean=cpu(halves[False]),
                    drop_bars={k: max(1e-3, NOISE_MULT * n) for k, n in drop_noise.items()}),
               root / "step.pt")


def mesh_grads_over(model, grads: dict, bars: dict) -> tuple:
    """(worst relative norm error over its bar, the parameters over their
    bars, the three worst as (name, error, bar)) of ``model``'s gradients
    against ``grads``."""
    rows, over = [], []
    for k, p in model.named_parameters():
        if k not in bars:
            continue
        if p.grad is None:
            over.append(f"{k}: no gradient")
            continue
        r = grads[k].to(p.grad.device)
        err = float((p.grad - r).norm() / r.norm().clamp_min(1e-30))
        rows.append((err / bars[k], k, err, bars[k]))
        if not err <= bars[k]:
            over.append(f"{k}: {err:.2e} > {bars[k]:.2e}")
    rows.sort(reverse=True)
    return (rows[0][0] if rows else 0.0), over, [r[1:] for r in rows[:3]]


def mesh_model(sd, dt: str, **options):
    """The flagship with ``options`` on the card, computing in ``dt``, its
    weights the state dict ``sd``."""
    import torch
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config

    model = HiTSIR(**flagship_config(), **options, dtype=getattr(torch, dt)).to("cuda")
    model.load_state_dict(sd, strict=True)
    return model


class MeshRank:
    """One rank's part of the mesh phase: its driven calls (their launches
    counted, checked against ``want``, summed into ``counts``), its
    failures and its numbers, returned to the parent."""

    def __init__(self, rank: int, root):
        import torch
        from sisr_tpu_torch.ops.kernels import build

        self.rank, self.root = rank, root
        self.sd = torch.load(root / "flagship.pt", map_location="cuda", weights_only=True)
        self.inputs = torch.load(root / "inputs.pt", weights_only=True)
        self.ref = torch.load(root / "step.pt", weights_only=False)
        self.counts = dict.fromkeys(build.launches, 0)
        self.out = dict(rank=rank, calls={}, bad=[])

    def model(self, dt: str, **options):
        return mesh_model(self.sd, dt, **options)

    def drive(self, label: str, fn, want: dict, mesh):
        """``fn()`` with the launch counts read around it: the main path."""
        import torch
        import torch.distributed as dist
        from sisr_tpu_torch.ops.kernels import build

        dist.barrier(group=mesh.group)
        torch.cuda.synchronize()
        before, t0 = dict(build.launches), time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: build.launches[k] - before[k] for k in build.launches}
        for k, v in got.items():
            self.counts[k] += v
        want = {k: want.get(k, 0) for k in got}
        self.out["calls"].setdefault(label, {})["wall_ms"] = ms
        if got != want:
            self.out["bad"].append(f"rank {self.rank} {label}: launches {got}, want {want}")
        return res

    def busy(self, label: str, fn) -> None:
        """One more ``fn()`` under torch.profiler: its wall and device busy ms."""
        wall, rows = _profiled(fn, warm=False)
        self.out["calls"].setdefault(label, {}).update(
            profiled_wall_ms=wall, device_busy_ms=sum(r[0] for r in rows),
            top_device_ms=[(key[:60], ms) for ms, _, key in rows[:3]])

    def compare(self, label: str, got, ref, dt: str) -> None:
        """Max |got - ref| within ``MESH_BARS[dt]``, times the output's
        scale, max(1, max |ref|), in bfloat16."""
        err = float((got.float() - ref.float()).abs().max())
        bar = MESH_BARS[dt]
        if dt == "bfloat16":
            bar *= max(1.0, float(ref.float().abs().max()))
        self.out["calls"].setdefault(label, {}).update(max_abs_err=err, bar=bar)
        if not err <= bar:
            self.out["bad"].append(f"rank {self.rank} {label}: max |sharded - single| "
                                   f"{err:.3e} > {bar:.3e}")

    def digest(self, label: str, t) -> None:
        """A checksum of an output every rank holds: equal ranks, equal bytes."""
        import hashlib

        import torch

        self.out["calls"].setdefault(label, {})["sha256"] = hashlib.sha256(
            t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    def sharded(self, mesh, label: str, runner, img, want: dict, dt: str,
                check_single: bool) -> None:
        """A sharded call, driven and checked: against the single-process
        call (where ``check_single``), its digest, then profiled."""
        import torch

        axis = mesh.axis_name
        with torch.inference_mode():
            out = self.drive(label, lambda: runner.sharded_call(img, mesh, axis), want, mesh)
            if not (tuple(out.shape) == (4 * img.shape[0], 4 * img.shape[1], 3)
                    and bool(torch.isfinite(out).all())):
                self.out["bad"].append(f"rank {self.rank} {label}: shape or not finite")
            if check_single:
                self.compare(label, out, runner(img), dt)
            self.digest(label, out)
            del out
            self.busy(label, lambda: runner.sharded_call(img, mesh, axis))

    def steps(self, mesh, n: int, compare_plain_step: bool):
        """``n`` float32 DP steps (``exact_deterministic``) on this rank's
        slice of the batch; the first step's loss (1e-5 relative) and
        gradients (at their bars) against the reference step's on the
        whole batch and, on more than one rank, its gradients against the
        mean of the per-image gradients (1e-5 relative norm: the
        all-reduce's average); with ``compare_plain_step``, every step
        against ``make_train_step`` (no mesh) from the same state.  Returns
        the model."""
        from sisr_tpu_torch.parallel.mesh import shard_batch
        from sisr_tpu_torch.train.losses import l1_loss
        from sisr_tpu_torch.train.train_state import make_train_step

        lr, hr = (t.cuda() for t in shard_batch(mesh, self.inputs["batch"]))
        model = self.model("float32").train()
        opt = adam(model)
        step = make_train_step(model, l1_loss, opt, mesh=mesh)
        if compare_plain_step:
            solo = self.model("float32").train()
            solo_opt = adam(solo)
            solo_step = make_train_step(solo, l1_loss, solo_opt)
        rows, ref, tight = [], self.ref, dict.fromkeys(self.ref["split_mean"], 1e-5)
        with exact_deterministic():
            for i in range(n):
                loss = float(self.drive(f"dp step {i + 1}", lambda: step(lr, hr), PER_STEP, mesh))
                row = dict(loss=loss)
                if i == 0:
                    row["loss_rel_err"] = abs(loss - ref["loss"]) / abs(ref["loss"])
                    row["worst_over_bar"], over, row["worst"] = mesh_grads_over(
                        model, ref["grads"], ref["bars"])
                    if mesh.size > 1:
                        row["split_mean_worst"], split_over, row["split_mean_rows"] = \
                            mesh_grads_over(model, ref["split_mean"], tight)
                        over += split_over
                    if row["loss_rel_err"] > 1e-5 or over:
                        self.out["bad"].append(f"rank {self.rank} dp step: loss "
                                               f"{row['loss_rel_err']:.2e}, over {over[:3]}")
                if compare_plain_step:
                    solo_loss = float(solo_step(lr, hr))
                    grads = {k: p.grad for k, p in solo.named_parameters() if p.grad is not None}
                    row["plain_step_loss_rel_err"] = abs(loss - solo_loss) / abs(solo_loss)
                    row["plain_step_worst_over_bar"], over, _ = mesh_grads_over(
                        model, grads, ref["bars"])
                    if row["plain_step_loss_rel_err"] > 1e-5 or over:
                        self.out["bad"].append(f"rank {self.rank} dp step {i + 1} against "
                                               f"make_train_step: {over[:3]}")
                    solo.load_state_dict(model.state_dict())
                    solo_opt.load_state_dict(opt.state_dict())
                rows.append(row)
        self.out["steps"] = rows
        return model

    def dropout_steps(self, mesh, n: int) -> None:
        """``n`` float32 DP steps with ``MESH_RATES``' dropouts, the masks
        from a CUDA generator seeded ``MESH_DROP_SEED`` on every rank
        (``exact_deterministic``): the first step's loss (1e-5 relative)
        and gradients (at ``drop_bars``) against the single process's on
        the whole batch and, on more than one rank, the gradients against the
        mean of the per-image gradients with their rows' masks (1e-5);
        the parameters' and the generator's digests after the steps."""
        import hashlib

        import torch
        from sisr_tpu_torch.parallel.mesh import shard_batch
        from sisr_tpu_torch.train.losses import l1_loss
        from sisr_tpu_torch.train.train_state import make_train_step

        lr, hr = (t.cuda() for t in shard_batch(mesh, self.inputs["batch"]))
        model = self.model("float32", **MESH_RATES).train()
        step = make_train_step(model, l1_loss, adam(model), mesh=mesh)
        g = torch.Generator(device="cuda").manual_seed(MESH_DROP_SEED)
        ref, row = self.ref, {}
        with exact_deterministic():
            for i in range(n):
                loss = float(self.drive(f"dp dropout step {i + 1}", lambda: step(lr, hr, g),
                                        MESH_DROP_WANT, mesh))
                if i:
                    continue
                row["loss_rel_err"] = abs(loss - ref["drop_loss"]) / abs(ref["drop_loss"])
                row["worst_over_bar"], over, row["worst"] = mesh_grads_over(
                    model, ref["drop_grads"], ref["drop_bars"])
                if mesh.size > 1:
                    row["split_mean_worst"], split_over, _ = mesh_grads_over(
                        model, ref["drop_split_mean"], dict.fromkeys(ref["drop_split_mean"], 1e-5))
                    over += split_over
                if row["loss_rel_err"] > 1e-5 or over:
                    self.out["bad"].append(f"rank {self.rank} dp dropout step: loss "
                                           f"{row['loss_rel_err']:.2e}, over {over[:3]}")
        h = hashlib.sha256()
        for v in model.state_dict().values():
            h.update(v.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
        row["params_sha256"] = h.hexdigest()
        row["generator_sha256"] = hashlib.sha256(g.get_state().numpy().tobytes()).hexdigest()
        self.out["dropout_steps"] = row

    def dropout_control(self, mesh) -> None:
        """The dropout step with each rank drawing its masks at its own
        slice's shape (a bare generator: no rank slice) must fail the
        gradient bars."""
        import torch
        from sisr_tpu_torch.parallel.mesh import all_reduce_grads, shard_batch

        lr, hr = (t.cuda() for t in shard_batch(mesh, self.inputs["batch"]))
        model = self.model("float32", **MESH_RATES).train()
        with exact_deterministic():
            drop_grads(model, lr, hr, torch.Generator(device="cuda").manual_seed(MESH_DROP_SEED))
            all_reduce_grads(mesh, model.parameters())
        worst, over, _ = mesh_grads_over(model, self.ref["drop_grads"], self.ref["drop_bars"])
        self.out["dropout_control"] = dict(worst_over_bar=worst, over=len(over))
        if not over:
            self.out["bad"].append(f"rank {self.rank}: the dropout control (each rank's own "
                                   "masks) passed the gradient bars")

    def control(self, mesh) -> None:
        """The DP step with the division by the world size left out (the
        gradients summed over the ranks) must fail the gradient bars."""
        import torch.distributed as dist
        from sisr_tpu_torch.parallel.mesh import shard_batch
        from sisr_tpu_torch.train import train_state
        from sisr_tpu_torch.train.losses import l1_loss

        def summed(mesh, params):
            for p in params:
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=mesh.group)

        lr, hr = (t.cuda() for t in shard_batch(mesh, self.inputs["batch"]))
        model = self.model("float32").train()
        sound, train_state.all_reduce_grads = train_state.all_reduce_grads, summed
        try:
            with exact_deterministic():
                train_state.make_train_step(model, l1_loss, adam(model), mesh=mesh)(lr, hr)
        finally:
            train_state.all_reduce_grads = sound
        worst, over, _ = mesh_grads_over(model, self.ref["grads"], self.ref["bars"])
        self.out["control"] = dict(worst_over_bar=worst, over=len(over))
        if not over:
            self.out["bad"].append(f"rank {self.rank}: the control (no division by the "
                                   "world size) passed the gradient bars")


def mesh_allreduce_ms(fn, mesh, n: int = 3) -> list:
    """Host ms of ``n`` runs of a collective ``fn()``, each from a barrier
    with the card idle."""
    import torch
    import torch.distributed as dist

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def mesh_nccl_rank(rank: int, root) -> dict:
    """(a) One rank in an NCCL group of one: the sharded tiles (bf16, f32)
    and bands (f32) against their single-process calls, and 3 DP steps each
    against ``make_train_step``'s from the same state."""
    from sisr_tpu_torch.parallel.mesh import make_mesh
    from sisr_tpu_torch.parallel.tiling import BandedHeadSR, TiledSR

    import torch.distributed as dist

    me = MeshRank(rank, root)
    me.out["backend"] = dist.get_backend()
    mesh = make_mesh(1)
    tiles = me.inputs["tiles"].cuda()
    models = {dt: me.model(dt).eval() for dt in MESH_BARS}
    for dt, model in models.items():
        runner = TiledSR(model, scale=4, tile=TILE, overlap=16)
        me.sharded(make_mesh(1, "tile"), f"tiles {dt}", runner, tiles,
                   {k: v * 12 for k, v in PER_TILE.items()}, dt, True)
    runner = BandedHeadSR(models["float32"], band_rows=BAND_ROWS)
    me.sharded(make_mesh(1, "band"), "bands float32", runner, me.inputs["bands"].cuda(),
               expected_counts(*MESH_BANDS, 4, True, False), "float32", True)
    del models, runner
    me.steps(mesh, MESH_STEPS, True)
    me.dropout_steps(mesh, MESH_STEPS)
    me.out["counts"] = me.counts
    return me.out


def mesh_gloo_rank(rank: int, root) -> dict:
    """(b) and (c): one of two gloo ranks on the one card.  The sharded
    tiles and bands (the 1080p frame included) against the
    single-process calls (rank 0), the DP step against the single-process
    step of the whole batch, its control, 3 Adam steps' parameters; the
    all_reduce times; then ``hitsir_pro_experiment(n_devices=2)`` for one
    epoch in this rank's own directory."""
    import hashlib
    import os

    import torch
    import torch.distributed as dist
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.__main__ import experiment_kwargs, parse_args
    from sisr_tpu_torch.experiments.hitsir_pro_experiment import hitsir_pro_experiment
    from sisr_tpu_torch.ops.kernels import build
    from sisr_tpu_torch.parallel.mesh import (all_reduce_grads, all_reduce_sum, make_mesh,
                                              replicate)
    from sisr_tpu_torch.parallel.tiling import BandedHeadSR, TiledSR

    me = MeshRank(rank, root)
    me.out["backend"] = dist.get_backend()
    mesh = make_mesh(2)
    tiles = me.inputs["tiles"].cuda()
    models = {dt: me.model(dt).eval() for dt in MESH_BARS}
    for dt, model in models.items():
        runner = TiledSR(model, scale=4, tile=TILE, overlap=16)
        me.sharded(make_mesh(2, "tile"), f"tiles {dt}", runner, tiles,
                   {k: v * 6 for k, v in PER_TILE.items()}, dt, rank == 0)
    bmesh = make_mesh(2, "band")
    me.sharded(bmesh, "bands float32", BandedHeadSR(models["float32"], band_rows=BAND_ROWS),
               me.inputs["bands"].cuda(), expected_counts(*MESH_BANDS, 2, True, False),
               "float32", rank == 0)
    frame = BandedHeadSR(models["bfloat16"], band_rows=BAND_ROWS, out_dtype=torch.bfloat16,
                         align=FRAME_ALIGN)
    me.sharded(bmesh, "frame bfloat16", frame, me.inputs["frame"].cuda(),
               expected_counts(*FRAME_ALIGNED, MESH_FRAME_BANDS // 2, True, False), "bfloat16",
               rank == 0)
    # the frame's canvas through gloo's host copy, alone
    s = 4
    canvas = torch.zeros((s * FRAME_ALIGNED[0], s * FRAME_ALIGNED[1] // 16, 48),
                         dtype=torch.bfloat16, device="cuda")
    me.out["allreduce_frame_canvas_ms"] = mesh_allreduce_ms(
        lambda: all_reduce_sum(mesh, canvas), mesh)
    me.out["frame_canvas_bytes"] = canvas.numel() * canvas.element_size()
    del frame, models, runner, canvas
    torch.cuda.empty_cache()

    model = me.steps(mesh, MESH_STEPS, False)
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    me.out["params_after_steps_sha256"] = h.hexdigest()
    me.out["allreduce_grads_ms"] = mesh_allreduce_ms(
        lambda: all_reduce_grads(mesh, model.parameters()), mesh)
    me.out["grad_bytes"] = sum(p.grad.numel() * 4 for p in model.parameters()
                               if p.grad is not None)
    del model
    me.control(mesh)
    me.dropout_steps(mesh, MESH_STEPS)
    me.dropout_control(mesh)
    torch.cuda.empty_cache()

    # (c) the runner, one epoch, in this rank's own directory
    work = root / f"rank{rank}"
    work.mkdir()
    kw = experiment_kwargs(parse_args(
        ["hitsir_pro", "--epochs", "1", "--train-sets", "setA", "--eval-sets", "setB",
         "--test-sets", "setB", "--loader-workers", "0", "--data-root", str(root / "data")]))
    kw.update(progress=False, run=False, n_devices=2)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        exp = hitsir_pro_experiment(**kw)
        infer.synth_weights(exp.model, seed=0)
        replicate(mesh, exp.model)
        want = {k: PER_STEP.get(k, 0) * len(exp.train_loaders[0])
                + expected_counts(*(d // 4 for d in MESH_EVAL[0]), 1, False, False)[k]
                for k in build.launches}
        try:
            me.drive("runner 1 epoch", exp.run, want, mesh)
        finally:
            exp.close()
        me.out["runner_loss"] = exp.epoch_loss.avg
    finally:
        os.chdir(cwd)
    me.out["files"] = sorted(str(p.relative_to(work)) for p in work.rglob("*"))
    me.out["counts"] = me.counts
    return me.out


def run_mesh(failures: list, card: str) -> dict:
    """The mesh phase: (a) NCCL at world size 1, (b) two gloo ranks on the
    card, (c) the runner's data parallelism on them, against the
    single-process results.  Returns the launches the ranks' driven calls
    made, summed."""
    import os
    import shutil
    from pathlib import Path

    from sisr_tpu_torch import infer
    from sisr_tpu_torch.__main__ import experiment_kwargs, parse_args
    from sisr_tpu_torch.experiments.hitsir_pro_experiment import hitsir_pro_experiment
    from sisr_tpu_torch.parallel.mesh import spawn

    root = Path(__file__).resolve().parent / "build" / "smoke" / "mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    mesh_reference(root)
    runner_folders(root, MESH_TRAIN, MESH_EVAL)
    single = root / "single"
    single.mkdir()
    kw = experiment_kwargs(parse_args(
        ["hitsir_pro", "--epochs", "1", "--train-sets", "setA", "--eval-sets", "setB",
         "--test-sets", "setB", "--loader-workers", "0", "--data-root", str(root / "data")]))
    kw.update(progress=False, run=False)
    cwd = os.getcwd()
    os.chdir(single)
    try:
        exp = hitsir_pro_experiment(**kw)
        infer.synth_weights(exp.model, seed=0)
        try:
            exp.run()
        finally:
            exp.close()
        single_loss = exp.epoch_loss.avg
        del exp
    finally:
        os.chdir(cwd)
    summary = dict(card=card, note="two ranks share one card: correctness and the "
                   "collectives' cost, not scaling", setup_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    nccl = spawn(mesh_nccl_rank, 1, root, backend="nccl", device="cuda:0", timeout=600)
    summary["nccl_s"] = time.perf_counter() - t0
    log(f"  (a) nccl, world size 1: {summary['nccl_s']:.1f} s, backend {nccl[0]['backend']}")
    t0 = time.perf_counter()
    gloo = spawn(mesh_gloo_rank, 2, root, backend="gloo", device="cuda:0", timeout=900)
    summary["gloo_s"] = time.perf_counter() - t0
    log(f"  (b, c) backend {gloo[0]['backend']}, 2 ranks on cuda:0: {summary['gloo_s']:.1f} s")

    for res in nccl + gloo:
        failures.extend(res["bad"])
    for label in gloo[0]["calls"]:
        digests = {r["calls"][label].get("sha256") for r in gloo}
        if len(digests) != 1:
            failures.append(f"mesh {label}: the ranks' outputs differ")
    if gloo[0]["params_after_steps_sha256"] != gloo[1]["params_after_steps_sha256"]:
        failures.append("mesh: the ranks' parameters differ after the DP steps")
    for key in ("params_sha256", "generator_sha256"):
        if gloo[0]["dropout_steps"][key] != gloo[1]["dropout_steps"][key]:
            failures.append(f"mesh: the ranks' {key[:-7]} differ after the dropout DP steps")
    rank0_loss = [r["runner_loss"] for r in gloo]
    rel = abs(rank0_loss[0] - single_loss) / abs(single_loss)
    if not (rel <= 1e-4 and rank0_loss[0] == rank0_loss[1]):
        failures.append(f"mesh runner: loss {rank0_loss} against single {single_loss}")
    if gloo[1]["files"]:
        failures.append(f"mesh runner: rank 1 wrote {gloo[1]['files'][:5]}")
    if "logs" not in {f.split(os.sep)[0] for f in gloo[0]["files"]}:
        failures.append("mesh runner: rank 0 wrote no logs")

    counts = {k: sum(r["counts"][k] for r in nccl + gloo) for k in nccl[0]["counts"]}
    summary.update(
        nccl_world1=dict(calls=nccl[0]["calls"], steps=nccl[0]["steps"],
                         dropout_steps=nccl[0]["dropout_steps"]),
        gloo_ranks=[dict(rank=r["rank"], calls=r["calls"], steps=r["steps"],
                         control=r["control"], dropout_steps=r["dropout_steps"],
                         dropout_control=r["dropout_control"], launches=r["counts"],
                         allreduce_grads_ms=r["allreduce_grads_ms"],
                         allreduce_frame_canvas_ms=r["allreduce_frame_canvas_ms"])
                    for r in gloo],
        grad_bytes=gloo[0]["grad_bytes"], frame_canvas_bytes=gloo[0]["frame_canvas_bytes"],
        runner=dict(loss_ranks=rank0_loss, loss_single=single_loss, loss_rel_err=rel,
                    rank1_files=len(gloo[1]["files"])),
        launches=counts)
    for tag, r in [("nccl rank 0", nccl[0])] + [(f"gloo rank {r['rank']}", r) for r in gloo]:
        for label, c in r["calls"].items():
            log(f"  {tag} {label}: wall {c['wall_ms']:.1f} ms"
                + (f", profiled wall {c['profiled_wall_ms']:.1f} ms, device busy "
                   f"{c['device_busy_ms']:.1f} ms" if "device_busy_ms" in c else "")
                + (f", max |sharded - single| {c['max_abs_err']:.2e}"
                   if "max_abs_err" in c else "") + f" [{card}]")
    for r in gloo:
        log(f"  gloo rank {r['rank']} all_reduce: gradients ({r['grad_bytes'] / 2**20:.1f} MiB) "
            f"{r['allreduce_grads_ms']} ms, the 1080p canvas "
            f"({r['frame_canvas_bytes'] / 2**20:.1f} MiB) {r['allreduce_frame_canvas_ms']} ms "
            f"[{card}]")
    for tag, r in [("nccl rank 0", nccl[0])] + [(f"gloo rank {r['rank']}", r) for r in gloo]:
        d = r["dropout_steps"]
        log(f"  {tag} dropout DP step: loss {d['loss_rel_err']:.2e} relative, worst gradient "
            f"{d['worst_over_bar']:.3f} of its bar"
            + (f", against the per-image mean {d['split_mean_worst']:.3f} of 1e-5"
               if "split_mean_worst" in d else "")
            + (f"; control (own masks) {r['dropout_control']['over']} gradients over their bar"
               if "dropout_control" in r else ""))
    log(f"  runner: loss {rank0_loss} against single-process {single_loss} "
        f"({rel:.2e} relative); rank 1's directory holds {len(gloo[1]['files'])} files")
    log(f"  launches over the ranks' driven calls: {counts}")
    log(json.dumps({"mesh": summary}))
    return counts


# what each path must launch: serving the tiles, the whole-image path and
# the training step
SERVE_KERNELS = ("conv3x3", "conv3x3_shuffled", "conv3x3_shuffled_tail", "htb_tail",
                 "scc_block", "fusion_pools", "fused_fusion")
WHOLE_KERNELS = tuple(k for k in SOURCES if k != "dwconv5x5" and k not in HAT_ONLY)
TRAIN_KERNELS = tuple(k for k, v in PER_STEP.items() if v)
# the heads' forwards (the nearest+conv case runs the packed x4 head), and
# the GAN steps and runner (the train steps, the eval routes)
HEADS_KERNELS = SERVE_KERNELS + ("htb_tail_stats",)
GAN_KERNELS = RUNNER_KERNELS
# the Dense steps and runner (the Fusion gate) and the options' flagship steps
FAMILIES_KERNELS = TRAIN_KERNELS
PER = {"tile": "one 192x192 tile (sum over its shapes)",
       "frame": "one 1080p frame, LR 1088x1920 aligned (sum over its calls: 8 bands; "
                "6 window-4 and 6 window-8 blocks with fused_htb)",
       "step": "one training step, batch 2, LR 64x64, float32 (sum over its calls; "
               "dwconv5x5: 36 forward, 36 dx)",
       "dense": "one DenseSR training step at its defaults (C = 64), batch 2, LR 64x64, "
                "float32 (one call)",
       "hat_frame": "one HAT x4 frame, LR 1080x1920 padded to 1088x1920 (18 unshifted and "
                    "18 shifted window attentions, 6 overlapping)",
       "dat_frame": "one DAT x4 frame, LR 1080x1920 (9 unshifted and 9 shifted two-branch "
                    "window attentions over the map zero-padded to 1088x1920; 18 channel "
                    "attentions' sums)"}
TIMED_DTYPE = {"tile": "bfloat16", "frame": "bfloat16", "step": "float32", "dense": "float32",
               "hat_frame": "bfloat16", "dat_frame": "bfloat16"}


def scope_numbers(row: dict, scope: str) -> dict:
    """A kernel's summed cases over one scope, in the scope's own type
    (bfloat16 for a tile or a frame, float32 for a training step)."""
    sfx = "32" if TIMED_DTYPE[scope] == "float32" else ""
    t_bytes, t_ops = row["t_bytes" + sfx], row["t_ops" + sfx]
    return dict(max_abs_err=row["err"], ms=row["ms" + sfx], plain_ms=row["plain" + sfx],
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=row["lib" + sfx] if row["has_lib"] else None,
                per=PER[scope], timed_dtype=TIMED_DTYPE[scope], err_dtype="float32",
                ms_f32=row["ms32"], plain_ms_f32=row["plain32"], ms_bf16=row["ms"],
                plain_ms_bf16=row["plain"],
                library_ms_f32=row["lib32"] if row["has_lib"] else None,
                library_ms_bf16=row["lib"] if row["has_lib"] else None)


def htb_tail_alone(failures: list) -> list:
    """The wgmma path's tail launch alone (htb_tail_out_wg) at a 192x192
    tile and at one band of the 1080p frame (192x1920), bfloat16 with the
    statistics: its device ms (torch.profiler, the mean of 5 warmed calls)
    beside the whole call's (fc1 and the tail, CUDA events), the plain
    version's, and the tail's bound: its bytes (h of the band read once, x
    read, out and the statistics written, the weights) at 3.35 TB/s, fc2's
    operations at 989 TFLOP/s or the taps' at 67 TFLOP/s on the FP32
    pipes, whichever is largest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    c, ch = 180, 360
    for h, w in ((TILE, TILE), (192, FRAME[1])):
        case = htb_cases(h, w, ((True, 0),), scope="frame")[0]
        ins = case.make(torch.bfloat16)
        case.call(ins)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                case.call(ins)
            torch.cuda.synchronize()
        tail_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and "htb_tail_out_wg" in e.key) / 5e3
        ms = time_ms(lambda: case.call(ins))
        plain = time_ms(lambda: case.plain(ins), max_iters=10)
        px = h * w
        nbytes = 2 * (px * ch + 2 * px * c + ch * c + 26 * ch + 3 * c) + 4 * (2 * px + 2 * c)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(2.0 * px * ch * c / PEAK_BF16_FLOPS, 2.0 * px * 25 * ch / PEAK_F32_FLOPS) * 1e3
        bound = max(t_bytes, t_ops)
        row = dict(shape=f"{h}x{w} +stats", tail_ms=tail_ms, call_ms=ms, plain_ms=plain,
                   bound_ms=bound, bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"  htb_tail_out_wg alone {h}x{w} bf16 +stats: {tail_ms:.4f} ms (call {ms:.4f}, "
            f"plain {plain:.4f}) | bound {bound:.4f} ms ({row['bound_by']}), "
            f"{bound / tail_ms if tail_ms else 0:.1%} of it")
        if tail_ms == 0:
            failures.append(f"htb_tail at {h}x{w}: no htb_tail_out_wg launch under the profiler")
        out.append(row)
        del ins
        torch.cuda.empty_cache()
    return out


def check_dx_one_launch(failures: list) -> None:
    """dx through ``dwconv_vjp`` at a training step's shape, under
    torch.profiler: every device kernel it launches, which must be one
    dwconv5x5 kernel (no flip, no fill)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sisr_tpu_torch.ops.kernels.dwconv import _kernel, dwconv_vjp

    rn = _gen(5)
    shape = (TRAIN_BATCH, TRAIN_LR, TRAIN_LR, 360)
    x, w, b, dy = rn(*shape), rn(5, 5, 360), rn(360), rn(*shape)
    call = lambda: dwconv_vjp(_kernel, (x, w, b), (True, False, False), (dy,))
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    # a span's device-side annotation (sisr.kernel.dwconv5x5) carries its
    # host range's name: kernels only
    averages = prof.key_averages()
    host = {e.key for e in averages if e.device_type != DeviceType.CUDA}
    kernels = [(e.key, e.count) for e in averages
               if e.device_type == DeviceType.CUDA and e.count and e.key not in host]
    log(f"  dwconv5x5 dx through dwconv_vjp, {'x'.join(map(str, shape))} f32, device "
        f"kernels: {kernels}")
    if len(kernels) != 1 or kernels[0][1] != 1 or "::dwconv_" not in kernels[0][0]:
        failures.append(f"dwconv5x5 dx is not one dwconv launch: {kernels}")


def split_cases():
    """The cases the launch split profiles: the Fusion gate (fusion_pools
    and fused_fusion) at a 192x192 tile and at the frame, scc_block at
    every window of a tile and at the frame's windows 4 and 48, htb_tail
    with and without stats at a tile and at the frame, and htb_fused at
    the frame's windows 4 and 8 beside the unfused pair on the same inputs
    (scc_block at windows 4 and 8, then htb_tail_stats)."""
    h, w = FRAME_ALIGNED
    up48 = lambda n: -(-n // 48) * 48
    return (fusion_cases(TILE, TILE) + fusion_cases(h, w, scope="frame")
            + scc_cases([(TILE, TILE, win, 1) for win in STEP_WINDOWS])
            + scc_cases([(h, w, 4, 1), (up48(h), up48(w), 48, 1)], scope="frame")
            + htb_cases(TILE, TILE, ((False, 1), (True, 1)))
            + htb_cases(h, w, ((False, 1),), pad=(up48(h) - h, 0), scope="frame")
            + htb_fused_cases(h, w, ((4, False, 1), (8, True, 1)), pair=True))


def _kernel_name(key: str) -> str:
    """A device kernel's function name without its namespace, template
    arguments and parameters."""
    import re

    found = re.search(r"(\w+)\s*[<(]", key.split("::")[-1] if "(" not in key else
                      re.sub(r"\(anonymous namespace\)::", "", key))
    return found.group(1) if found else key[:40]


def launch_split(cases, dtypes=("bfloat16", "float32")) -> dict:
    """Device time of each kernel launch one call issues (torch.profiler,
    one warmed call per case and type), printed one case a line as
    ``split <kernel> <shape> <type>: total ms | name ms xN; ...``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for case in cases:
        for dt in dtypes:
            if case.scope == "frame" and dt == "float32":
                continue
            ins = case.make(getattr(torch, dt))
            case.call(ins)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                case.call(ins)
                torch.cuda.synchronize()
            parts = {}
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                    name = _kernel_name(e.key)
                    ms, n = parts.get(name, (0.0, 0))
                    parts[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
            total = sum(ms for ms, _ in parts.values())
            key = f"{case.kernel} {case.label} {dt}"
            out[key] = dict(total_ms=total, launches={k: v[0] for k, v in parts.items()})
            log(f"  split {key}: total {total:.4f} ms | "
                + "; ".join(f"{k} {ms:.4f} ms x{n}" for k, (ms, n) in
                            sorted(parts.items(), key=lambda kv: -kv[1][0])))
            del ins
            torch.cuda.empty_cache()
    return out


def ab_cases():
    """What ``--ab`` times: conv3x3 at a 192x192 tile's and a training step's
    shapes, the x4 head's conv_up2 (conv3x3_shuffled) and tails at a tile,
    the frame's head band (the packed tail) and a training step,
    dwconv5x5 (forward and dx at both maps), scc_block at every window of a
    tile and at the frame's windows 4 and 48, htb_tail and htb_tail_stats
    at a tile and at the frame, htb_fused at a tile's and at the frame's
    windows 4 and 8, and at the frame beside it the unfused pair on the
    same inputs (scc_block at windows 4 and 8, then htb_tail_stats), and
    the Fusion gate (fusion_pools, fused_fusion) at a tile, the frame and a
    training step."""
    n = TRAIN_LR
    h, w = FRAME_ALIGNED
    rows = BAND_ROWS_1080 + 4
    up48 = lambda m: -(-m // 48) * 48
    return (conv_cases([(TILE, TILE) + c for c in TILE_CONVS])
            + [shuffled_case(TILE, TILE, 1), shuffled_case(rows, w, 0, scope="frame"),
               shuffled_case(n, n, 1, scope="step", b=TRAIN_BATCH),
               tail_case(2 * TILE, 2 * TILE, 1),
               tail_case(2 * rows, 2 * w, 0, packed=True, scope="frame"),
               tail_case(2 * n, 2 * n, 1, scope="step", b=TRAIN_BATCH)]
            + conv_cases([(n, n) + c for c in TILE_CONVS], scope="step", b=TRAIN_BATCH)
            + dwconv_cases([(TRAIN_BATCH, n, n, 360, 0), (1, TILE, TILE, 360, 0)], "step")
            + scc_cases([(TILE, TILE, win, 1) for win in STEP_WINDOWS])
            + scc_cases([(h, w, 4, 0), (up48(h), up48(w), 48, 0)], scope="frame")
            + htb_cases(TILE, TILE, ((False, 1), (True, 1)))
            + htb_cases(h, w, ((False, 0), (True, 0)), pad=(up48(h) - h, 0), scope="frame")
            + htb_fused_cases(TILE, TILE, ((4, False, 1), (8, True, 1)), scope="tile")
            + htb_fused_cases(h, w, ((4, False, 0), (8, True, 0)), pair=True)
            + fusion_cases(TILE, TILE) + fusion_cases(h, w, scope="frame")
            + fusion_cases(n, n, scope="step", nb=TRAIN_BATCH))


def ab_serving() -> dict:
    """The bfloat16 requests of ``serve`` at 1 and 12 tiles through the
    entry point (``infer.upscale``), after one warm call each: the median
    wall ms of three calls and the device busy ms of one more under
    torch.profiler."""
    import torch
    from sisr_tpu_torch import infer

    model = infer.create_model("bfloat16", "cuda")
    infer.synth_weights(model, seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    with torch.inference_mode():
        for h, w in (REQUESTS[0], REQUESTS[-1]):
            img = torch.rand((h, w, 3), generator=g, device="cuda")
            run = lambda: infer.upscale(model, img, TILE)
            run()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            times[f"serve {h}x{w} bfloat16 wall (median of 3)"] = sorted(walls)[1]
            times[f"serve {h}x{w} bfloat16 device busy"] = profile_call(run, warm=False)["busy_ms"]
    del model
    torch.cuda.empty_cache()
    return times


def ab_worker(tree: str, split: bool) -> int:
    """One side of ``--ab``: the ``ab_cases`` run by the package in
    ``tree``, in bfloat16 and float32, after ``ab_serving``'s requests;
    prints one ``AB {...}`` line of ms per case, and before it, with
    ``split``, the launch split of ``split_cases``."""
    sys.path.insert(0, tree)
    import torch
    from sisr_tpu_torch.ops.kernels import build

    build.build_all()   # the serving requests launch every kernel but htb_fused
    if split:
        log(f"[split] {tree}")
        launch_split(split_cases(), dtypes=("bfloat16",))
    times = ab_serving()
    for case in ab_cases():
        for dt in (torch.bfloat16, torch.float32):
            ins = case.make(dt)
            few = dict(min_iters=1) if case.scope == "frame" else {}
            times[f"{case.kernel} {case.label} {dt}"] = time_ms(lambda: case.call(ins), **few)
            del ins
            torch.cuda.empty_cache()
    print("AB " + json.dumps(times), flush=True)
    return 0


def run_ab(base: str) -> int:
    """The A/B of the kernels ``ab_worker`` times: the tree ``base`` (a
    checkout of another commit) against this one, one process each, in the
    order base, this, this, base on the same card."""
    from pathlib import Path

    here, base = str(Path(__file__).resolve().parent), str(Path(base).resolve())
    runs = []
    for i, tree in enumerate((base, here, here, base)):
        args = [sys.executable, str(Path(__file__).resolve()), "--ab-worker", tree]
        proc = subprocess.run(args + (["--ab-split"] if i < 2 else []), capture_output=True,
                              text=True, check=False)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        for ln in proc.stdout.splitlines():
            if ln.startswith(("[split]", "  split ")):
                log(ln)
        if proc.returncode or not lines:
            log(f"ab worker on {tree} failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}")
            return 1
        runs.append(json.loads(lines[-1][3:]))
    rows = {}
    for key in runs[0]:
        old, new = (runs[0][key] + runs[3][key]) / 2, (runs[1][key] + runs[2][key]) / 2
        rows[key] = dict(base_ms=[runs[0][key], runs[3][key]], ms=[runs[1][key], runs[2][key]],
                         ratio=new / old)
        log(f"  {key:70s} base {runs[0][key]:.4f} {runs[3][key]:.4f} | this "
            f"{runs[1][key]:.4f} {runs[2][key]:.4f} | this/base {new / old:.3f}")
    log(json.dumps({"ab": rows}))
    return 0


def sass_count(kernel: str, opcodes, function: str = "") -> int:
    """Lines of ``kernel``'s built library's SASS (cuobjdump) holding one of
    ``opcodes``, in the device functions whose names hold ``function``."""
    from pathlib import Path

    from sisr_tpu_torch.ops.kernels import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build._target(kernel))],
                          capture_output=True, text=True, check=True).stdout
    count, inside = 0, not function
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside and any(op in line for op in opcodes):
            count += 1
    return count


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phases",
                   default="build,kernels,split,serve,whole,train,runner,heads,hat,dat,"
                           "gan,families,mesh,profile,check")
    p.add_argument("--ab", metavar="BASE", help="only time conv3x3, the x4 head's shuffled "
                   "convs, dwconv5x5, scc_block, htb_tail, htb_fused, the Fusion gate and "
                   "the bfloat16 serving requests against the checkout BASE (one process "
                   "each: base, this, this, base); prints no result line")
    p.add_argument("--ab-worker", metavar="TREE", help=argparse.SUPPRESS)
    p.add_argument("--ab-split", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card",
              file=sys.stderr)
        return 1
    if args.ab_worker:
        return ab_worker(args.ab_worker, args.ab_split)
    if args.ab:
        log("[ab] conv3x3, conv3x3_shuffled(_tail), dwconv5x5, scc_block, htb_tail(_stats), "
            "htb_fused, fusion_pools and fused_fusion, this tree against " + args.ab)
        return run_ab(args.ab)
    from sisr_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    failures: list = []
    rows, extra, served, whole, trained, ran = {}, {}, None, None, None, None
    heads, ganned, families, fusion_backward, meshed = None, None, None, None, None
    hatted, datted, tail_alone = None, None, None

    log("[build]")
    try:
        sec = build.build_all()
        log(f"  built {', '.join(build.KERNELS)} in {sec:.1f} s")
        for name, text in build.build_logs.items():
            for line in text.splitlines():
                if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
                    log(f"  {name}: {line.strip()}")
        for lib in ("conv3x3", "scc_block", "htb_tail", "shuffled_tail"):
            hgmma = sass_count(lib, ("HGMMA",))
            log(f"  {lib} SASS: {hgmma} HGMMA instructions")
            if hgmma == 0:
                failures.append(f"{lib}'s library holds no HGMMA: its bf16 path is not on wgmma")
        # htb_fused's launch A on wgmma (its library also holds htb_tail's tail)
        fused = sass_count("htb_fused", ("HGMMA",), "htb_fused_wg")
        log(f"  htb_fused SASS, htb_fused_wg: {fused} HGMMA instructions")
        if fused == 0:
            failures.append("htb_fused_wg holds no HGMMA: htb_fused's bf16 path is not on wgmma")
        # the shuffled conv (conv_up2) has kernels of its own in conv3x3's library
        shuf = sass_count("conv3x3", ("HGMMA", "HMMA"), "shuffled_conv_wgmma")
        log(f"  conv3x3 SASS, shuffled_conv_wgmma_*: {shuf} HGMMA/HMMA instructions")
        if shuf == 0:
            failures.append("the shuffled conv's wgmma kernels hold no HGMMA or HMMA")
        # the Fusion gate's folded maps on the tensor cores in bfloat16
        maps = sass_count("fusion", ("HGMMA", "HMMA"), "fusion_maps")
        log(f"  fusion SASS, fusion_maps: {maps} HGMMA/HMMA instructions")
        if maps == 0:
            failures.append("fusion_maps holds no HGMMA or HMMA: its bf16 product is not on "
                            "the tensor cores")
    except Exception:
        failures.append(f"build: {traceback.format_exc()}")
        log(traceback.format_exc())
    if "kernels" in phases and not failures:
        log("[kernels] per shape of one 192x192 flagship tile, then of the 1080p frame")
        rows, extra = run_kernels(failures)
        try:
            tail_alone = htb_tail_alone(failures)
            check_dx_one_launch(failures)
            fusion_backward = check_fusion_backward(failures)
        except Exception:
            failures.append(f"dx profile or the gate's backward: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "split" in phases and not failures:
        log("[split] device time of each launch of the Fusion gate, scc_block, htb_tail "
            "and htb_fused (torch.profiler)")
        try:
            launch_split(split_cases())
        except Exception:
            failures.append(f"split: {traceback.format_exc()}")
            log(traceback.format_exc())
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
    if "train" in phases and not failures:
        log("[train] make_train_step over HiTSIR(**flagship_config()), bfloat16 check, then "
            "float32 and bfloat16 steps")
        try:
            trained = run_train(failures)
        except Exception:
            failures.append(f"train: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "runner" in phases and not failures:
        log("[runner] python -m sisr_tpu_torch hitsir_pro's experiment: 2 epochs, a resume "
            "to epoch 3, test mode")
        try:
            ran = run_runner(failures, card)
        except Exception:
            failures.append(f"runner: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "heads" in phases and not failures:
        log("[heads] the flagship's widths with the pixel-shuffle heads, the one-step head "
            "and the plain conv_first, a 192x192 tile")
        try:
            heads = run_heads(failures, card)
        except Exception:
            failures.append(f"heads: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "hat" in phases and not failures:
        log("[hat] HAT x4 at its published widths, bfloat16: the 1080p frame against the "
            "plain model, then infer.upscale's tiles")
        try:
            hatted = run_hat(failures, card)
        except Exception:
            failures.append(f"hat: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "dat" in phases and not failures:
        log("[dat] DAT x4 at its published widths, bfloat16: the 1080p frame against the "
            "plain model, then infer.upscale's tiles")
        try:
            datted = run_dat(failures, card)
        except Exception:
            failures.append(f"dat: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "gan" in phases and not failures:
        log("[gan] make_gan_train_step over the flagship, UNetDiscriminatorSN(64) and a "
            "random VGG19, float32; python -m sisr_tpu_torch hitsir_pro_gan's experiment")
        try:
            ganned = run_gan(failures, card)
        except Exception:
            failures.append(f"gan: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "families" in phases and not failures:
        log("[families] DenseSR and UNetSR at their defaults: the Dense step and tiles against "
            "the plain path, the UNet against the CPU, the library ops; the families' steps, "
            "main('dense' | 'unet', ...), HiTSIR's options")
        try:
            families = run_families(failures, card)
        except Exception:
            failures.append(f"families: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "mesh" in phases and not failures:
        log("[mesh] parallel/mesh.py: NCCL at world size 1, two gloo ranks on the card "
            "(sharded tiles and bands, the DP step), hitsir_pro_experiment(n_devices=2)")
        try:
            meshed = run_mesh(failures, card)
        except Exception:
            failures.append(f"mesh: {traceback.format_exc()}")
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
        log("[check] a 192x192 tile of each request against the plain model (plain_versions())")
        try:
            run_check(served, failures)
            if "whole" in phases:
                log("[check] BandedHeadSR against the whole forward and the plain model")
                run_whole_check(served, failures)
        except Exception:
            failures.append(f"check: {traceback.format_exc()}")
            log(traceback.format_exc())
    if "check" in phases and "train" in phases:
        log("[check] the training step against the plain path (plain_versions())")
        try:
            run_train_check(failures)
        except Exception:
            failures.append(f"train check: {traceback.format_exc()}")
            log(traceback.format_exc())

    # each path's counts, set to 0 just before it and read just after
    paths = {"serve": (served or {}).get("counts"), "whole": whole, "train": trained,
             "runner": ran, "heads": heads, "hat": hatted, "dat": datted, "gan": ganned,
             "families": families, "mesh": meshed}
    for path, names in (("serve", SERVE_KERNELS), ("whole", WHOLE_KERNELS),
                        ("train", TRAIN_KERNELS), ("runner", RUNNER_KERNELS),
                        ("heads", HEADS_KERNELS), ("hat", HAT_KERNELS), ("dat", DAT_KERNELS),
                        ("gan", GAN_KERNELS),
                        ("families", FAMILIES_KERNELS), ("mesh", MESH_KERNELS)):
        if paths[path] is not None and not all(paths[path][k] > 0 for k in names):
            failures.append(f"the {path} path did not launch every kernel: {paths[path]}")
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        scopes = [sc for sc in PER if (name, sc) in rows]
        by_path = {p: (c or {}).get(name, 0) for p, c in paths.items()}
        entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=sum(by_path.values()), launches_by_path=by_path)
        if name == "htb_tail":       # rows 1 and 2 of the TPU kernels: one function
            entry["also_replaces"] = "sisr_tpu/ops/pallas/ffn.py:438"
        # the first scope's numbers at the top, a training step's (where
        # the kernel also serves) under "per_step"
        for scope in scopes:
            numbers = scope_numbers(rows[(name, scope)], scope)
            if scope == scopes[0]:
                entry.update(numbers)
            else:
                entry[f"per_{scope}"] = numbers
        if name in extra:
            entry["other_cases"] = extra[name]
        if name == "htb_tail" and tail_alone is not None:
            entry["tail_alone"] = tail_alone
        if name == "fused_fusion" and fusion_backward is not None:
            entry["backward_dense_step"] = fusion_backward
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    if failures:
        print(f"chip_smoke: {len(failures)} failed check(s):", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    if not {"build", "kernels", "serve", "whole", "train", "runner", "heads", "hat", "dat",
            "gan", "families", "mesh", "check"} <= phases:
        log("chip_smoke: partial run (--phases); no result line")
        return 2
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
