"""Epochs of the experiment runner as ``python -m sisr_tpu_torch hitsir_pro``
builds it (its command line's defaults: the flagship HiT-SIR-Pro in
float32, L1, Adam 2e-5 with betas (0.9, 0.99), batch 2, crop 64 at x4 with
augmentation, the BSRGAN degradation in process workers, the device
prefetch, ``new_epoch_model.pth`` at each epoch's end), driven a step at a
time through the runner's own ``Experiment.train_steps``.

Set-up writes the mix's train folder: ``images`` seeded HR PNGs of
``image_size`` (low-frequency patterns with fine noise, so that decoding
and degrading one costs what a photo's does) at PNG compression
``png_level``, in a folder of its own under ``build/bench`` inside the
checkout, where the runner also writes its weights and logs.  It loads the
benchmark's seeded weights into the runner's model, then runs the whole
first epoch: its first ``check_steps`` steps are the checked ones (their
batches, as the loader yielded them, their losses, each leaf's first
gradient from Adam's first moment and each leaf's change after them), and
after its last step the runner writes its checkpoint, which set-up reads
back against the model's state (``ckpt_gap``: the largest relative
difference of a tensor, 0 for a sound write).  The window then steps on
through the next epochs, each restart of the loader and each checkpoint
inside it.  There is no eval set: the frame cells measure whole-image
forwards.

The check is the training cells' (``train_step.py``): the reference step
follows the checked steps on the same batches from the same weights, plus
``ckpt_gap``.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout

import numpy as np
import torch

from benchmark.entries.train_step import Entry as StepEntry
from benchmark.harness.spans import span
from benchmark.harness.spec import ROOT
from benchmark.harness.synth import synth
from benchmark.reference import hitsir as ref

IMAGE_STREAM = 7


def write_images(folder: str, traffic, seed: int) -> None:
    """``images`` PNGs of ``image_size``: a smooth field (bicubic of 12 x 18
    noise) plus fine noise (sigma 6 of 255), from the seed."""
    import cv2

    h, w = traffic["image_size"]
    os.makedirs(folder, exist_ok=True)

    def one(i: int) -> None:
        rng = np.random.default_rng([int(seed) % (1 << 63), IMAGE_STREAM, i])
        low = cv2.resize(rng.random((12, 18, 3), dtype=np.float32) * 255.0, (w, h),
                         interpolation=cv2.INTER_CUBIC)
        img = np.clip(low + rng.normal(0.0, 6.0, (h, w, 3)), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(folder, f"{i:04d}.png"), img,
                    [cv2.IMWRITE_PNG_COMPRESSION, int(traffic["png_level"])])

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(one, range(traffic["images"])))


def widths(cfg) -> list:
    """The command line's flags for the configuration's model (its
    defaults at the flagship's widths)."""
    flags = ["--embed-dim", str(cfg["embed_dim"]), "--mlp-ratio", str(cfg["mlp_ratio"]),
             "--upsampler", cfg["upsampler"], "--depths", *map(str, cfg["depths"]),
             "--num-heads", *map(str, cfg["num_heads"]),
             "--base-win-size", *map(str, cfg["base_win_size"]),
             "--hier-win-ratios", *map(str, cfg["hier_win_ratios"])]
    for key, flag in (("is_mult_size_conv_feat_extract", "--no-msce"),
                      ("is_channel_spatial_attn", "--no-casa"), ("is_fusion", "--no-fusion")):
        if not cfg[key]:
            flags.append(flag)
    return flags


class Entry(StepEntry):
    def __init__(self, cell, seed: int, device, trace: bool = False):
        super().__init__(cell, seed, device, trace)
        self.root = ROOT / "build" / "bench" / f"epoch-{os.getpid()}"
        self.exp = self.gen = self.batches = None
        self.cwd = os.getcwd()
        self.ckpt_gap = float("inf")

    # ------------------------------------------------------------ program

    def inputs(self) -> None:
        """The train folder and the runner, with the seeded weights."""
        from sisr_tpu_torch.__main__ import experiment_kwargs, main, parse_args
        from sisr_tpu_torch.experiments.experiment import Experiment

        if not hasattr(Experiment, "train_steps"):
            raise RuntimeError("the runner has no Experiment.train_steps to drive a step at "
                               "a time")
        t = self.traffic
        shutil.rmtree(self.root, ignore_errors=True)
        write_images(str(self.root / "data" / "train" / "bench"), t, self.seed)
        os.chdir(self.root)
        args = parse_args(["hitsir_pro", *widths(self.cfg), "--batch-size", str(t["batch"]),
                           "--train-sets", "bench", "--eval-sets", "none",
                           "--loader-workers", str(t["workers"]), "--device",
                           str(self.device)])
        # the runner's prints (the parameter count) go to stderr: stdout holds
        # the result line alone
        with redirect_stdout(sys.stderr):
            self.exp = main("hitsir_pro", run=False, progress=False, **experiment_kwargs(args))
        weights = synth(ref.manifest(self.cfg), self.seed, "generator", self.device)
        self.exp.model.load_state_dict(weights, strict=True)
        self.model = self.exp.model

    def _next_epoch(self) -> None:
        exp = self.exp
        exp.start_epoch = exp.start_epoch + 1 if self.gen is not None else exp.start_epoch
        exp._sync_epoch_lr()
        exp.preprocess_train()
        self.gen = exp.train_steps()

    def setup(self) -> None:
        self.inputs()
        exp, n = self.exp, self.traffic["check_steps"]
        opt = exp.state.optimizer
        self.nets = {"g": (self.model, opt)}
        beta1 = self.cfg["train"]["betas"][0]
        start = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        step_fn, self.batches, self.losses = exp.train_step, [], []

        def recorded(lr, hr, gen):
            loss = step_fn(lr, hr, gen)
            if len(self.batches) < n:
                self.batches.append((lr.clone(), hr.clone()))
                self.losses.append([float(loss)])
            return loss

        exp.train_step = recorded
        self._next_epoch()
        for k, _ in enumerate(self.gen):          # the first epoch, to its checkpoint
            if k == 0:
                self.grad_norms = {"g": {name: float(opt.state[p]["exp_avg"].norm())
                                         / (1.0 - beta1)
                                         for name, p in self.model.named_parameters()
                                         if p in opt.state}}
            if k == n - 1:
                self.change_norms = {"g": {name: float((p.detach() - start[name]).norm())
                                           for name, p in self.model.named_parameters()}}
        exp.train_step = step_fn
        self.ckpt_gap = self._read_back()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.spans is not None:
            self.spans.wrap(self.model, "model")

    def _read_back(self) -> float:
        """The largest relative difference between a tensor of the model's
        state and the checkpoint the runner just wrote."""
        saved = torch.load(self.exp.new_model_path, map_location=self.device,
                           weights_only=True)["model"]
        state = self.model.state_dict()
        if set(saved) != set(state):
            return float("inf")
        gap = 0.0
        for k, v in state.items():
            a, b = saved[k].double(), v.detach().double()
            gap = max(gap, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        return gap

    def step(self):
        if self.spans is None:
            return self._step()
        with span("step"):
            return self._step()

    def _step(self):
        try:
            next(self.gen)
        except StopIteration:                     # the epoch's checkpoint was written
            self._next_epoch()
            next(self.gen)

    def release(self) -> None:
        if self.spans is not None:
            self.spans.remove()
        if self.exp is not None:
            self.exp.close()
        os.chdir(self.cwd)
        shutil.rmtree(self.root, ignore_errors=True)
        self.exp = self.gen = self.model = self.nets = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- reference

    def check(self, limits) -> list:
        return super().check(limits) + [("ckpt_gap", self.ckpt_gap, limits.get("ckpt_gap"))]

    def control(self, prec: str, limits, fault: str = "") -> list:
        """The training cells' control, on the first batches the runner's
        loader yields."""
        if self.batches is None:
            from sisr_tpu_torch.data.prefetch import device_prefetch

            it = device_prefetch(self.exp.train_loaders[0], size=2, device=self.device)
            self.batches = [next(it)[:2] for _ in range(self.traffic["check_steps"])]
            self.release()
        return super().control(prec, limits, fault)
