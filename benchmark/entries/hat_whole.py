"""Whole frames through HAT (``models/hat.py``) as the runner evaluates a
pixel-shuffle model: ``model(x).clamp(0, 1)`` on the LR frame, which the
model reflect-pads to multiples of its window and crops; the answer is the
float32 SR frame.  The configuration's model is built by its own
constructor and loaded strictly with the seeded weights under HAT's names
(its two position-index buffers are the model's own).

The check reports ``sr_vs_fp8`` as every serving cell does (the RMS error
over the sampled answers in units of the fp8 reference's) and beside it
``sr_vs_fp8.window``: the same ratio in each square of the SR frame that
one attention window of the LR frame becomes (64 x 64 at x4), the worst
square's.  A fault confined to some windows (the shift mask, which acts
only in the last row and column of windows of a shifted block; the keys
past the frame, only in the edge windows of an overlapping block) moves
the pooled ratio by little on a 1080p frame and its own squares by much.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from benchmark.harness.serve import ServeEntry
from benchmark.harness.check import sq_sum
from benchmark.harness.synth import synth
from benchmark.reference import hat as ref
from benchmark.reference.precision import Precision

HAT_KEYS = ("embed_dim", "depths", "num_heads", "window_size", "compress_ratio",
            "squeeze_factor", "conv_scale", "overlap_ratio", "mlp_ratio", "upscale",
            "img_range", "upsampler", "resi_connection", "num_feat")


def hat(cfg, dtype: torch.dtype, weights, device):
    from sisr_tpu_torch.models.hat import HAT

    kwargs = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()
              if k in HAT_KEYS}
    with torch.device(device):
        model = HAT(**kwargs, dtype=dtype)
    names = {k for k, _ in model.named_parameters()}
    if names != set(weights):
        raise KeyError(f"HAT's parameters and the manifest differ: {sorted(names ^ set(weights))}")
    state = model.state_dict()
    state.update(weights)
    model.load_state_dict(state, strict=True)
    return model.eval()


class Entry(ServeEntry):
    def setup(self) -> None:
        self.model = hat(self.cfg, self.dtype,
                         synth(ref.manifest(self.cfg), self.seed, "generator", self.device),
                         self.device)
        self.inputs()
        for imgs in self.images:          # each of the mix's sizes once
            self.call(imgs[0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.spans is not None:
            self.spans.count_calls(self.model)
            self.spans.wrap(self.model, "model")
            for i, layer in enumerate(self.model.layers):
                self.spans.wrap(layer, f"model.rhag{i}")

    def call(self, img: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(img[None]).clamp(0.0, 1.0)[0].float()

    def reference(self, P, img, prec):
        return ref.forward(P, self.cfg, img[None], prec)[0].clamp(0.0, 1.0)

    def answers(self, prec: Precision, indices):
        P = synth(ref.manifest(self.cfg), self.seed, "generator", self.device)
        with torch.no_grad():
            for i in indices:
                s, k = self.seq[i]
                yield i, self.reference(P, self.images[s][k], prec)

    def _numbers(self, got, low, idx, limits) -> list:
        side = self.cfg["window_size"] * self.cfg["upscale"]
        err = err8 = worst = 0.0
        for i, want in self.answers(Precision("float32"), idx):
            g, lo = got.pop(i), low.pop(i)
            e, e8 = sq_sum(g, want), sq_sum(lo, want)
            sq, sq8 = _square_sums(g, want, side), _square_sums(lo, want, side)
            # a square the fp8 reference gets nearly exact (clamped to 0 or 1)
            # is measured against a thousandth of the mean square's error
            ratio = (sq / (sq8 + 1e-3 * sq8.mean())).sqrt()
            n = want.numel()
            print(f"benchmark: answer {i} size {list(want.shape[:2])} rms {(e / n) ** 0.5!r} "
                  f"fp8 rms {(e8 / n) ** 0.5!r} worst square {float(ratio.max())!r} of "
                  f"{ratio.numel()}", file=sys.stderr)
            err, err8 = err + e, err8 + e8
            worst = max(worst, float(ratio.max()))
        pooled = (err / err8) ** 0.5 if err8 > 0 else float("inf")
        return [("sr_vs_fp8", pooled, limits.get("sr_vs_fp8")),
                ("sr_vs_fp8.window", worst, limits.get("sr_vs_fp8.window"))]


def _square_sums(a: torch.Tensor, b: torch.Tensor, side: int) -> torch.Tensor:
    """Sums of squared differences of (H, W, 3) images over side x side
    squares (the last row and column of squares partial), in float64."""
    d = (a.double() - b.double()).square().sum(-1)[None, None]
    return F.avg_pool2d(d, side, ceil_mode=True, divisor_override=1).flatten()
