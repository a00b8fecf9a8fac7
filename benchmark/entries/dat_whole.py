"""Whole frames through DAT (``models/dat.py``) as the runner evaluates a
pixel-shuffle model: ``model(x).clamp(0, 1)`` on the LR frame (DAT pads
nothing: its spatial attention takes the map as zero-padded to multiples
of 32 in the kernel's index arithmetic); the answer is the float32 SR
frame.  The configuration's model is built by its own constructor and
loaded strictly with the seeded weights and BatchNorm statistics under
DAT's names (its position buffers are the model's own).

The check reports ``sr_vs_fp8`` as every serving cell does (the RMS error
over the sampled answers in units of the fp8 reference's) and beside it
``sr_vs_fp8.window``: the same ratio in each 128 x 128 square of the SR
frame, one 32 x 32 LR block (the unit of the padding and of both branches'
windows), the worst square's.  A fault confined to some blocks (the padded
keys, only in the bottom row of blocks of a 1080-row frame; the shift mask,
only in the last row and column of windows) moves the pooled ratio by
little on a 1080p frame and its own squares by much; one over the whole
frame (the channel attention's sums taken over a tile) moves both.

The frames' statistics change over the frame, as a photo's do: each of a
grid of regions has its own colour, contrast and grain (``frames``).  On
frames alike everywhere, a tile's channel sums, normalised, are the whole
frame's, and a channel attention over a 192 x 192 tile would read sound.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from benchmark.entries.hat_whole import Entry as HatEntry, _square_sums
from benchmark.harness.check import sq_sum
from benchmark.harness.serve import MAX_REQUESTS
from benchmark.harness.synth import generator, images, synth
from benchmark.harness.traffic import check_sample, serve_sequence
from benchmark.reference import dat as ref
from benchmark.reference.precision import Precision

DAT_KEYS = ("embed_dim", "depth", "num_heads", "split_size", "expansion_factor", "qkv_bias",
            "upscale", "img_range", "upsampler", "resi_connection", "num_feat")
# the LR block a square of the check covers: the padding's and the windows' unit
BLOCK = 32
# the frames' regions (rows, columns); a 192 x 192 tile of a 1080p frame
# lies inside one region
REGIONS = (3, 4)


def frames(g: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, h, w, 3) images in [0, 1]: in each of ``REGIONS``' equal
    rectangles, ``images``' smooth random field around the region's own
    colour (0.2 to 0.8 a channel), at its own contrast (0.1 to 0.8), plus
    its own grain (uniform noise, amplitude 0 to 0.3)."""
    field = images(g, n, h, w, device) - 0.5
    grain = torch.rand(n, h, w, 3, generator=g, device=device) - 0.5

    def per_region(lo: float, hi: float, ch: int) -> torch.Tensor:
        v = lo + (hi - lo) * torch.rand(n, ch, *REGIONS, generator=g, device=device)
        return F.interpolate(v, size=(h, w), mode="nearest").permute(0, 2, 3, 1)

    x = per_region(0.2, 0.8, 3) + per_region(0.1, 0.8, 1) * field
    return x.add_(per_region(0.0, 0.3, 1) * grain).clamp_(0.0, 1.0).contiguous()


def weights(cfg, seed: int, device):
    """The seeded parameters and BatchNorm statistics, by DAT's names."""
    return ref.seeded(synth(ref.manifest(cfg), seed, "generator", device))


def dat(cfg, dtype: torch.dtype, weights, device):
    from sisr_tpu_torch.models.dat import DAT

    kwargs = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()
              if k in DAT_KEYS}
    with torch.device(device):
        model = DAT(**kwargs, dtype=dtype)
    state = model.state_dict()
    names = {k for k, _ in model.named_parameters()} | {
        k for k in state if k.endswith(("running_mean", "running_var"))}
    if names != set(weights):
        raise KeyError(f"DAT's parameters and the manifest differ: {sorted(names ^ set(weights))}")
    state.update(weights)
    model.load_state_dict(state, strict=True)
    return model.eval()


class Entry(HatEntry):
    def inputs(self) -> None:
        g = generator(self.seed, "inputs", self.device)
        self.images = [frames(g, self.traffic["pool"], h, w, self.device)
                       for h, w in self.traffic["sizes"]]
        self.seq = serve_sequence(self.traffic, self.seed, MAX_REQUESTS)
        self.sample = set(check_sample(self.traffic, self.seed, self.seq))

    def setup(self) -> None:
        self.model = dat(self.cfg, self.dtype, weights(self.cfg, self.seed, self.device),
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
                self.spans.wrap(layer, f"model.group{i}")

    def reference(self, P, img, prec):
        return ref.forward(P, self.cfg, img[None], prec)[0].clamp(0.0, 1.0)

    def answers(self, prec: Precision, indices):
        P = weights(self.cfg, self.seed, self.device)
        with torch.no_grad():
            for i in indices:
                s, k = self.seq[i]
                yield i, self.reference(P, self.images[s][k], prec)

    def _numbers(self, got, low, idx, limits) -> list:
        side = BLOCK * self.cfg["upscale"]
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
