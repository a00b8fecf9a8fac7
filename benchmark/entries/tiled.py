"""Photos one at a time through ``infer.upscale`` (``TiledSR``: square
tiles with an overlap, averaged), as ``python -m sisr_tpu_torch.infer``
serves them; the answer is the clamped float32 SR image."""

from __future__ import annotations

import torch

from benchmark.harness.serve import ServeEntry
from benchmark.reference import hitsir as ref
from benchmark.reference.tiling import tiled


class Entry(ServeEntry):
    def call(self, img: torch.Tensor) -> torch.Tensor:
        from sisr_tpu_torch import infer

        return infer.upscale(self.model, img, tile=str(self.traffic["tile"]))

    def reference(self, P, img, prec):
        fn = lambda t: ref.forward(P, self.cfg, t, prec)
        return tiled(fn, img, self.cfg["upscale"], self.traffic["tile"],
                     self.traffic["overlap"]).clamp(0.0, 1.0)
