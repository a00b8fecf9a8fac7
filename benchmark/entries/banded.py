"""Whole frames through ``BandedHeadSR`` (the body over the whole frame,
the x4 head over bands of feature rows, packed where the width allows),
the path of the runner's evaluation; the answer is the float32 SR frame."""

from __future__ import annotations

import torch

from benchmark.harness.serve import ServeEntry
from benchmark.reference import hitsir as ref


class Entry(ServeEntry):
    def build(self) -> None:
        from sisr_tpu_torch.parallel.tiling import BandedHeadSR

        self.banded = BandedHeadSR(self.model, band_rows=self.traffic["band_rows"])

    def release_entry(self) -> None:
        self.banded = None

    def call(self, img: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.banded(img)

    def reference(self, P, img, prec):
        return ref.forward(P, self.cfg, img[None], prec,
                           head_rows=self.traffic["band_rows"])[0]
