"""A serving cell: the model built from the configuration and the seed,
requests drawn by the mix, sampled answers kept for the check.  An entry
(``entries/<name>.py``) says how a request calls the program and how the
plain reference answers it."""

from __future__ import annotations

import gc
import sys

import torch

from benchmark.harness import program
from benchmark.harness.check import sq_sum
from benchmark.harness.spans import Spans, span
from benchmark.harness.synth import generator, images, synth
from benchmark.harness.traffic import check_sample, serve_sequence
from benchmark.reference import hitsir as ref
from benchmark.reference.precision import Precision

MAX_REQUESTS = 100_000


class ServeEntry:
    kind = "serve"

    def __init__(self, cell, seed: int, device, trace: bool = False):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.dtype = getattr(torch, self.traffic["dtype"])
        self.spans = Spans() if trace else None
        self.kept = {}

    # the entry's two sides
    def call(self, img: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reference(self, P, img: torch.Tensor, prec: Precision) -> torch.Tensor:
        raise NotImplementedError

    def build(self) -> None:
        """Anything the entry makes once from ``self.model``."""

    def inputs(self) -> None:
        """The mix's images and request order, and the sampled requests."""
        g = generator(self.seed, "inputs", self.device)
        self.images = [images(g, self.traffic["pool"], h, w, self.device)
                       for h, w in self.traffic["sizes"]]
        self.seq = serve_sequence(self.traffic, self.seed, MAX_REQUESTS)
        self.sample = set(check_sample(self.traffic, self.seed, self.seq))

    def setup(self) -> None:
        weights = synth(ref.manifest(self.cfg), self.seed, "generator", self.device)
        self.model = program.hitsir(self.cfg, self.dtype, weights, self.device)
        del weights
        self.inputs()
        self.build()
        for imgs in self.images:          # each of the mix's sizes once
            self.call(imgs[0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.spans is not None:
            self.spans.count_calls(self.model)
            self.spans.wrap_hitsir(self.model)

    def serve(self, i: int):
        s, k = self.seq[i]
        if self.spans is None:
            out = self.call(self.images[s][k])
        else:
            with span("request"):
                out = self.call(self.images[s][k])
        if i in self.sample:
            self.kept[i] = out
        return tuple(self.traffic["sizes"][s])

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        if self.spans is not None:
            self.spans.remove()
        self.model = None
        self.release_entry()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def release_entry(self) -> None:
        """Drop what ``build`` made."""

    def answers(self, prec: Precision, indices):
        """The reference's answers at ``prec`` to the requests ``indices``."""
        P = synth(ref.manifest(self.cfg), self.seed, "generator", self.device)
        with torch.no_grad():
            for i in indices:
                s, k = self.seq[i]
                yield i, self.reference(P, self.images[s][k], prec)

    def check(self, limits) -> list:
        """[(name, value, limit)]: ``sr_vs_fp8``, the program's RMS error
        over the kept answers in units of the fp8 reference's."""
        idx = sorted(self.kept)
        low = dict(self.answers(Precision("fp8"), idx))
        return self._numbers(self.kept, low, idx, limits)

    def control(self, prec: str, limits, fault: str = "") -> list:
        """The check with the reference at ``prec`` in the program's place,
        over the answers a run samples."""
        idx = sorted(self.sample)
        answers = dict(self.answers(Precision(prec), idx))
        low = dict(answers) if prec == "fp8" else dict(self.answers(Precision("fp8"), idx))
        return self._numbers(answers, low, idx, limits)

    def _numbers(self, got, low, idx, limits) -> list:
        err = err8 = 0.0
        for i, want in self.answers(Precision("float32"), idx):
            e, e8 = sq_sum(got.pop(i), want), sq_sum(low.pop(i), want)
            n = want.numel()
            print(f"benchmark: answer {i} size {list(want.shape[:2])} rms {(e / n) ** 0.5!r} "
                  f"fp8 rms {(e8 / n) ** 0.5!r}", file=sys.stderr)
            err, err8 = err + e, err8 + e8
        return [("sr_vs_fp8", (err / err8) ** 0.5 if err8 > 0 else float("inf"),
                 limits.get("sr_vs_fp8"))]
