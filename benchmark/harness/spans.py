"""The benchmark's own spans and counters around the program's layers
(traced runs only): ``record_function`` ranges named ``bench.<layer>``,
opened and closed by forward hooks on the program's modules, and a
pre-hook that records the shape of every model call."""

from __future__ import annotations

from typing import List, Tuple

import torch


def span(name: str):
    return torch.autograd.profiler.record_function("bench." + name)


class Spans:
    def __init__(self):
        self.handles = []
        self.model_calls: List[Tuple[int, int, int, str]] = []   # (B, H, W, stage)

    def wrap(self, module: torch.nn.Module, name: str) -> None:
        """A ``bench.<name>`` range around every forward of ``module``."""
        open_ranges = []

        def pre(mod, args):
            rf = span(name)
            rf.__enter__()
            open_ranges.append(rf)

        def post(mod, args, out):
            open_ranges.pop().__exit__(None, None, None)

        self.handles.append(module.register_forward_pre_hook(pre))
        self.handles.append(module.register_forward_hook(post))

    def count_calls(self, model: torch.nn.Module) -> None:
        """Record (B, H, W, stage) of every call of ``model``."""

        def pre(mod, args, kwargs):
            b, h, w = args[0].shape[:3]
            self.model_calls.append((int(b), int(h), int(w), kwargs.get("stage", "full")))

        self.handles.append(model.register_forward_pre_hook(pre, with_kwargs=True))

    def wrap_hitsir(self, model: torch.nn.Module) -> None:
        """Spans over the model, its shallow extraction, each RHTB and the
        Fusion gate; the head runs inside the model's span."""
        self.wrap(model, "model")
        self.wrap(model.conv_first, "model.shallow")
        for i, layer in enumerate(model.layers):
            self.wrap(layer, f"model.rhtb{i}")
        if getattr(model, "fusion", None) is not None:
            self.wrap(model.fusion, "model.fusion")

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []
