"""The measured window: one client in a closed loop (serving) or the
training loop, each request or step ending in ``torch.cuda.synchronize()``."""

from __future__ import annotations

import time
from typing import List

import torch


class Window:
    def __init__(self):
        self.start = self.end = 0.0
        self.latencies_s: List[float] = []
        self.sizes: List[tuple] = []            # serving: LR (h, w) of each request
        self.lr_pixels = 0
        self.steps = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def count(self) -> int:
        return len(self.latencies_s)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve(entry, seconds: float) -> Window:
    """Requests back to back until ``seconds`` have passed; the window
    ends when the last request started in it has finished."""
    win = Window()
    _sync(entry.device)
    win.start = time.perf_counter()
    deadline = win.start + seconds
    i = 0
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        h, w = entry.serve(i)
        _sync(entry.device)
        win.latencies_s.append(time.perf_counter() - t0)
        win.sizes.append((h, w))
        win.lr_pixels += h * w
        i += 1
    win.end = time.perf_counter()
    return win


def train(entry, seconds: float) -> Window:
    """Steps back to back until ``seconds`` have passed."""
    win = Window()
    _sync(entry.device)
    win.start = time.perf_counter()
    deadline = win.start + seconds
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        entry.step()
        _sync(entry.device)
        win.latencies_s.append(time.perf_counter() - t0)
        win.steps += 1
        win.lr_pixels += entry.lr_pixels_per_step
    win.end = time.perf_counter()
    return win
