"""Profiling and timing utilities (port of ``sisr_tpu/utils/profiling.py``).

The reference's only observability is wall-clock bookkeeping in text logs
(experiments/experiment.py:398-402,540-547).  Here:

* ``trace(logdir)``         context manager around ``torch.profiler`` (CPU
  and, where a card is present, CUDA activity); writes a Chrome trace to
  ``logdir/trace.json`` and returns the profiler for ``key_averages()``.
* ``device_time(fn, *args)`` per-call device seconds of ``fn(*args)`` on
  the card: a warmed run of ``n`` calls between two CUDA events, best of
  ``tries``.  It needs a card; there is no host-clock fallback.
* ``StepTimer``             rolling per-step wall times for the train loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List

import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_time(fn: Callable, *args, n: int = 20, tries: int = 3) -> float:
    """Per-call device seconds of ``fn(*args)`` (CUDA events, warmed)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA card")
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(tries):
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / n)
    return best


class StepTimer:
    """Rolling mean/last of step durations."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: List[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0
