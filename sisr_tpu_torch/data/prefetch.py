"""Device prefetch: overlap host-to-card copies with the card's work (the
port's counterpart of ``sisr_tpu/data/prefetch.py``).

The reference's loop blocks on ``.to(device)`` per batch
(experiments/experiment.py:736-737).  Here the next batches are pinned and
copied ``non_blocking`` to the device while the current step runs, so that
``size`` batches stay in flight.  This runs in the main process; the data
workers never touch CUDA.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def _put(item, device: torch.device):
    """numpy arrays in ``item`` (nested in tuples and lists) as tensors on
    ``device``; every other leaf passes through untouched."""
    if isinstance(item, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(item))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    if isinstance(item, (tuple, list)):
        return type(item)(_put(v, device) for v in item)
    return item


def device_prefetch(iterator: Iterable, size: int = 2, device="cuda") -> Iterator:
    """Yield the items of ``iterator`` with their arrays on ``device``,
    keeping ``size`` items copied ahead."""
    device = torch.device(device)
    queue = collections.deque()
    it = iter(iterator)
    for item in it:
        queue.append(_put(item, device))
        if len(queue) >= size:
            break
    while queue:
        yield queue.popleft()
        for item in it:
            queue.append(_put(item, device))
            break
