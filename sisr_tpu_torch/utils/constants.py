"""Host-made constants (index maps, pooling structure) kept on the device.

A copy from host memory to the card waits for the card's queue to drain, so
a forward that made its constants anew on every call would stall the queue
once per block.  ``device_constant`` makes each one once per device and
type.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=256)
def device_constant(fn, args: tuple, dtype, device) -> torch.Tensor:
    """``fn(*args)`` (a numpy array or a CPU tensor) as a ``dtype`` tensor on
    ``device``, made once.  Callers must not write to it."""
    # a normal tensor even when first asked for under inference_mode, so
    # that autograd may save it later
    with torch.inference_mode(False):
        return torch.as_tensor(fn(*args), dtype=dtype, device=device)
