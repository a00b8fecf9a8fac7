"""Host-made constants (index maps, pooling structure) kept on the device.

A copy from host memory to the card waits for the card's queue to drain, so
a forward that made its constants anew on every call would stall the queue
once per block.  ``device_constant`` makes each one once per device and
type.  A CUDA graph reads a constant by its address, so a graph captured
inside ``kept_alive()`` holds every constant asked for there: one dropped
from the cache is not freed under it.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

_asked = threading.local()


@functools.lru_cache(maxsize=256)
def _made(fn, args: tuple, dtype, device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode, so
    # that autograd may save it later
    with torch.inference_mode(False):
        return torch.as_tensor(fn(*args), dtype=dtype, device=device)


def device_constant(fn, args: tuple, dtype, device) -> torch.Tensor:
    """``fn(*args)`` (a numpy array or a CPU tensor) as a ``dtype`` tensor on
    ``device``, made once.  Callers must not write to it."""
    t = _made(fn, args, dtype, device)
    kept = getattr(_asked, "kept", None)
    if kept is not None:
        kept.append(t)
    return t


@contextlib.contextmanager
def kept_alive():
    """A list of every constant this thread asks for inside it."""
    before, _asked.kept = getattr(_asked, "kept", None), []
    try:
        yield _asked.kept
    finally:
        _asked.kept = before
