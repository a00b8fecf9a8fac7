"""Exact-precision mode: float32 products in full float32.

On the card, a float32 matrix product runs in full float32 by default, but a
float32 cuDNN convolution runs in TF32 (about three decimal digits).  Plain
code that serves as a float32 yardstick (the model inside
``plain_versions()``) runs inside ``exact_mode()``.  The hand-written
kernels accumulate in float32 FMAs and do not read these flags, so nothing
here switches them off.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def exact_mode():
    """Turn TF32 off for matmul and cuDNN; restore the old flags on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
