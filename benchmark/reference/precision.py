"""The arithmetic precision of the plain reference.

Every product of the reference (matmul, einsum, convolution) takes its
operands through ``Precision.__call__``.  ``float32`` leaves them as they
are (the reference proper: float32, run inside ``exact()``; ``float64``
too, where the caller hands it float64 tensors).  The other
names round each operand to a lower precision first, and round the
gradient that flows back through it the same way, while sums stay float32
as on tensor cores:

- ``bfloat16``: 7 mantissa bits (the control of the float32 training
  cells, whose program runs cuDNN's convolutions in TF32);
- ``fp8``: float8 e4m3 with one scale per tensor (its largest magnitude
  mapped to 448; the control of the bfloat16 serving cells).

These are the controls of the correctness check: the reference put in the
program's place one precision below the cell's, which has to come out as
not correct.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

NAMES = ("float64", "float32", "bfloat16", "fp8")
FP8_MAX = 448.0


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


ROUND = {"bfloat16": _bf16, "fp8": _fp8}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return fn(t.detach())

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


class Precision:
    """``p(t)``: ``t`` rounded to this precision (float32 tensors)."""

    def __init__(self, name: str = "float32"):
        if name not in NAMES:
            raise ValueError(f"precision must be one of {NAMES}, got {name!r}")
        self.name = name
        self._fn = ROUND.get(name)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self._fn is None:
            return t
        return _Round.apply(t, self._fn) if t.requires_grad else self._fn(t)


@contextmanager
def exact():
    """Plain float32 products on the GPU for the reference: TF32 off for
    matmuls and cuDNN, and the flags as they were on exit.  The program
    runs outside, at PyTorch's defaults."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
