"""Dropout masks drawn from an explicit generator (JAX's
``rngs={"dropout": key}``), the same under data parallelism.

Every mask is drawn at the GLOBAL batch's shape and this rank keeps its
rows: the ranks' batches are contiguous slices of the global batch
(``parallel/mesh.py::shard_batch``: rows ``rank * per:(rank + 1) * per``),
so N ranks whose generators were seeded alike draw the masks one process
draws over the whole batch, and their generators stay in step.  JAX does
the same: its step draws one mask over the global batch from its key.

Masks are drawn in float32 whatever the compute dtype, so that a float32
and a bfloat16 step with the same generator drop the same elements.  A
CUDA generator draws other bits than a CPU one for the same seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch


class DropoutRng(NamedTuple):
    """Where a training forward draws its masks: ``generator`` (None:
    torch's default generator of the tensors' device, as the reference's
    ``nn.Dropout``) and this rank's slice, ``rank`` of ``size`` equal
    parts of the global batch."""

    generator: Optional[torch.Generator] = None
    rank: int = 0
    size: int = 1


Rng = Union[None, torch.Generator, DropoutRng]


def as_rng(rng: Rng) -> DropoutRng:
    """``rng`` as a ``DropoutRng`` (a bare generator or None: one rank)."""
    return rng if isinstance(rng, DropoutRng) else DropoutRng(rng)


def keep_mask(shape: Sequence[int], keep: float, like: torch.Tensor, rng: Rng) -> torch.Tensor:
    """A 0/1 mask of ``shape`` (the batch first) in ``like``'s dtype and
    device, each element 1 with probability ``keep``: this rank's rows of
    one float32 draw at the global batch's shape."""
    rng = as_rng(rng)
    n = shape[0]
    draw = torch.empty((n * rng.size,) + tuple(shape[1:]), dtype=torch.float32,
                       device=like.device).bernoulli_(keep, generator=rng.generator)
    return draw[rng.rank * n:(rng.rank + 1) * n].to(like.dtype)


def dropout(x: torch.Tensor, rate: float, rng: Rng) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: each element kept and scaled by
    1 / (1 - rate), or zeroed; x itself at rate 0."""
    if rate == 0.0:
        return x
    return x * keep_mask(x.shape, 1.0 - rate, x, rng) / (1.0 - rate)


def drop_path(x: torch.Tensor, rate: float, rng: Rng) -> torch.Tensor:
    """Stochastic depth in training: the whole sample kept (scaled by
    1 / (1 - rate)) or zeroed, one draw per sample broadcast over the
    other dimensions (JAX ``nn.Dropout(broadcast_dims=(1, 2, 3))``)."""
    if rate == 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return x * keep_mask(shape, 1.0 - rate, x, rng) / (1.0 - rate)
