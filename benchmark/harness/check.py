"""The numbers that decide ``correct``, and their limits.

Serving: the program's error against the float32 reference over the
sampled answers, in units of the error that the same reference makes
with its products in fp8 on the same answers (the RMS of the one over the
RMS of the other, pixels of all sampled answers pooled).  Both errors
swing together from seed to seed with the seeded weights' gain; their
ratio does not.  The reference in fp8 in the program's place reads 1.

Training: the first step's losses against the reference's (relative
gap); the norm of each network's first gradient and of its parameters'
change after the checked steps, each by the median leaf.  For each leaf
the gap is between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
The later steps' losses and the worst leaves carry the max pools' noise
(the SCA's spatial and channel max, the Fusion gate's pools): an argmax
that flips under rounding in one block sends one position's gradient
elsewhere, which is small against most leaves' gradients but not against
a scalar leaf whose gradient is a sum that all but cancels (a block's
``spatial_linear`` weight and bias), and Adam's normalised update moves a
leaf by whatever its gradient says.  The worst leaves are printed on
stderr for the look.  Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the change.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional, Tuple

import torch

Numbers = List[Tuple[str, float, Optional[float]]]


def sq_sum(a: torch.Tensor, b: torch.Tensor) -> float:
    """The sum of squared differences, in float64."""
    return float((a.double() - b.double()).square().sum())


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def _median(values: List[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Per leaf, |prog - ref| / max(ref, median of ref); a leaf the program
    lacks reads 0."""
    names = keep if keep is not None else list(ref)
    med = _median([ref[k] for k in names])
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def median_leaf(label: str, prog: Dict[str, float], ref: Dict[str, float],
                keep: Optional[List[str]] = None) -> float:
    """The median of ``leaf_gaps``; it, the worst gap and the three worst
    leaves go to stderr under ``label``."""
    gaps = leaf_gaps(prog, ref, keep)
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    med = _median(list(gaps.values()))
    print(f"benchmark: {label} median {med!r} worst {top[0][1] if top else 0.0!r}, leaves "
          + ", ".join(f"{k} {v:.3g} (ref {ref[k]:.3g})" for k, v in top), file=sys.stderr)
    return med


def moving_leaves(grad_ref: Dict[str, float]) -> List[str]:
    med = _median(list(grad_ref.values()))
    return [k for k, g in grad_ref.items() if g >= 1e-3 * med]


def verdict(numbers: Numbers) -> bool:
    """Correct when every number has a limit and lies within it."""
    return all(lim is not None and math.isfinite(v) and v <= lim for _, v, lim in numbers)
