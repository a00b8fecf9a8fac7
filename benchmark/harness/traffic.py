"""The one generator of every mix: a mix file gives parameters, this file
turns them and ``--seed`` into the inputs' order.

Serving mixes (``"kind": "serve"``):

- ``sizes``: LR sizes [h, w], drawn in rounds: each size once a round, in
  an order drawn from the seed, so every seed's window holds the same mix;
- ``pool``: distinct images made per size;
- ``control``: the precision of the check's control (``control.py``);
- ``check``: ``sample`` answers drawn from the seed among the first
  ``within`` requests, plus the first request of the largest size.

Training mixes (``"kind": "train"``): ``batch`` HR crops of
``lr_size * scale`` a step, from a pool of ``pool`` batches made from the
seed; the first ``check_steps`` steps (in set-up) are the ones the
reference follows; ``control`` as above; ``precision`` states what the
program computes in (the harness leaves PyTorch's defaults alone).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SAMPLE_STREAM = 5


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def serve_sequence(traffic, seed: int, n: int) -> List[Tuple[int, int]]:
    """The first n requests as (size index, image index)."""
    sizes = traffic["sizes"]
    r = rng(seed, 1)
    counts = [0] * len(sizes)
    out: List[Tuple[int, int]] = []
    while len(out) < n:
        for s in r.permutation(len(sizes)):
            out.append((int(s), counts[s] % traffic["pool"]))
            counts[s] += 1
    return out[:n]


def check_sample(traffic, seed: int, seq: List[Tuple[int, int]]) -> List[int]:
    """Indices of the requests whose answers are compared."""
    chk = traffic["check"]
    within = min(chk["within"], len(seq))
    picked = set(int(i) for i in rng(seed, SAMPLE_STREAM).choice(
        within, size=min(chk["sample"], within), replace=False))
    areas = [h * w for h, w in traffic["sizes"]]
    largest = int(np.argmax(areas))
    picked.add(next(i for i, (s, _) in enumerate(seq) if s == largest))
    return sorted(picked)
