"""Deterministic parameter synthesis from a (name, shape) manifest.

A copy of ``sisr_tpu/utils/param_synth.py``: both packages rebuild identical
weight values from the torch state-dict manifest (names and shapes, in
state-dict order).  The rules keep a 36-block post-norm transformer
numerically sane: fan-in-scaled normals for conv/linear weights,
near-identity LayerNorms, small biases.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def synth_state_dict(manifest: Sequence[Tuple[str, Tuple[int, ...]]],
                     seed: int = 42) -> Dict[str, np.ndarray]:
    """manifest: iterable of (torch param name, shape) IN ORDER."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, shape in manifest:
        shape = tuple(int(s) for s in shape)
        if name.endswith("bias"):
            val = rng.standard_normal(shape) * 0.01
        elif len(shape) == 1:
            # LayerNorm / scale vectors: near identity
            val = 1.0 + rng.standard_normal(shape) * 0.05
        else:
            # conv (O,I,kh,kw) / linear (O,I): fan-in-scaled
            fan_in = int(np.prod(shape[1:]))
            val = rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))
        out[name] = val.astype(np.float32)
    return out
