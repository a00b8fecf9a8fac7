"""JAX flax parameter tree -> the port's torch state dict.

The inverse of ``sisr_tpu/models/torch_port.py::convert_hit_sir_state_dict``
and its name rules, so weights held by the JAX package (for example in a
parity test) load into ``HiTSIR`` with ``load_state_dict(strict=True)``.

Layout rules (flax -> torch):
  conv kernel   (kh, kw, I, O) -> weight (O, I, kh, kw)
  dense kernel  (I, O)         -> weight (O, I)
  layernorm scale/bias         -> weight/bias
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np


def _torch_module_name(path: str) -> str:
    """Flax module path (dot separated) -> torch module path."""
    n = path
    n = re.sub(r"^layers_(\d+)\.blocks_(\d+)\.", r"layers.\1.residual_group.blocks.\2.", n)
    n = re.sub(r"^layers_(\d+)\.conv$", r"layers.\1.conv", n)
    n = re.sub(r"^patch_embed_norm$", "patch_embed.norm", n)
    n = re.sub(r"^conv_before_upsample$", "conv_before_upsample.0", n)
    n = re.sub(r"\.mlp\.dwconv$", ".mlp.dwconv.depthwise_conv.0", n)
    # DynamicPosBias sequentials: posN.0 = LayerNorm, posN.2 = Linear
    n = re.sub(r"\.pos\.pos(\d)_norm$", r".pos.pos\1.0", n)
    n = re.sub(r"\.pos\.pos(\d)_linear$", r".pos.pos\1.2", n)
    m = re.match(r"^upsample_conv(\d+)$", n)
    if m:
        n = f"upsample.{2 * int(m.group(1))}"
    return n


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax params of ``sisr_tpu`` HiTSIR (the ``{'params': ...}``
    variables or the tree under it) -> {torch name: float32 ndarray}."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, np.ndarray] = {}
    for parts, value in _flatten(params):
        arr = np.asarray(value, dtype=np.float32)
        module, leaf = ".".join(parts[:-1]), parts[-1]
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unexpected flax leaf {'/'.join(parts)}")
        out[f"{_torch_module_name(module)}.{leaf}"] = np.ascontiguousarray(arr)
    return out
