"""JAX flax parameter trees -> the port's torch state dicts.

The inverses of ``sisr_tpu/models/torch_port.py``'s converters
(``convert_hit_sir_state_dict``, ``convert_discriminator_state_dict``) and
of ``sisr_tpu/models/vgg.py``'s (``convert_torchvision_vgg``,
``convert_lpips``), so state held by the JAX package (for example in a
parity test) loads into ``HiTSIR``, ``UNetDiscriminatorSN``,
``VGGFeatures`` / ``PerceptualLoss`` and ``LPIPSVgg`` with
``load_state_dict(strict=True)``.

Layout rules (flax -> torch):
  conv kernel   (kh, kw, I, O) -> weight (O, I, kh, kw)
  dense kernel  (I, O)         -> weight (O, I)
  layernorm scale/bias         -> weight/bias
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np

from sisr_tpu_torch.models.vgg import VGG16_CFG, VGG19_CFG


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


def _conv_weight(kernel) -> np.ndarray:
    """flax conv kernel (kh, kw, I, O) -> torch weight (O, I, kh, kw)."""
    return np.array(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1), order="C")


def discriminator_state_dict_from_jax(params: Mapping,
                                      spectral: Mapping) -> Dict[str, np.ndarray]:
    """``UNetDiscriminatorSN`` params and its ``spectral`` collection (u, v
    per SN conv) -> the reference's state dict: ``convN.weight``/``bias``
    for the plain convs, ``convN.weight_orig``/``weight_u``/``weight_v``
    for the spectral-norm ones."""
    if set(params) == {"params"}:
        params = params["params"]
    if set(spectral) == {"spectral"}:
        spectral = spectral["spectral"]
    out: Dict[str, np.ndarray] = {}
    for mod in sorted(params, key=lambda m: int(m[len("conv"):])):
        leaves = params[mod]
        if mod in spectral:
            out[f"{mod}.weight_orig"] = _conv_weight(leaves["kernel"])
            out[f"{mod}.weight_u"] = np.array(spectral[mod]["u"], np.float32)
            out[f"{mod}.weight_v"] = np.array(spectral[mod]["v"], np.float32)
        else:
            out[f"{mod}.weight"] = _conv_weight(leaves["kernel"])
        if "bias" in leaves:
            out[f"{mod}.bias"] = np.array(leaves["bias"], np.float32)
    return out


def _conv_indices(cfg: Sequence) -> list:
    """torchvision features index of each conv of ``cfg``."""
    idx, out = 0, []
    for c in cfg:
        if c != "M":
            out.append(idx)
        idx += 1 if c == "M" else 2
    return out


def vgg_state_dict_from_jax(variables: Mapping, cfg: Sequence = VGG19_CFG,
                            prefix: str = "features.") -> Dict[str, np.ndarray]:
    """``VGGFeatures`` params (``conv{i}``) -> torchvision's
    ``features.N.{weight,bias}`` (the inverse of ``convert_torchvision_vgg``)."""
    if set(variables) == {"params"}:
        variables = variables["params"]
    where = _conv_indices(cfg)
    out: Dict[str, np.ndarray] = {}
    for i in range(len(variables)):
        conv = variables[f"conv{i}"]
        out[f"{prefix}{where[i]}.weight"] = _conv_weight(conv["kernel"])
        out[f"{prefix}{where[i]}.bias"] = np.array(conv["bias"], np.float32)
    return out


def lpips_state_dict_from_jax(variables: Mapping,
                              cfg: Sequence = VGG16_CFG) -> Dict[str, np.ndarray]:
    """``LPIPSVgg`` params (``net`` and the heads ``lin{i}``) -> the port's
    ``LPIPSVgg`` state dict (the inverse of ``convert_lpips``)."""
    if set(variables) == {"params"}:
        variables = variables["params"]
    out = vgg_state_dict_from_jax(variables["net"], cfg, prefix="net.features.")
    for name, leaves in variables.items():
        if name.startswith("lin"):
            out[f"{name}.model.1.weight"] = _conv_weight(leaves["kernel"])
    return out
