"""Architecture utilities (port of ``sisr_tpu/models/arch_util.py``; the
reference's utils/arch_util.py:10-123): pixel (un)shuffle, residual blocks
without normalisation, layer stacking and a pixel-shuffle upsampler, on
NHWC activations.

Also the pieces the JAX package gets from flax and the port's families
share: ``conv_nhwc`` (a conv module applied to an NHWC map, as flax's
``nn.Conv`` computes it outside the kernels), ``derived`` and
``conv_weights`` (what a module derives from its parameters for the
kernels, kept while they are unchanged) and ``flax_init_``, which
draws a module's parameters from flax's default distributions (the JAX
package defines the UNet and Dense families, so their initial state is
JAX's: ``lecun_normal`` kernels, zero biases, unit norm scales).
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle  # noqa: F401
from sisr_tpu_torch.utils.precision import exact_mode
from sisr_tpu_torch.utils.profiling import span

# flax's variance_scaling draws from a normal truncated to [-2, 2] whose
# standard deviation is this: dividing by it gives the asked-for variance
_TRUNC_STD = 0.87962566103423978


def conv_nhwc(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d``, or an ``nn.ConvTranspose2d``) on an NHWC
    map in x's dtype, with the module's stride and padding.  A float32
    forward runs with TF32 off, in full float32 as the kernels around it
    do (its backward follows PyTorch's flags)."""
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    with exact_mode() if dt == torch.float32 else nullcontext():
        if isinstance(conv, nn.ConvTranspose2d):
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), conv.weight.to(dt), bias,
                                   stride=conv.stride, padding=conv.padding)
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt), bias,
                         stride=conv.stride, padding=conv.padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def derived(module: nn.Module, kind: str, dt, device, make, sources=None):
    """``make()``: the tensors of ``kind`` derived from the parameters of
    ``sources`` (default: ``module``) for the compute type ``dt``, kept on
    ``module``, made once and kept until one of those parameters is moved
    or written (its storage or version counter changes; a parameter made
    under inference_mode has no version counter and is followed by its
    storage alone).  The parameter list is taken once: a Parameter object
    assigned later is not followed.  When grad mode is on and one of those
    parameters requires grad, ``make()`` runs anew under autograd and
    nothing is kept, so that the gradient reaches the parameters.  Each
    ``make()`` runs inside a ``sisr.derive.<kind>`` span."""
    lists = module.__dict__.setdefault("_derived_params", {})
    params = lists.get(kind)
    if params is None:
        params = lists[kind] = [p for m in (sources or (module,)) for p in m.parameters()]
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        with span("derive." + kind):
            return make()
    stamp = tuple((p.data_ptr(), -1 if p.is_inference() else p._version)
                  for p in params)
    cache = module.__dict__.setdefault("_derived", {})
    key = (kind, dt, device)
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        # plain tensors outside autograd, whatever mode the caller is in
        with torch.inference_mode(False), torch.no_grad(), span("derive." + kind):
            hit = (stamp, make())
        cache[key] = hit
    return hit[1]


def _hwio(conv: nn.Conv2d, dt):
    """Conv weight (O, I, kh, kw) -> contiguous (kh, kw, I, O) in dt."""
    return conv.weight.permute(2, 3, 1, 0).to(dt).contiguous()


def conv_weights(conv: nn.Conv2d, dt, device):
    """(HWIO kernel, bias) of a 3x3 conv in dt, cached."""
    return derived(conv, "conv", dt, device, lambda: (_hwio(conv, dt), conv.bias.to(dt)))


def _fan_in(module: nn.Module) -> int:
    """The kernel's fan-in as flax counts it: input features times the
    receptive field (a transposed conv's input features are its weight's
    first axis)."""
    w = module.weight
    if isinstance(module, nn.ConvTranspose2d):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def variance_scaling_(weight: torch.Tensor, scale: float, fan_in: int) -> torch.Tensor:
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")`` in
    place: a normal truncated to two standard deviations, with variance
    ``scale / fan_in``."""
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0)
        return weight.mul_(math.sqrt(scale / fan_in) / _TRUNC_STD)


def flax_init_(module: nn.Module) -> nn.Module:
    """Every Conv2d, ConvTranspose2d and Linear of ``module``: the kernel
    ``lecun_normal`` (variance 1 / fan-in), the bias 0; every LayerNorm and
    GroupNorm: scale 1, bias 0 (flax's defaults).  Returns ``module``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                variance_scaling_(m.weight, 1.0, _fan_in(m))
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                nn.init.ones_(m.weight)
            else:
                continue
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


def scaled_kaiming_init_(weight: torch.Tensor, fan_in: int, scale: float = 0.1) -> torch.Tensor:
    """flax's ``kaiming_normal`` (variance 2 / fan-in, truncated) times
    ``scale`` in place (reference arch_util.py:29-57's default_init_weights)."""
    with torch.no_grad():
        return variance_scaling_(weight, 2.0, fan_in).mul_(scale)


class ResidualBlockNoBN(nn.Module):
    """conv3x3 -> ReLU -> conv3x3, residual, times ``res_scale``
    (reference arch_util.py:76-101); both convs drawn kaiming-normal x 0.1."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res_scale = res_scale
        self.dtype = dtype
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        flax_init_(self)
        for conv in (self.conv1, self.conv2):
            scaled_kaiming_init_(conv.weight, _fan_in(conv), 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        y = conv_nhwc(torch.relu(conv_nhwc(x, self.conv1)), self.conv2)
        return x + y * self.res_scale


class Stack(nn.Module):
    """Blocks applied in turn, named ``block_{i}`` as in the JAX package."""

    def __init__(self, blocks):
        super().__init__()
        for i, block in enumerate(blocks):
            self.add_module(f"block_{i}", block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


def make_layer(block_cls: Callable, num_blocks: int, **kwargs) -> nn.Module:
    """``num_blocks`` blocks of ``block_cls(**kwargs)`` in sequence
    (reference arch_util.py:60-73)."""
    return Stack([block_cls(**kwargs) for _ in range(num_blocks)])


class Upsample(nn.Module):
    """Pixel-shuffle upsampler: (conv -> shuffle) per 2x stage, or one 3x
    stage (reference arch_util.py:104-123); other scales raise."""

    def __init__(self, scale: int, num_feat: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if scale > 0 and (scale & (scale - 1)) == 0:
            self.factors = [2] * int(math.log2(scale))
        elif scale == 3:
            self.factors = [3]
        else:
            raise ValueError(f"unsupported scale {scale} (2^n or 3)")
        for i, r in enumerate(self.factors):
            self.add_module(f"conv{i}", nn.Conv2d(num_feat, r * r * num_feat, 3, padding=1))
        flax_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, r in enumerate(self.factors):
            x = pixel_shuffle(conv_nhwc(x, getattr(self, f"conv{i}")), r)
        return x
