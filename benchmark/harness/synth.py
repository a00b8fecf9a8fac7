"""Weights and inputs made from ``--seed`` on the device.

Weights follow the rules of the program's seeded synthesis (a copy of
``utils/param_synth.py``'s, which keeps a 36-block post-norm transformer
numerically sane): fan-in-scaled normals for conv and linear weights,
LayerNorm scales near 1, small biases; a spectral norm's ``u`` and ``v``
are unit vectors.  They are drawn in one call on the device, over the
names in sorted order, so the values do not depend on the order in which
a state dict lists its entries.  The benchmark hands the same weights to
the program and to the plain reference.

Inputs are smooth random images: noise at three scales, bilinearly
upsampled and mixed, in [0, 1].
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

# streams of one seed, so weights and inputs never share draws
STREAMS = {"generator": 1, "discriminator": 2, "vgg": 3, "inputs": 4, "dropout": 6}


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + STREAMS[stream]) % (1 << 63))
    return g


def synth(manifest: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, stream: str,
          device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every (name, shape)."""
    items = sorted((name, tuple(int(s) for s in shape)) for name, shape in manifest)
    total = sum(math.prod(s) for _, s in items)
    z = torch.randn(total, generator=generator(seed, stream, device), device=device)
    out, off = {}, 0
    for name, shape in items:
        n = math.prod(shape)
        t = z[off:off + n].view(shape)
        off += n
        if name.endswith(("weight_u", "weight_v")):
            t = t / t.norm()
        elif name.endswith("bias"):
            t = t * 0.01
        elif len(shape) == 1:
            t = 1.0 + 0.05 * t
        else:
            t = t / math.sqrt(max(1, math.prod(shape[1:])))
        out[name] = t.contiguous()
    return out


def images(g: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, h, w, 3) float32 smooth random images in [0, 1]."""
    x = torch.zeros(n, 3, h, w, device=device)
    for factor, amp in ((8, 0.6), (2, 0.3), (1, 0.1)):
        small = torch.rand(n, 3, -(-h // factor), -(-w // factor), generator=g, device=device)
        x += amp * F.interpolate(small, size=(h, w), mode="bilinear", align_corners=False)
    return x.clamp_(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def bicubic_down(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """(n, H, W, 3) -> (n, H/scale, W/scale, 3): antialiased bicubic, in [0, 1]."""
    h, w = hr.shape[1] // scale, hr.shape[2] // scale
    lr = F.interpolate(hr.permute(0, 3, 1, 2), size=(h, w), mode="bicubic",
                       align_corners=False, antialias=True)
    return lr.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()
