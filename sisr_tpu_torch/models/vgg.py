"""VGG feature extractor, perceptual loss and LPIPS (port of
``sisr_tpu/models/vgg.py``).

Parity targets:
  * KAIR ``VGGFeatureExtractor`` / ``PerceptualLoss``
    (参考资料/KAIR_master/models/loss.py:54-130): torchvision VGG19 features,
    taps at feature indices [2, 7, 16, 25, 34], ImageNet input norm,
    weighted L1 over the taps [0.1, 0.1, 1, 1, 1] (the only settings the
    reference's GAN run uses: no MSE, no range norm).
  * lpips.LPIPS(net='vgg'): VGG16 taps (relu1_2/2_2/3_3/4_3/5_3), unit-
    normalised feature differences through learned 1x1 heads, spatially
    averaged and summed.

The towers keep torchvision's layout (``features.N.{weight,bias}``), so a
torchvision state dict loads as it is, and the LPIPS heads lpips's
(``lin{i}.model.1.weight``).  Every conv is plain ``F.conv2d``, as the JAX
package computes them outside its kernels.  The public surface takes and
returns NHWC, as JAX's does.  No pretrained file ships with the repository:
without one the towers keep a seeded random initialisation.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# channels per conv layer, 'M' = 2x2 maxpool: torchvision's cfgs
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")

# the perceptual loss's VGG19 taps and their weights (KAIR loss.py:99-130)
PERCEPTUAL_TAPS = (2, 7, 16, 25, 34)
PERCEPTUAL_WEIGHTS = (0.1, 0.1, 1.0, 1.0, 1.0)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# lpips's ScalingLayer
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def make_features(cfg: Sequence) -> nn.Sequential:
    """torchvision ``vgg.make_layers(cfg)`` (no batch norm): conv + ReLU
    per channel count, a 2x2 max pool per 'M'."""
    layers, cin = [], 3
    for c in cfg:
        if c == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
            cin = c
    return nn.Sequential(*layers)


def _channels(x: torch.Tensor, values) -> torch.Tensor:
    return torch.tensor(values, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)


class VGGFeatures(nn.Module):
    """The VGG tower, returning the outputs of the torchvision feature
    indices ``taps`` (a conv's index taps it before its ReLU)."""

    def __init__(self, cfg: Sequence = VGG19_CFG, taps: Sequence[int] = PERCEPTUAL_TAPS,
                 use_input_norm: bool = True):
        super().__init__()
        self.taps = tuple(taps)
        self.use_input_norm = use_input_norm
        self.features = make_features(cfg)

    def taps_nchw(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The taps of an NCHW batch, NCHW: the input norm in the batch's
        dtype, the tower in its weights' (JAX's casts, so that a bfloat16
        SR is normed in bfloat16 and then runs the float32 tower)."""
        if self.use_input_norm:
            x = (x - _channels(x, IMAGENET_MEAN)) / _channels(x, IMAGENET_STD)
        x = x.to(self.features[0].weight.dtype)
        out = []
        for i, layer in enumerate(self.features[:max(self.taps) + 1]):
            x = layer(x)
            if i in self.taps:
                out.append(x)
        return out

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) -> the taps, each (B, h, w, C)."""
        return [t.permute(0, 2, 3, 1) for t in self.taps_nchw(x.permute(0, 3, 1, 2))]


def torchvision_features(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ``features.N.*`` entries of a torchvision VGG state dict (the
    whole model's or its features' alone): what ``VGGFeatures`` loads."""
    return {k: v for k, v in state_dict.items() if k.startswith("features.")}


class PerceptualLoss(nn.Module):
    """Weighted L1 over the VGG19 taps (KAIR loss.py:99-130); the ground
    truth takes no gradient and the tower's weights are frozen.
    ``state_dict``: a torchvision VGG state dict, or None for the tower's
    random initialisation."""

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 cfg: Sequence = VGG19_CFG):
        super().__init__()
        self.vgg = VGGFeatures(cfg=cfg)
        if state_dict is not None:
            self.vgg.load_state_dict(torchvision_features(state_dict), strict=True)
        self.vgg.requires_grad_(False)

    def forward(self, x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        fx = self.vgg.taps_nchw(x.permute(0, 3, 1, 2))
        fg = self.vgg.taps_nchw(gt.detach().permute(0, 3, 1, 2))
        total = 0.0
        for w, a, b in zip(PERCEPTUAL_WEIGHTS, fx, fg):
            total = total + w * (a - b).abs().mean()
        return total


def load_perceptual_state(path: Optional[str]) -> Optional[Dict[str, torch.Tensor]]:
    """The torchvision VGG19 state dict in the ``torch.save``d file
    ``path``, or None (a random VGG19) with a loud warning: a GAN run
    against a random VGG19 optimises noise features."""
    if path and os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    warnings.warn(
        "GAN perceptual loss is using a RANDOM-INIT VGG19 (no "
        "perceptual_weights_path given or file missing). Training quality "
        "will be meaningless; pass torchvision's vgg19 state dict file "
        "(README: the port's weights files)", stacklevel=2)
    return None


class NetLinLayer(nn.Module):
    """lpips's 1x1 head under its state-dict name (``model.1.weight``;
    lpips's index 0 is a dropout, off in evaluation)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPSVgg(nn.Module):
    """LPIPS(net='vgg'): unit-normalise the tap features of both images,
    square the difference, a 1x1 head per tap, spatial mean, sum over
    taps.  ``normalize=True`` maps [0, 1] images to [-1, 1] first, as
    lpips does.  Its state dict is ``net.features.N.*`` (torchvision's
    VGG16) and ``lin{i}.model.1.weight`` (lpips's heads)."""

    def __init__(self, cfg: Sequence = VGG16_CFG, taps: Sequence[int] = (3, 8, 15, 22, 29)):
        super().__init__()
        self.net = VGGFeatures(cfg=cfg, taps=taps, use_input_norm=False)
        chans = [self.net.features[t - 1].out_channels for t in taps]
        for i, c in enumerate(chans):
            setattr(self, f"lin{i}", NetLinLayer(c))
        self.requires_grad_(False)

    def forward(self, a: torch.Tensor, b: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """(B, H, W, 3) pairs -> (B,)."""
        a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
        if normalize:
            a, b = 2.0 * a - 1.0, 2.0 * b - 1.0
        shift, scale = _channels(a, LPIPS_SHIFT), _channels(a, LPIPS_SCALE)
        fa = self.net.taps_nchw((a - shift) / scale)
        fb = self.net.taps_nchw((b - shift) / scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (xa.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            nb = xb / (xb.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            head = getattr(self, f"lin{i}").model[1]
            total = total + F.conv2d((na - nb).square(), head.weight).mean(dim=(1, 2, 3))
        return total


def lpips_state_dict(lpips_state: Mapping[str, torch.Tensor],
                     vgg16_state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """lpips's head checkpoint (``lin{i}.model.1.weight``) and a torchvision
    VGG16 state dict -> ``LPIPSVgg``'s state dict (JAX ``convert_lpips``)."""
    out = {f"net.{k}": v for k, v in torchvision_features(vgg16_state).items()}
    out.update({k: v for k, v in lpips_state.items() if k.endswith("model.1.weight")})
    return out
