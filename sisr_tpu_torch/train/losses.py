"""Training losses (port of ``sisr_tpu/train/losses.py``).

* l1 / mse     torch L1Loss / MSELoss (mean reduction)
* charbonnier  reference utils/utils.py:326-364 (eps 1e-12)
* tv           total variation on NHWC images (KAIR models/loss.py:178-207)
* gan          BCE with logits against a constant label map (KAIR
               models/loss.py:135-172, 'gan' type)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt((pred - target).square() + eps).mean()


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total-variation smoothness loss on (B, H, W, C) images."""
    dh = (x[:, 1:] - x[:, :-1]).square().mean()
    dw = (x[:, :, 1:] - x[:, :, :-1]).square().mean()
    return weight * 2.0 * (dh + dw)


def gan_loss(logits: torch.Tensor, target_is_real: bool,
             real_label_val: float = 1.0, fake_label_val: float = 0.0) -> torch.Tensor:
    """Vanilla (BCE-with-logits) GAN loss against a constant label map."""
    label = real_label_val if target_is_real else fake_label_val
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, label))
