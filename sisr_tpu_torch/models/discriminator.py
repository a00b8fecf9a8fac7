"""U-Net discriminator with spectral normalization (port of
``sisr_tpu/models/discriminator.py``).

Parity target: KAIR ``Discriminator_UNet``
(参考资料/KAIR_master/models/network_discriminator.py:88-137): conv0, three
stride-2 SN 4x4 convs down (64->512), three bilinear-up + SN 3x3 convs with
skip adds, two extra SN convs, then a 1-channel logit conv.  LeakyReLU(0.2)
throughout.

The module layout is the reference's, so its state dict (``conv0.weight``,
``conv1.weight_orig``, ``conv1.weight_u``, ``conv1.weight_v``, ...,
``conv9.bias``) loads strictly: the SN convs use torch's
``nn.utils.spectral_norm``, whose buffers carry those names.  In train mode
each forward advances the power iteration (u, v) once and normalises the
kernel by ``u . W v`` with u, v held constant in the backward; in eval mode
it uses the stored u, v.  The convs are plain ``F.conv2d``, as the JAX
package computes them outside its kernels.  NHWC in, (B, H, W, 1) logits
out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import spectral_norm

from sisr_tpu_torch.ops.resize import bilinear_resize


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 (align_corners=False) of an NCHW map."""
    h, w = x.shape[2:]
    return bilinear_resize(x.permute(0, 2, 3, 1), 2 * h, 2 * w).permute(0, 3, 1, 2)


class UNetDiscriminatorSN(nn.Module):
    """GAN discriminator producing a per-pixel logit map (B, H, W, 1);
    4,376,897 parameters at ``ndf=64``."""

    def __init__(self, ndf: int = 64, in_chans: int = 3):
        super().__init__()
        self.conv0 = nn.Conv2d(in_chans, ndf, 3, 1, 1)
        for i, (cin, cout) in enumerate(((ndf, ndf * 2), (ndf * 2, ndf * 4),
                                         (ndf * 4, ndf * 8)), 1):
            setattr(self, f"conv{i}", spectral_norm(nn.Conv2d(cin, cout, 4, 2, 1, bias=False)))
        for i, (cin, cout) in enumerate(((ndf * 8, ndf * 4), (ndf * 4, ndf * 2), (ndf * 2, ndf),
                                         (ndf, ndf), (ndf, ndf)), 4):
            setattr(self, f"conv{i}", spectral_norm(nn.Conv2d(cin, cout, 3, 1, 1, bias=False)))
        self.conv9 = nn.Conv2d(ndf, 1, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = lambda t: F.leaky_relu(t, 0.2)
        x0 = act(self.conv0(x.permute(0, 3, 1, 2)))
        x1 = act(self.conv1(x0))
        x2 = act(self.conv2(x1))
        x3 = act(self.conv3(x2))
        x4 = act(self.conv4(_up2(x3))) + x2
        x5 = act(self.conv5(_up2(x4))) + x1
        x6 = act(self.conv6(_up2(x5))) + x0
        out = act(self.conv8(act(self.conv7(x6))))
        return self.conv9(out).permute(0, 2, 3, 1)
