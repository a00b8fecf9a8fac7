"""The GAN fine-tune's other networks and losses, plain PyTorch: KAIR's
U-Net discriminator with spectral normalization, the VGG19 perceptual
loss (KAIR ``PerceptualLoss``: taps 2, 7, 16, 25, 34 weighted 0.1, 0.1,
1, 1, 1, ImageNet input norm, L1), the BCE-with-logits adversarial loss,
the L1 pixel loss and Adam.  Functional over name -> tensor dicts in
torch's state-dict names; imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.hitsir import Ops, Params

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
TAPS = (2, 7, 16, 25, 34)
TAP_WEIGHTS = (0.1, 0.1, 1.0, 1.0, 1.0)
SN_EPS = 1e-12

# (name, cin, cout, kernel, stride, spectral norm) of the discriminator
def d_layers(ndf: int = 64):
    return ([("conv0", 3, ndf, 3, 1, False),
             ("conv1", ndf, 2 * ndf, 4, 2, True),
             ("conv2", 2 * ndf, 4 * ndf, 4, 2, True),
             ("conv3", 4 * ndf, 8 * ndf, 4, 2, True),
             ("conv4", 8 * ndf, 4 * ndf, 3, 1, True),
             ("conv5", 4 * ndf, 2 * ndf, 3, 1, True),
             ("conv6", 2 * ndf, ndf, 3, 1, True),
             ("conv7", ndf, ndf, 3, 1, True),
             ("conv8", ndf, ndf, 3, 1, True),
             ("conv9", ndf, 1, 3, 1, False)])


def d_manifest(ndf: int = 64) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    for name, cin, cout, k, _, sn in d_layers(ndf):
        if sn:
            out += [(name + ".weight_orig", (cout, cin, k, k)), (name + ".weight_u", (cout,)),
                    (name + ".weight_v", (cin * k * k,))]
        else:
            out += [(name + ".weight", (cout, cin, k, k)), (name + ".bias", (cout,))]
    return out


def _sn_weight(P: Params, buffers: Dict[str, torch.Tensor], name: str):
    """torch's spectral norm in training mode: one power iteration that
    advances u, v in ``buffers``, then the weight over u . W v."""
    w = P[name + ".weight_orig"]
    mat = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = F.normalize(mat.t() @ buffers[name + ".weight_u"], dim=0, eps=SN_EPS)
        u = F.normalize(mat @ v, dim=0, eps=SN_EPS)
        buffers[name + ".weight_u"] = u
        buffers[name + ".weight_v"] = v
    return w / torch.dot(u, mat @ v)


def discriminator(o: Ops, P: Params, buffers: Dict[str, torch.Tensor], x, ndf: int = 64):
    """(B, H, W, 3) -> (B, H, W, 1) logits; advances the spectral norms."""
    act = lambda t: F.leaky_relu(t, 0.2)
    up = lambda t: F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False)
    layers = {name: (k, s, sn) for name, _, _, k, s, sn in d_layers(ndf)}

    def conv(t, name):
        k, s, sn = layers[name]
        w = _sn_weight(P, buffers, name) if sn else None
        return o.conv(t, P, name, stride=s, padding=1, weight=w)

    x0 = act(conv(x.permute(0, 3, 1, 2), "conv0"))
    x1 = act(conv(x0, "conv1"))
    x2 = act(conv(x1, "conv2"))
    x3 = act(conv(x2, "conv3"))
    x4 = act(conv(up(x3), "conv4")) + x2
    x5 = act(conv(up(x4), "conv5")) + x1
    x6 = act(conv(up(x5), "conv6")) + x0
    out = act(conv(act(conv(x6, "conv7")), "conv8"))
    return conv(out, "conv9").permute(0, 2, 3, 1)


def vgg_manifest() -> List[Tuple[str, Tuple[int, ...]]]:
    """torchvision's VGG19 ``features`` (conv weights and biases by index)."""
    out, cin, i = [], 3, 0
    for c in VGG19_CFG:
        if c == "M":
            i += 1
            continue
        out += [(f"features.{i}.weight", (c, cin, 3, 3)), (f"features.{i}.bias", (c,))]
        cin, i = c, i + 2
    return out


def vgg_taps(o: Ops, P: Params, x):
    """NCHW image -> the outputs of the tap indices (a conv's index taps
    it before its ReLU), after the ImageNet input norm."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    x = (x - mean) / std
    out, i = [], 0
    for c in VGG19_CFG:
        if i > max(TAPS):
            break
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
            i += 1
            continue
        x = o.conv(x, P, f"features.{i}")
        if i in TAPS:
            out.append(x)
        x = torch.relu(x)
        i += 2
    return out


def perceptual_loss(o: Ops, P: Params, sr, hr):
    fx = vgg_taps(o, P, sr.permute(0, 3, 1, 2))
    with torch.no_grad():
        fg = vgg_taps(o, P, hr.permute(0, 3, 1, 2))
    total = 0.0
    for w, a, b in zip(TAP_WEIGHTS, fx, fg):
        total = total + w * (a - b).abs().mean()
    return total


def bce(logits, real: bool):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits,
                                                                      1.0 if real else 0.0))


def l1(a, b):
    return (a - b).abs().mean()


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad) over a dict
    of leaves, with its state readable: ``exp_avg`` after the first step
    is (1 - beta1) times the first gradient."""

    def __init__(self, params: Params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, tuple(betas), eps
        self.t = 0
        self.exp_avg = {k: torch.zeros_like(v) for k, v in params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in self.params.items():
            g = grads.get(k)
            if g is None:
                continue
            m, v = self.exp_avg[k], self.exp_avg_sq[k]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)
