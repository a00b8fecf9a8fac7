"""Operations of the GAN fine-tune's other networks, counted from shapes
(2 per multiply-add; convolutions only, which are nearly all of it)."""

from __future__ import annotations

from benchmark.reference.gan import VGG19_CFG, TAPS, d_layers


def discriminator_ops(h: int, w: int, ndf: int = 64) -> float:
    """One forward of KAIR's U-Net discriminator on an h x w image."""
    # output resolution of each conv as a power-of-two divisor of (h, w)
    div = {"conv0": 1, "conv1": 2, "conv2": 4, "conv3": 8, "conv4": 4, "conv5": 2,
           "conv6": 1, "conv7": 1, "conv8": 1, "conv9": 1}
    total = 0.0
    for name, cin, cout, k, _, _ in d_layers(ndf):
        f = div[name]
        total += 2.0 * (h // f) * (w // f) * k * k * cin * cout
    return total


def vgg_ops(h: int, w: int) -> float:
    """One forward of VGG19's features up to the last perceptual tap."""
    total, cin, i, f = 0.0, 3, 0, 1
    for c in VGG19_CFG:
        if i > max(TAPS):
            break
        if c == "M":
            f *= 2
            i += 1
            continue
        total += 2.0 * (h // f) * (w // f) * 9 * cin * c
        cin, i = c, i + 2
    return total
