"""Color-space conversions and input normalization (port of
``sisr_tpu/ops/color.py``).

* Y-channel conversion: reference utils/utils.py:170-186 (ITU-R BT.601
  luma on [0,1] RGB: ``16/255 + (65.738R + 129.057G + 25.064B)/256``).
* RGB mean normalization: reference models/hit_sir_pro.py:1126-1131,
  1310-1311 (ImageNet-ish mean (0.485, 0.456, 0.4060), scaled by img_range).

Each function takes a torch tensor or a numpy array and returns the same
kind.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_ISH_RGB_MEAN = (0.485, 0.456, 0.4060)

_Y_WEIGHTS = (65.738 / 256.0, 129.057 / 256.0, 25.064 / 256.0)
_Y_OFFSET = 16.0 / 255.0


def rgb_to_y(img, channel_axis: int = -1):
    """YCbCr luma (Y) of a [0,1] RGB image; the channel axis is removed."""
    if isinstance(img, torch.Tensor):
        r, g, b = (img.select(channel_axis, i) for i in range(3))
    else:
        r, g, b = (np.take(img, i, axis=channel_axis) for i in range(3))
    return _Y_OFFSET + _Y_WEIGHTS[0] * r + _Y_WEIGHTS[1] * g + _Y_WEIGHTS[2] * b


def _mean_like(x):
    if isinstance(x, torch.Tensor):
        return torch.tensor(IMAGENET_ISH_RGB_MEAN, dtype=x.dtype, device=x.device)
    return np.asarray(IMAGENET_ISH_RGB_MEAN, dtype=x.dtype)


def normalize_rgb(x, img_range: float = 1.0):
    """(x - rgb_mean) * img_range on NHWC input."""
    return (x - _mean_like(x)) * img_range


def denormalize_rgb(x, img_range: float = 1.0):
    """x / img_range + rgb_mean on NHWC input."""
    return x / img_range + _mean_like(x)
