"""Host-side image transforms for the SR data pipeline (port of
``sisr_tpu/data/transforms.py``).

Behavioural parity with reference utils/utils.py:119-188 (convert_image),
:191-290 (ImageTransforms: shared-box crop + PIL bicubic LR), :368-396
(paired flip/rot augmentation).  Everything here is numpy HWC float32; the
model's public functions take NHWC, so host arrays upload without relayout.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image

_SOURCES = {"pil", "[0,1]", "[-1,1]"}
_TARGETS = {"pil", "[0,255]", "[0,1]", "[-1,1]", "y-channel"}
_IMG_TYPES = {"[0,255]", "[0,1]", "[-1,1]"}


def convert_image(img, source: str, target: str) -> np.ndarray:
    """Value-range conversion lattice: pil | [0,255] | [0,1] | [-1,1] | y-channel.

    Operates on HWC numpy arrays (or a PIL image when source='pil'); the
    y-channel target returns HW (luma of a [0,1] RGB image).
    """
    if source not in _SOURCES:
        raise ValueError(f"bad source {source}")
    if target not in _TARGETS:
        raise ValueError(f"bad target {target}")

    if source == "pil":
        img = np.asarray(img, dtype=np.float32) / 255.0
    elif source == "[-1,1]":
        img = (np.asarray(img, dtype=np.float32) + 1.0) / 2.0
    else:
        img = np.asarray(img, dtype=np.float32)

    if target == "pil":
        return Image.fromarray((img * 255.0).round().clip(0, 255).astype(np.uint8))
    if target == "[0,255]":
        return 255.0 * img
    if target == "[-1,1]":
        return 2.0 * img - 1.0
    if target == "y-channel":
        return (16.0 / 255 + (65.738 * img[..., 0] + 129.057 * img[..., 1]
                              + 25.064 * img[..., 2]) / 256.0).astype(np.float32)
    return img


class ImageTransforms:
    """Crop (+ optional bicubic LR derivation) with a shareable crop box.

    train:      random crop_size x crop_size crop (crop box reusable so the
                HR/LR pair shares it; reference datasets/dataset.py:66-68)
    eval|test:  largest centered crop whose dims divide scaling_factor
    """

    def __init__(
        self,
        split: str,
        crop_size: int,
        scaling_factor: int,
        img_type: str,
        is_lr: bool,
        is_lr_amplify: bool,
    ):
        self.split = split
        self.crop_size = crop_size
        self.scaling_factor = scaling_factor
        self.img_type = img_type
        self.is_lr = is_lr
        self.is_lr_amplify = is_lr_amplify
        if split == "train" and crop_size % scaling_factor:
            raise ValueError("crop size must divide the scaling factor")
        if img_type not in _IMG_TYPES:
            raise ValueError(f"bad img_type {img_type}")

    def __call__(self, img: Image.Image, box: Optional[Tuple[int, int, int, int]] = None,
                 rng: Optional[random.Random] = None):
        r = rng or random
        if self.split == "train":
            if img.width < self.crop_size or img.height < self.crop_size:
                raise ValueError("image smaller than crop size")
            if box is None:
                left = r.randint(0, img.width - self.crop_size)
                top = r.randint(0, img.height - self.crop_size)
                box = (left, top, left + self.crop_size, top + self.crop_size)
            result = img.crop(box)
        else:
            if box is None:
                rx = img.width % self.scaling_factor
                ry = img.height % self.scaling_factor
                left, top = rx // 2, ry // 2
                box = (left, top, img.width - (rx - left), img.height - (ry - top))
            result = img.crop(box)

        if self.is_lr:
            result = result.resize(
                (result.width // self.scaling_factor, result.height // self.scaling_factor),
                Image.BICUBIC)
        if self.is_lr_amplify:
            result = result.resize(
                (result.width * self.scaling_factor, result.height * self.scaling_factor),
                Image.BICUBIC)

        return convert_image(result, source="pil", target=self.img_type), box


def draw_augment_params(hflip: bool = True, rotation: bool = True,
                        rng: Optional[random.Random] = None) -> Tuple[bool, bool, bool]:
    """Sample (hflip, vflip, rot90); together they span the 8 dihedral augs."""
    r = rng or random
    return (hflip and r.random() < 0.5,
            rotation and r.random() < 0.5,
            rotation and r.random() < 0.5)


def augment(img: np.ndarray, hflip: bool, vflip: bool, rot90: bool) -> np.ndarray:
    """Apply flips/transpose to a square HWC image (paired LR/HR must share params)."""
    if img.ndim != 3 or img.shape[0] != img.shape[1]:
        raise ValueError(f"augment takes a square HWC image, got {img.shape}")
    if hflip:
        img = img[:, ::-1, :]
    if vflip:
        img = img[::-1, :, :]
    if rot90:
        img = img.transpose(1, 0, 2)
    return np.ascontiguousarray(img)
