"""LPIPS(vgg) between two image files, the counterpart of the root
``test.py`` (the reference's LPIPS script):

    python -m sisr_tpu_torch.lpips image1 [image2] [--weights FILE] [--device cuda|cpu]

prints ``lpips=<value>``.  ``image2`` defaults to ``image1`` (the
self-LPIPS check: 0).  ``--weights`` is ``LPIPSVgg``'s state dict,
``torch.save``d (what ``Experiment``'s ``lpips_weights_path`` reads;
``models/vgg.py::lpips_state_dict`` builds it from lpips's heads and
torchvision's VGG16); a path that does not exist raises.  Without it the
value comes from a seeded random VGG16 and says so.  The images are read
as RGB in [0, 1] and mapped to [-1, 1] (lpips's ``normalize=True``); the
network runs in float32 with TF32 off, on the card unless ``--device cpu``
(no card raises).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

RANDOM_TAG = " (RANDOM-INIT vgg — relative values only)"


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1]."""
    from PIL import Image

    with Image.open(path) as handle:
        return np.asarray(handle.convert("RGB"), dtype=np.float32) / 255.0


def lpips_model(weights_path: Optional[str], device) -> torch.nn.Module:
    """``LPIPSVgg`` on ``device`` in evaluation: the state dict in
    ``weights_path``, or a random init drawn from seed 0 (the caller's
    generator untouched) without one."""
    from sisr_tpu_torch.models.vgg import LPIPSVgg

    if weights_path is not None and not os.path.exists(weights_path):
        raise FileNotFoundError(f"LPIPS weights file {weights_path!r} does not exist")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = LPIPSVgg()
    if weights_path is not None:
        model.load_state_dict(torch.load(weights_path, map_location="cpu", weights_only=True),
                              strict=True)
    return model.to(device).eval()


def lpips_of(model: torch.nn.Module, a: np.ndarray, b: np.ndarray) -> float:
    """LPIPS of two (H, W, 3) images in [0, 1] (float32, TF32 off)."""
    from sisr_tpu_torch.utils.precision import exact_mode

    dev = next(model.parameters()).device
    x, y = (torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32))[None].to(dev)
            for t in (a, b))
    with torch.inference_mode(), exact_mode():
        return float(model(x, y)[0])


def calculate_lpips(img_path1: str, img_path2: Optional[str] = None,
                    weights_path: Optional[str] = None, device="cuda") -> float:
    """Print and return LPIPS(vgg) between the two image files."""
    from sisr_tpu_torch.experiments.experiment import resolve_device

    model = lpips_model(weights_path, resolve_device(device))
    value = lpips_of(model, load_image(img_path1), load_image(img_path2 or img_path1))
    print(f"lpips={value}{'' if weights_path else RANDOM_TAG}")
    return value


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("image1")
    p.add_argument("image2", nargs="?", default=None,
                   help="defaults to image1 (self-LPIPS sanity check = 0)")
    p.add_argument("--weights", default=None, help="LPIPSVgg's state dict, torch.save'd")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    return calculate_lpips(args.image1, args.image2, args.weights, args.device)


if __name__ == "__main__":
    main()
