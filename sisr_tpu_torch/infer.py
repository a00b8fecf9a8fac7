"""Single-image x4 super-resolution with the port (counterpart of the
root ``test_experiment.py``).

Builds the flagship HiT-SIR-Pro (``flagship_config()``, the Fusion gate on,
10,220,014 parameters) or, with ``--arch hat``, HAT x4 at its published
widths (``models/hat.py``, 20,772,507 parameters), or with ``--arch dat``
DAT x4 at its published widths (``models/dat.py``, 14,802,051 parameters),
loads a ``.pth`` (``{'model': state_dict}`` such as the reference's fusion
checkpoint named by ``DEFAULT_WEIGHTS``, or HAT's and DAT's
``{'params_ema': state_dict}`` or ``{'params': state_dict}``) strictly,
runs one LR image through ``TiledSR`` (192 tiles, overlap 16; 192 is a
multiple of HAT's window and of DAT's 32), clips to [0,1] and writes a PNG.
DAT's channel attention reduces over whatever image it is given, so its
tiles give another answer than a whole-image forward (the runner's eval).

    python -m sisr_tpu_torch.infer lr.png [-o out.png] [--weights ckpt.pth]
        [--arch hat|dat] [--tile 192] [--dtype bfloat16] [--device cuda] [--show]
    python -m sisr_tpu_torch.infer hr.png --make-lr   # writes hr_bicubic_lr.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

DEFAULT_WEIGHTS = ("weights/hitsir_pro_loss(l1)_mulsizeconvextract(True)_casa(True)"
                   "_fusion_embed_dim(180)_len(depths)(6)_augment/"
                   "best_psnr_ssim_lpips_model.pth")
HAT_WEIGHTS = "weights/HAT_SRx4_ImageNet-pretrain.pth"
DAT_WEIGHTS = "weights/DAT_x4.pth"
ARCHS = ("hitsir", "hat", "dat")


def create_model(dtype: str = "float32", device: str = "cuda"):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config

    model = HiTSIR(**flagship_config(), dtype=getattr(torch, dtype))
    return model.to(device).eval()


def create_hat(dtype: str = "float32", device: str = "cuda"):
    """HAT x4 at its published widths."""
    from sisr_tpu_torch.models.hat import HAT

    return HAT(dtype=getattr(torch, dtype)).to(device).eval()


def create_dat(dtype: str = "float32", device: str = "cuda"):
    """DAT x4 at its published widths."""
    from sisr_tpu_torch.models.dat import DAT

    return DAT(dtype=getattr(torch, dtype)).to(device).eval()


def load_model_weights(model, weights_path: str, seed: int = 0) -> None:
    """Load a reference ``.pth`` strictly; without one, synthesize seeded
    well-conditioned weights (``utils/param_synth.py``)."""
    if os.path.exists(weights_path):
        dic = torch.load(weights_path, map_location="cpu", weights_only=True)
        state = next((dic[k] for k in ("model", "params_ema", "params") if k in dic), dic)
        model.load_state_dict(state, strict=True)
        print(f"loaded weights from {weights_path} "
              f"(epoch {int(dic.get('start_epoch', 0))})")
        return
    print(f"WARNING: {weights_path} not found — using random init")
    synth_weights(model, seed)


def synth_weights(model, seed: int = 0) -> None:
    """Seeded well-conditioned weights from the model's own manifest (its
    parameters; buffers such as HAT's position indices and DAT's BatchNorm
    statistics stay as built)."""
    from sisr_tpu_torch.utils.param_synth import synth_state_dict

    manifest = [(k, tuple(v.shape)) for k, v in model.named_parameters()]
    state = model.state_dict()
    state.update({k: torch.from_numpy(v) for k, v in synth_state_dict(manifest, seed).items()})
    model.load_state_dict(state)


def parse_tile(spec: str):
    """"192" -> 192 (square) or "192x1920" -> (192, 1920) strip tiles."""
    if "x" in spec:
        th, tw = (int(v) for v in spec.split("x"))
        return (th, tw)
    return int(spec)


def upscale(model, lr: torch.Tensor, tile="192") -> torch.Tensor:
    """(H, W, 3) LR image in [0,1] on the model's device -> (4H, 4W, 3)
    float32 SR image clipped to [0,1], over 192 tiles with overlap 16."""
    from sisr_tpu_torch.parallel.tiling import TiledSR

    runner = TiledSR(model, scale=4, tile=parse_tile(str(tile)))
    with torch.inference_mode():
        return runner(lr).float().clamp(0.0, 1.0)


def main(img_path: str, out_path: str = None,
         weights_path: str = None, tile="192",
         dtype: str = "float32", device: str = "cuda", show: bool = False,
         arch: str = "hitsir") -> str:
    from PIL import Image

    if arch not in ARCHS:
        raise ValueError(f"arch must be one of {ARCHS}, got {arch!r}")
    create, default = {"hat": (create_hat, HAT_WEIGHTS), "dat": (create_dat, DAT_WEIGHTS)}.get(
        arch, (create_model, DEFAULT_WEIGHTS))
    model = create(dtype, device)
    load_model_weights(model, weights_path or default)
    with Image.open(img_path) as handle:
        lr = np.asarray(handle.convert("RGB"), dtype=np.float32) / 255.0

    sr = upscale(model, torch.from_numpy(lr).to(device), tile).cpu().numpy()
    result = Image.fromarray((sr * 255.0).round().astype(np.uint8))

    if out_path is None:
        stem, ext = os.path.splitext(img_path)
        out_path = f"{stem}_sr{ext or '.png'}"
    result.save(out_path)
    print(f"saved {result.size[0]}x{result.size[1]} SR image to {out_path}")
    if show:
        result.show()
    return out_path


def get_bicubic_lr(img_path: str, scale: int = 4) -> str:
    """Write a bicubic /scale LR image next to the input (the reference's
    test_experiment.py:83-92): the image cropped to multiples of ``scale``,
    then PIL's bicubic resize.  Returns the path written."""
    from PIL import Image

    with Image.open(img_path) as handle:
        img = handle.convert("RGB")
        img = img.crop((0, 0, img.width - img.width % scale,
                        img.height - img.height % scale))
        lr = img.resize((img.width // scale, img.height // scale), Image.BICUBIC)
    stem, ext = os.path.splitext(img_path)
    out = f"{stem}_bicubic_lr{ext or '.png'}"
    lr.save(out)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("image")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("--weights", default=None,
                   help=f"default {DEFAULT_WEIGHTS} (hitsir) or {HAT_WEIGHTS} (hat)")
    p.add_argument("--arch", default="hitsir", choices=ARCHS)
    p.add_argument("--tile", default="192",
                   help='tile size: "192" (square) or "192x1920" (strips)')
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--show", action="store_true", help="open the SR image in a viewer")
    p.add_argument("--make-lr", action="store_true",
                   help="write a bicubic LR of the input instead of running SR")
    args = p.parse_args()
    if args.make_lr:
        print(get_bicubic_lr(args.image))
    else:
        main(args.image, args.out, args.weights, args.tile, args.dtype, args.device,
             args.show, args.arch)
