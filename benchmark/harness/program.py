"""The system under test: the program's own constructors, given the
configuration's sizes and the benchmark's seeded weights (loaded strictly
under the reference's names)."""

from __future__ import annotations

import torch

HITSIR_KEYS = ("is_mult_size_conv_feat_extract", "is_channel_spatial_attn", "is_fusion",
               "embed_dim", "depths", "num_heads", "base_win_size", "mlp_ratio", "upscale",
               "upsampler", "hier_win_ratios", "num_feat")


def hitsir(cfg, dtype: torch.dtype, weights, device, train: bool = False):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    kwargs = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items()
              if k in HITSIR_KEYS}
    with torch.device(device):
        model = HiTSIR(**kwargs, dtype=dtype)
    model.load_state_dict(weights, strict=True)
    return model.train() if train else model.eval()


def discriminator(cfg, weights, device):
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN

    with torch.device(device):
        d = UNetDiscriminatorSN(ndf=cfg["gan"]["ndf"])
    d.load_state_dict(weights, strict=True)
    return d.train()


def perceptual(weights, device):
    from sisr_tpu_torch.models.vgg import PerceptualLoss

    with torch.device(device):
        loss = PerceptualLoss(state_dict=None)
    loss.vgg.load_state_dict(weights, strict=True)
    return loss
