"""HAT model config: the widths the HAT experiment varies, on the shared
``ModelConfig``; the defaults are the x4 model's published ones (XPixelGroup/
HAT ``options/test/HAT_SRx4_ImageNet-pretrain.yml``), and what is left out
keeps ``models/hat.py``'s defaults."""

from __future__ import annotations

from sisr_tpu_torch.configs.model_config import ModelConfig


class HATModelConfig(ModelConfig):
    def __init__(
        self,
        scaling_factor: int = 4,
        embed_dim: int = 180,
        depths=(6, 6, 6, 6, 6, 6),
        num_heads=(6, 6, 6, 6, 6, 6),
        window_size: int = 16,
        squeeze_factor: int = 30,
        mlp_ratio: float = 2.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.scaling_factor = scaling_factor
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.window_size = window_size
        self.squeeze_factor = squeeze_factor
        self.mlp_ratio = mlp_ratio
