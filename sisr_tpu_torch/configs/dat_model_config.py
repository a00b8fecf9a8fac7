"""DAT model config: the widths the DAT experiment varies, on the shared
``ModelConfig``; the defaults are the x4 model's published ones
(zhengchen1999/DAT ``options/Test/test_DAT_x4.yml``), and what is left out
keeps ``models/dat.py``'s defaults."""

from __future__ import annotations

from sisr_tpu_torch.configs.model_config import ModelConfig


class DATModelConfig(ModelConfig):
    def __init__(
        self,
        scaling_factor: int = 4,
        embed_dim: int = 180,
        depths=(6, 6, 6, 6, 6, 6),
        num_heads=(6, 6, 6, 6, 6, 6),
        split_size=(8, 32),
        expansion_factor: float = 4.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.scaling_factor = scaling_factor
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.split_size = tuple(split_size)
        self.expansion_factor = expansion_factor
