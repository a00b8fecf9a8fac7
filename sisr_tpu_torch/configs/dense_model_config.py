"""Dense model config (field parity with the reference's
configs/dense_model_config.py; port of ``sisr_tpu/configs/dense_model_config.py``)."""

from __future__ import annotations

from typing import List, Optional

from sisr_tpu_torch.configs.model_config import ModelConfig


class DenseModelConfig(ModelConfig):
    def __init__(
        self,
        is_sa_attn: bool,
        is_fusion: bool,
        is_mult_size_conv_feat_extract: bool,
        num_blocks: List[int],
        skip_blocks: Optional[List[int]] = None,
        scaling_factor: int = 4,
        in_channel: int = 3,
        middle_channels: int = 64,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.is_sa_attn = is_sa_attn
        self.is_fusion = is_fusion
        self.is_mult_size_conv_feat_extract = is_mult_size_conv_feat_extract
        self.num_blocks = num_blocks
        self.skip_blocks = skip_blocks
        self.scaling_factor = scaling_factor
        self.in_channel = in_channel
        self.middle_channels = middle_channels
