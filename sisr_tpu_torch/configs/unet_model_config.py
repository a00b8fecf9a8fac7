"""UNet model config (field parity with the reference's
configs/unet_model_config.py; port of ``sisr_tpu/configs/unet_model_config.py``)."""

from __future__ import annotations

from typing import List, Tuple, Union

from sisr_tpu_torch.configs.model_config import ModelConfig


class UNetModelConfig(ModelConfig):
    def __init__(
        self,
        image_in_channels: int = 3,
        image_out_channels: int = 64,
        n_channels: int = 64,
        self_attention_layer_count: int = 1,
        ch_mults: Union[Tuple[int, ...], List[int]] = (1, 2, 1, 1),
        is_attn: Union[Tuple[bool, ...], List[int]] = (True, True, True, True),
        n_blocks: int = 2,
        n_heads: int = 1,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.image_in_channels = image_in_channels
        self.image_out_channels = image_out_channels
        self.n_channels = n_channels
        self.self_attention_layer_count = self_attention_layer_count
        self.ch_mults = tuple(ch_mults)
        self.is_attn = tuple(is_attn)
        self.n_blocks = n_blocks
        self.n_heads = n_heads
