"""Dataset configuration (field parity with the reference's
configs/dataset_config.py; a copy of ``sisr_tpu/configs/dataset_config.py``)."""

from __future__ import annotations


class DatasetConfig:
    def __init__(
        self,
        split: str,
        crop_size: int = 64,
        scaling_factor: int = 4,
        lr_img_type: str = "[0,1]",
        hr_img_type: str = "[0,1]",
        is_lr_amplify: bool = False,
        is_augment: bool = False,
    ):
        """
        :param split: 'train' or 'eval|test'
        :param crop_size: LR patch size; HR patch = crop_size * scaling_factor
        :param scaling_factor: SR upscale factor
        :param lr_img_type / hr_img_type: value range of produced tensors
        :param is_lr_amplify: bicubic-upscale LR back to HR size
        :param is_augment: flip/rot augmentation (train only)
        """
        self.crop_size = crop_size
        self.split = split
        self.scaling_factor = scaling_factor
        self.lr_img_type = lr_img_type
        self.hr_img_type = hr_img_type
        self.is_lr_amplify = is_lr_amplify
        self.is_augment = is_augment

        # HR-side crop size (reference configs/dataset_config.py:30)
        self.image_size = self.crop_size * self.scaling_factor

        if self.split.lower() not in {"train", "eval|test"}:
            raise ValueError(f"split must be 'train' or 'eval|test', got {split!r}")
        for t in (self.lr_img_type, self.hr_img_type):
            if t not in {"[0,255]", "[0,1]", "[-1,1]"}:
                raise ValueError('img_type should be one of "[0,255]", "[0,1]", "[-1,1]"')
