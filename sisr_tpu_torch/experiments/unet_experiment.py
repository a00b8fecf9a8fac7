"""UNet SR experiment (port of ``sisr_tpu/experiments/unet_experiment.py``;
completes the reference's UNetModelConfig surface): the same configs,
defaults and run-folder names as the JAX experiment."""

from __future__ import annotations

import copy

import torch

from sisr_tpu_torch.configs.dataset_config import DatasetConfig
from sisr_tpu_torch.configs.unet_model_config import UNetModelConfig
from sisr_tpu_torch.experiments.experiment import Experiment
from sisr_tpu_torch.models.unet_sr import UNetSR


class UNetExperiment(Experiment):
    def init_model(self):
        mc = self.model_config
        # flax's initialization, drawn from seed 0 without disturbing the
        # caller's generator (the JAX runner inits from PRNGKey(0)); a
        # checkpoint, when there is one, replaces it
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = UNetSR(
                image_in_channels=mc.image_in_channels,
                n_channels=mc.n_channels,
                ch_mults=tuple(mc.ch_mults),
                is_attn=tuple(mc.is_attn),
                n_blocks=mc.n_blocks,
                n_heads=mc.n_heads,
                upscale=getattr(mc, "scaling_factor", 4),
                dtype=getattr(torch, mc.compute_dtype),
            )
        self.model = model.to(self.device)
        super().init_model()


def unet_experiment(is_test: bool, loss: str = "l1", epochs: int = 400,
                    is_augment: bool = True, batch_size: int = 2,
                    test_model_name: str = "best_psnr_ssim_lpips_model.pth",
                    n_channels: int = 64, ch_mults=(1, 2, 1, 1),
                    is_attn=(True, True, True, True), n_blocks: int = 2,
                    n_heads: int = 1, data_root: str = "data",
                    train_data_name_list=None, eval_data_name_list=None,
                    test_data_name_list=None, loader_workers: int = 2,
                    loader_worker_type: str = "process",
                    run: bool = True, **extra):
    """Build (and with ``run``, run) the UNet experiment; ``extra`` goes to
    the experiment (``device``, the ``eval_*`` options, ``progress``)."""
    train_data_config = DatasetConfig(
        split="train", crop_size=64, scaling_factor=4,
        lr_img_type="[0,1]", hr_img_type="[0,1]", is_augment=is_augment)
    eval_data_config = copy.deepcopy(train_data_config)
    eval_data_config.split = "eval|test"
    test_data_config = copy.deepcopy(train_data_config)
    test_data_config.split = "eval|test"

    folder = f"unet_loss({loss})_n({n_channels})_blocks({n_blocks})"
    model_config = UNetModelConfig(
        loader_workers=loader_workers,
        loader_worker_type=loader_worker_type,
        batch_size=batch_size, learning_rate=2e-5, min_learning_rate=1e-7,
        optimizer="Adam",
        optimizer_params={"weight_decay": 0, "betas": [0.9, 0.99]},
        loss_function=loss, epochs=epochs,
        checkpoint_folder=f"weights/{folder}",
        test_model_path=f"weights/{folder}/{test_model_name}",
        result_folder=f"results/{folder}", log_folder=f"logs/{folder}",
        train_data_folder=f"{data_root}/train",
        train_data_name_list=train_data_name_list or ["DIV2K_train_HR"],
        eval_data_folder=f"{data_root}/eval",
        eval_data_name_list=eval_data_name_list or ["DIV2K_valid_HR30"],
        test_data_folder=f"{data_root}/test",
        test_data_name_list=test_data_name_list or ["Set5"],
        image_in_channels=3, n_channels=n_channels, ch_mults=ch_mults,
        is_attn=is_attn, n_blocks=n_blocks, n_heads=n_heads)

    experiment = UNetExperiment(
        train_data_config=train_data_config, eval_data_config=eval_data_config,
        test_data_config=test_data_config, model_config=model_config,
        is_test=is_test, **extra)
    if run:
        try:
            experiment.run()
        finally:
            experiment.close()
    return experiment
