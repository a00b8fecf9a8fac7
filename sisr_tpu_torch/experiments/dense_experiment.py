"""Dense (RDN-style) SR experiment (port of
``sisr_tpu/experiments/dense_experiment.py``; completes DenseModelConfig):
the same configs, defaults and run-folder names as the JAX experiment."""

from __future__ import annotations

import copy

import torch

from sisr_tpu_torch.configs.dataset_config import DatasetConfig
from sisr_tpu_torch.configs.dense_model_config import DenseModelConfig
from sisr_tpu_torch.experiments.experiment import Experiment
from sisr_tpu_torch.models.dense_sr import DenseSR


class DenseExperiment(Experiment):
    def init_model(self):
        mc = self.model_config
        # flax's initialization, drawn from seed 0 without disturbing the
        # caller's generator (the JAX runner inits from PRNGKey(0)); a
        # checkpoint, when there is one, replaces it
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = DenseSR(
                is_sa_attn=mc.is_sa_attn,
                is_fusion=mc.is_fusion,
                is_mult_size_conv_feat_extract=mc.is_mult_size_conv_feat_extract,
                num_blocks=tuple(mc.num_blocks),
                skip_blocks=tuple(mc.skip_blocks) if mc.skip_blocks else None,
                middle_channels=mc.middle_channels,
                in_channel=mc.in_channel,
                scale=mc.scaling_factor,
                dtype=getattr(torch, mc.compute_dtype),
            )
        self.model = model.to(self.device)
        super().init_model()


def dense_experiment(is_test: bool, loss: str = "l1", epochs: int = 400,
                     is_augment: bool = True, batch_size: int = 2,
                     test_model_name: str = "best_psnr_ssim_lpips_model.pth",
                     is_sa_attn: bool = True, is_fusion: bool = True,
                     is_mult_size_conv_feat_extract: bool = True,
                     num_blocks=(4, 4), skip_blocks=(0,),
                     middle_channels: int = 64, data_root: str = "data",
                     train_data_name_list=None, eval_data_name_list=None,
                     test_data_name_list=None, loader_workers: int = 2,
                     loader_worker_type: str = "process",
                     run: bool = True, **extra):
    """Build (and with ``run``, run) the Dense experiment; ``extra`` goes to
    the experiment (``device``, the ``eval_*`` options, ``progress``)."""
    train_data_config = DatasetConfig(
        split="train", crop_size=64, scaling_factor=4,
        lr_img_type="[0,1]", hr_img_type="[0,1]", is_augment=is_augment)
    eval_data_config = copy.deepcopy(train_data_config)
    eval_data_config.split = "eval|test"
    test_data_config = copy.deepcopy(train_data_config)
    test_data_config.split = "eval|test"

    folder = (f"dense_loss({loss})_sa({is_sa_attn})"
              f"{'_fusion' if is_fusion else ''}_c({middle_channels})")
    model_config = DenseModelConfig(
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
        is_sa_attn=is_sa_attn, is_fusion=is_fusion,
        is_mult_size_conv_feat_extract=is_mult_size_conv_feat_extract,
        num_blocks=list(num_blocks),
        skip_blocks=list(skip_blocks) if skip_blocks else None,
        middle_channels=middle_channels)

    experiment = DenseExperiment(
        train_data_config=train_data_config, eval_data_config=eval_data_config,
        test_data_config=test_data_config, model_config=model_config,
        is_test=is_test, **extra)
    if run:
        try:
            experiment.run()
        finally:
            experiment.close()
    return experiment
