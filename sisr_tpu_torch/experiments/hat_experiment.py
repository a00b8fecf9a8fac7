"""HAT x4 PSNR experiment: HAT's ``train_HAT_SRx4_from_scratch.yml`` on the
shared ``Experiment`` (L1, Adam 2e-4 with betas (0.9, 0.99), no weight
decay, LR crops of 64 at x4 with flips and rotations).  The shared runner's
schedule is the cosine per epoch (to 1e-7), not HAT's halvings per
iteration, and it keeps no EMA of the weights.  Evaluation runs the whole
image through ``model(x)`` (the pixel-shuffle head), as HAT tests."""

from __future__ import annotations

import copy

import torch

from sisr_tpu_torch.configs.dataset_config import DatasetConfig
from sisr_tpu_torch.configs.hat_model_config import HATModelConfig
from sisr_tpu_torch.experiments.experiment import Experiment
from sisr_tpu_torch.models.hat import HAT


class HATExperiment(Experiment):
    def init_model(self):
        mc = self.model_config
        # HAT's initialization, drawn from seed 0 without disturbing the
        # caller's generator; a checkpoint, when there is one, replaces it
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = HAT(
                embed_dim=mc.embed_dim, depths=mc.depths, num_heads=mc.num_heads,
                window_size=mc.window_size, squeeze_factor=mc.squeeze_factor,
                mlp_ratio=mc.mlp_ratio, upscale=mc.scaling_factor,
                dtype=getattr(torch, mc.compute_dtype))
        self.model = model.to(self.device)
        super().init_model()


def hat_experiment(is_test: bool, loss: str = "l1", epochs: int = 400,
                   is_augment: bool = True, batch_size: int = 2,
                   test_model_name: str = "best_psnr_ssim_lpips_model.pth",
                   embed_dim: int = 180, depths=(6, 6, 6, 6, 6, 6),
                   num_heads=(6, 6, 6, 6, 6, 6), window_size: int = 16,
                   squeeze_factor: int = 30, mlp_ratio: float = 2.0,
                   data_root: str = "data", train_data_name_list=None,
                   eval_data_name_list=None, test_data_name_list=None,
                   loader_workers: int = 2, loader_worker_type: str = "process",
                   run: bool = True, **extra):
    """Build (and with ``run``, run) the HAT experiment; ``extra`` goes to
    the experiment (``device``, the ``eval_*`` options, ``progress``)."""
    train_data_config = DatasetConfig(
        split="train", crop_size=64, scaling_factor=4,
        lr_img_type="[0,1]", hr_img_type="[0,1]", is_augment=is_augment)
    eval_data_config = copy.deepcopy(train_data_config)
    eval_data_config.split = "eval|test"
    test_data_config = copy.deepcopy(train_data_config)
    test_data_config.split = "eval|test"

    folder = (f"hat_loss({loss})_embed_dim({embed_dim})_len(depths)({len(depths)})"
              f"_window({window_size})")
    model_config = HATModelConfig(
        loader_workers=loader_workers, loader_worker_type=loader_worker_type,
        batch_size=batch_size, learning_rate=2e-4, min_learning_rate=1e-7,
        optimizer="Adam", optimizer_params={"weight_decay": 0, "betas": [0.9, 0.99]},
        loss_function=loss, epochs=epochs,
        checkpoint_folder=f"weights/{folder}",
        test_model_path=f"weights/{folder}/{test_model_name}",
        result_folder=f"results/{folder}", log_folder=f"logs/{folder}",
        train_data_folder=f"{data_root}/train",
        train_data_name_list=train_data_name_list or ["DIV2K_train_HR", "Flickr2K_HR"],
        eval_data_folder=f"{data_root}/eval",
        eval_data_name_list=eval_data_name_list or ["DIV2K_valid_HR30"],
        test_data_folder=f"{data_root}/test",
        test_data_name_list=test_data_name_list or ["Set5"],
        embed_dim=embed_dim, depths=depths, num_heads=num_heads, window_size=window_size,
        squeeze_factor=squeeze_factor, mlp_ratio=mlp_ratio)

    experiment = HATExperiment(
        train_data_config=train_data_config, eval_data_config=eval_data_config,
        test_data_config=test_data_config, model_config=model_config,
        is_test=is_test, **extra)
    if run:
        try:
            experiment.run()
        finally:
            experiment.close()
    return experiment
