"""DAT x4 PSNR experiment: DAT's ``train_DAT_x4.yml`` on the shared
``Experiment`` (L1, Adam 2e-4 with betas (0.9, 0.99), no weight decay, LR
crops of 64 at x4 with flips and rotations).  The shared runner's schedule
is the cosine per epoch (to 1e-7), not DAT's halvings per iteration; it
keeps no EMA of the weights, and DAT's stochastic depth (drop_path 0.1) is
not ported.  Evaluation runs the whole image through ``model(x)`` (the
``_whole_eval`` path), as DAT tests, so the channel attention sees the
whole image."""

from __future__ import annotations

import copy

import torch

from sisr_tpu_torch.configs.dataset_config import DatasetConfig
from sisr_tpu_torch.configs.dat_model_config import DATModelConfig
from sisr_tpu_torch.experiments.experiment import Experiment
from sisr_tpu_torch.models.dat import DAT


class DATExperiment(Experiment):
    def init_model(self):
        mc = self.model_config
        # DAT's initialization, drawn from seed 0 without disturbing the
        # caller's generator; a checkpoint, when there is one, replaces it
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = DAT(
                embed_dim=mc.embed_dim, depth=mc.depths, num_heads=mc.num_heads,
                split_size=mc.split_size, expansion_factor=mc.expansion_factor,
                upscale=mc.scaling_factor, dtype=getattr(torch, mc.compute_dtype))
        self.model = model.to(self.device)
        super().init_model()


def dat_experiment(is_test: bool, loss: str = "l1", epochs: int = 400,
                   is_augment: bool = True, batch_size: int = 2,
                   test_model_name: str = "best_psnr_ssim_lpips_model.pth",
                   embed_dim: int = 180, depths=(6, 6, 6, 6, 6, 6),
                   num_heads=(6, 6, 6, 6, 6, 6), split_size=(8, 32),
                   expansion_factor: float = 4.0,
                   data_root: str = "data", train_data_name_list=None,
                   eval_data_name_list=None, test_data_name_list=None,
                   loader_workers: int = 2, loader_worker_type: str = "process",
                   run: bool = True, **extra):
    """Build (and with ``run``, run) the DAT experiment; ``extra`` goes to
    the experiment (``device``, the ``eval_*`` options, ``progress``)."""
    train_data_config = DatasetConfig(
        split="train", crop_size=64, scaling_factor=4,
        lr_img_type="[0,1]", hr_img_type="[0,1]", is_augment=is_augment)
    eval_data_config = copy.deepcopy(train_data_config)
    eval_data_config.split = "eval|test"
    test_data_config = copy.deepcopy(train_data_config)
    test_data_config.split = "eval|test"

    folder = (f"dat_loss({loss})_embed_dim({embed_dim})_len(depths)({len(depths)})"
              f"_split({split_size[0]}x{split_size[1]})")
    model_config = DATModelConfig(
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
        embed_dim=embed_dim, depths=depths, num_heads=num_heads, split_size=split_size,
        expansion_factor=expansion_factor)

    experiment = DATExperiment(
        train_data_config=train_data_config, eval_data_config=eval_data_config,
        test_data_config=test_data_config, model_config=model_config,
        is_test=is_test, **extra)
    if run:
        try:
            experiment.run()
        finally:
            experiment.close()
    return experiment
