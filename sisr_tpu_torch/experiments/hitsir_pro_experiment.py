"""HiT-SIR-Pro PSNR experiment (port of
``sisr_tpu/experiments/hitsir_pro_experiment.py``; parity with the
reference's experiments/hitsir_pro_experiment.py:9-123): wires the
DatasetConfigs (crop 64, x4, [0,1], augment) and the HITModelConfig (Adam
betas (0.9, 0.99), cosine lr 2e-5 -> 1e-7, run-folder names encoding the
ablation flags)."""

from __future__ import annotations

import copy

import torch

from sisr_tpu_torch.configs.dataset_config import DatasetConfig
from sisr_tpu_torch.configs.hit_model_config import HITModelConfig
from sisr_tpu_torch.experiments.experiment import Experiment
from sisr_tpu_torch.models.hit_sir_pro import HiTSIR


class HITSIRPROExperiment(Experiment):
    def init_model(self):
        mc = self.model_config
        # the reference's initialization, drawn from seed 0 without
        # disturbing the caller's generator (the JAX runner inits from
        # PRNGKey(0)); a checkpoint, when there is one, replaces it
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = HiTSIR(
                is_mult_size_conv_feat_extract=mc.is_mult_size_conv_feat_extract,
                is_channel_spatial_attn=mc.is_channel_spatial_attn,
                is_fusion=mc.is_fusion,
                embed_dim=mc.embed_dim,
                base_win_size=tuple(mc.base_win_size),
                depths=tuple(mc.depths),
                num_heads=tuple(mc.num_heads),
                mlp_ratio=mc.mlp_ratio,
                upsampler=mc.upsampler,
                hier_win_ratios=tuple(mc.hier_win_ratios),
                upscale=mc.scaling_factor,
                dtype=getattr(torch, mc.compute_dtype),
            )
        self.model = model.to(self.device)
        super().init_model()


# the reference's default train sets of the PSNR experiment
PSNR_TRAIN_SETS = ["blend", "RealSR(V3)", "DIV2K_train_HR", "wuthering_wave", "Flickr2K_HR"]


def hitsir_pro_experiment(is_test: bool, **kwargs):
    """Build (and with ``run``, run) the PSNR experiment; the arguments
    are ``make_experiment``'s."""
    return make_experiment(HITSIRPROExperiment, "hitsir_pro", PSNR_TRAIN_SETS, is_test,
                           **kwargs)


def make_experiment(
    experiment_cls,
    name: str,
    default_train_sets,
    is_test: bool,
    loss: str,
    is_mult_size_conv_feat_extract: bool,
    is_channel_spatial_attn: bool,
    is_fusion: bool,
    epochs: int,
    is_augment,
    batch_size,
    test_model_name,
    embed_dim,
    base_win_size,
    depths,
    num_heads,
    mlp_ratio,
    upsampler,
    hier_win_ratios,
    data_root: str = "data",
    train_data_name_list=None,
    eval_data_name_list=None,
    test_data_name_list=None,
    loader_workers: int = 2,
    loader_worker_type: str = "process",
    run: bool = True,
    **extra,
):
    """Build (and with ``run``, run) ``experiment_cls`` with the
    reference's configs: the run folders named ``name`` and the flags, the
    train sets ``default_train_sets`` unless given; ``extra`` goes to the
    experiment (``device``, the ``eval_*`` options, ``progress``, and the
    GAN experiment's ``perceptual_weights_path``)."""
    train_data_config = DatasetConfig(
        split="train", crop_size=64, scaling_factor=4,
        lr_img_type="[0,1]", hr_img_type="[0,1]",
        is_lr_amplify=False, is_augment=is_augment)
    eval_data_config = copy.deepcopy(train_data_config)
    eval_data_config.split = "eval|test"
    test_data_config = copy.deepcopy(train_data_config)
    test_data_config.split = "eval|test"

    folder_name = (f"{name}_loss({loss})_mulsizeconvextract"
                   f"({is_mult_size_conv_feat_extract})_casa({is_channel_spatial_attn})"
                   f"{'_fusion' if is_fusion else ''}_embed_dim({embed_dim})"
                   f"_len(depths)({len(depths)})")
    if is_augment:
        folder_name += "_augment"

    model_config = HITModelConfig(
        batch_size=batch_size,
        learning_rate=2e-5,
        min_learning_rate=1e-7,
        optimizer="Adam",
        optimizer_params={"weight_decay": 0, "betas": [0.9, 0.99]},
        loss_function=loss,
        epochs=epochs,
        checkpoint_folder=f"weights/{folder_name}",
        test_model_path=f"weights/{folder_name}/{test_model_name}",
        result_folder=f"results/{folder_name}",
        log_folder=f"logs/{folder_name}",
        train_data_folder=f"{data_root}/train",
        train_data_name_list=train_data_name_list or list(default_train_sets),
        eval_data_folder=f"{data_root}/eval",
        eval_data_name_list=eval_data_name_list or ["DIV2K_valid_HR30"],
        test_data_folder=f"{data_root}/test",
        test_data_name_list=test_data_name_list or ["Set5"],
        is_mult_size_conv_feat_extract=is_mult_size_conv_feat_extract,
        is_channel_spatial_attn=is_channel_spatial_attn,
        is_fusion=is_fusion,
        in_channel=3,
        embed_dim=embed_dim,
        base_win_size=base_win_size,
        depths=depths,
        num_heads=num_heads,
        mlp_ratio=mlp_ratio,
        upsampler=upsampler,
        hier_win_ratios=hier_win_ratios,
        loader_workers=loader_workers,
        loader_worker_type=loader_worker_type,
    )

    experiment = experiment_cls(
        train_data_config=train_data_config,
        eval_data_config=eval_data_config,
        test_data_config=test_data_config,
        model_config=model_config,
        is_test=is_test,
        **extra,
    )
    if run:
        try:
            experiment.run()
        finally:
            experiment.close()
    return experiment
