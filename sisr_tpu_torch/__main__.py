"""Train/test dispatcher of the port (the root ``main.py``'s command line,
plus ``--device``):

    python -m sisr_tpu_torch hitsir_pro --epochs 400 --batch-size 2
    python -m sisr_tpu_torch hitsir_pro --test --test-model best_psnr_ssim_lpips_model.pth
    python -m sisr_tpu_torch hitsir_pro --device cpu ...   # without a card
    python -m sisr_tpu_torch hitsir_pro_gan --epochs 10    # the GAN fine-tune
    python -m sisr_tpu_torch hat --batch-size 4            # HAT x4 (its widths)
    python -m sisr_tpu_torch dat --batch-size 4            # DAT x4 (its widths)

Runs on the card (``--device cuda``) unless asked for the CPU.  ``main``
also takes "unet" and "dense" (the UNet and Dense families' experiments,
their keyword arguments, a None dropped), as root ``main.py``'s does; its
command line offers the two HiT-SIR experiments, HAT and DAT.  For "hat" the
HiT-SIR-only options are dropped; ``--embed-dim``, ``--depths``,
``--num-heads`` and ``--mlp-ratio`` set HAT's widths (their defaults are
HAT x4's; its window stays 16).  For "dat" ``--mlp-ratio`` is dropped too:
``--embed-dim``, ``--depths`` and ``--num-heads`` set DAT's widths (its
split size stays 8 x 32 and its expansion factor 4).
"""

from __future__ import annotations

import argparse


# the command line's options that only the HiT-SIR experiments read
HIT_ONLY = ("is_mult_size_conv_feat_extract", "is_channel_spatial_attn", "is_fusion",
            "base_win_size", "upsampler", "hier_win_ratios")


def main(model_name: str, is_test: bool, **kwargs):
    if model_name == "hitsir_pro":
        from sisr_tpu_torch.experiments.hitsir_pro_experiment import hitsir_pro_experiment

        return hitsir_pro_experiment(is_test, **kwargs)
    if model_name == "hitsir_pro_gan":
        from sisr_tpu_torch.experiments.hitsir_pro_gan_experiment import (
            hitsir_pro_gan_experiment)

        return hitsir_pro_gan_experiment(is_test, **kwargs)
    if model_name == "hat":
        from sisr_tpu_torch.experiments.hat_experiment import hat_experiment

        return hat_experiment(is_test, **{k: v for k, v in kwargs.items()
                                          if k not in HIT_ONLY and v is not None})
    if model_name == "dat":
        from sisr_tpu_torch.experiments.dat_experiment import dat_experiment

        return dat_experiment(is_test, **{k: v for k, v in kwargs.items()
                                          if k not in HIT_ONLY + ("mlp_ratio",)
                                          and v is not None})
    if model_name == "unet":
        from sisr_tpu_torch.experiments.unet_experiment import unet_experiment

        return unet_experiment(is_test, **{k: v for k, v in kwargs.items() if v is not None})
    if model_name == "dense":
        from sisr_tpu_torch.experiments.dense_experiment import dense_experiment

        return dense_experiment(is_test, **{k: v for k, v in kwargs.items() if v is not None})
    raise ValueError(f"unknown experiment {model_name!r}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m sisr_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", choices=["hitsir_pro", "hitsir_pro_gan", "hat", "dat"])
    p.add_argument("--test", action="store_true")
    p.add_argument("--loss", default="l1", choices=["l1", "mse", "charbonnier"])
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--embed-dim", type=int, default=180)
    p.add_argument("--depths", type=int, nargs="+", default=[6] * 6)
    p.add_argument("--num-heads", type=int, nargs="+", default=[6] * 6)
    p.add_argument("--mlp-ratio", type=float, default=2)
    p.add_argument("--upsampler", default="nearest+conv")
    p.add_argument("--hier-win-ratios", type=float, nargs="+",
                   default=[0.5, 1, 2, 4, 6, 8, 10, 12])
    p.add_argument("--base-win-size", type=int, nargs=2, default=[8, 8])
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--no-msce", action="store_true",
                   help="disable multi-size conv extraction")
    p.add_argument("--no-casa", action="store_true",
                   help="disable channel-spatial attention in qkv")
    p.add_argument("--no-fusion", action="store_true")
    p.add_argument("--test-model", default="best_psnr_ssim_lpips_model.pth")
    p.add_argument("--loader-workers", type=int, default=2,
                   help="host data-loader workers for the train split")
    p.add_argument("--loader-worker-type", default="process",
                   choices=["thread", "process"],
                   help="train-loader worker pool kind (process scales the "
                        "BSRGAN degradation with host cores)")
    p.add_argument("--eval-precision", default="fast", choices=["fast", "exact"],
                   help="'exact' evaluates in float32 with TF32 off, the kernels on")
    p.add_argument("--data-root", default="data")
    p.add_argument("--train-sets", nargs="+", default=None)
    p.add_argument("--eval-sets", nargs="+", default=None)
    p.add_argument("--test-sets", nargs="+", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p.parse_args(argv)


def experiment_kwargs(args: argparse.Namespace) -> dict:
    """The keyword arguments ``main`` passes on for parsed ``args`` (root
    main.py's mapping, plus ``device``)."""
    return dict(
        is_test=args.test,
        is_augment=not args.no_augment,
        loss=args.loss,
        is_mult_size_conv_feat_extract=not args.no_msce,
        is_channel_spatial_attn=not args.no_casa,
        is_fusion=not args.no_fusion,
        epochs=args.epochs,
        batch_size=args.batch_size,
        test_model_name=args.test_model,
        embed_dim=args.embed_dim,
        base_win_size=args.base_win_size,
        depths=args.depths,
        num_heads=args.num_heads,
        mlp_ratio=args.mlp_ratio,
        upsampler=args.upsampler,
        hier_win_ratios=args.hier_win_ratios,
        data_root=args.data_root,
        train_data_name_list=args.train_sets,
        eval_data_name_list=args.eval_sets,
        test_data_name_list=args.test_sets,
        loader_workers=args.loader_workers,
        loader_worker_type=args.loader_worker_type,
        eval_precision=args.eval_precision,
        device=args.device,
    )


def cli(argv=None):
    args = parse_args(argv)
    return main(args.model, **experiment_kwargs(args))


if __name__ == "__main__":
    cli()
