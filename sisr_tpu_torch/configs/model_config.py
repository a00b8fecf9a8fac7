"""Experiment/model configuration and the optimizer, loss and schedule
factories: port of ``sisr_tpu/configs/model_config.py`` (field parity with
the reference's configs/model_config.py) on torch.optim.

* ``get_optimizer``     Adam (``AdamW`` when ``weight_decay`` is set, as
  the JAX package's ``optax.adamw``), betas and eps as passed
* ``get_loss_function`` mse / l1 / charbonnier
* ``get_scheduler``     cosine annealing stepped once per epoch, the closed
  form of torch's CosineAnnealingLR (copied from the JAX package), so that
  a resume from an epoch matches (reference experiments/experiment.py:
  247-252 rebuilds the scheduler with last_epoch = start_epoch - 2);
  ``train_state.set_learning_rate`` applies it
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Iterable, List, Optional

import torch

from sisr_tpu_torch.parallel.mesh import process_zero

optimizers = ["Adam"]
loss_functions = ["mse", "l1", "charbonnier"]


def get_scheduler(base_lr: float, min_lr: float, epochs: int) -> Callable[[int], float]:
    """Returns epoch_index (0-based) -> lr, torch CosineAnnealingLR closed form.

    Epoch e (1-based) trains with lr(e-1); schedule period T_max = epochs.
    """

    def lr(epoch_idx: int) -> float:
        return min_lr + (base_lr - min_lr) * (1 + math.cos(math.pi * epoch_idx / epochs)) / 2

    return lr


def get_optimizer(optimizer_name: str, params: Iterable[torch.nn.Parameter], lr: float,
                  kwarg: Optional[Dict] = None) -> torch.optim.Optimizer:
    """Adam over ``params`` with the reference's keyword arguments
    (``betas``, ``eps``, ``weight_decay``); a nonzero ``weight_decay`` is
    decoupled (AdamW), as the JAX package's ``optax.adamw``."""
    if optimizer_name not in optimizers:
        raise ValueError(f"optimizer must be in {optimizers}, got {optimizer_name!r}")
    kwarg = dict(kwarg or {})
    betas = tuple(kwarg.pop("betas", (0.9, 0.999)))
    weight_decay = kwarg.pop("weight_decay", 0.0)
    eps = kwarg.pop("eps", 1e-8)
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)


def get_loss_function(loss_function_name: str) -> Callable:
    """Pixel loss on (pred, target) tensors, mean-reduced."""
    from sisr_tpu_torch.train.losses import charbonnier_loss, l1_loss, mse_loss

    if loss_function_name not in loss_functions:
        raise ValueError(f"loss_function must be in {loss_functions}, "
                         f"got {loss_function_name!r}")
    return {"mse": mse_loss, "l1": l1_loss, "charbonnier": charbonnier_loss}[loss_function_name]


class ModelConfig:
    def __init__(
        self,
        batch_size: int,
        learning_rate: float,
        min_learning_rate: float,
        optimizer: str,
        optimizer_params: dict,
        loss_function: str,
        epochs: int,
        checkpoint_folder: str,
        test_model_path: str,
        result_folder: str,
        log_folder: str,
        train_data_folder: str,
        train_data_name_list: List[str],
        eval_data_folder: str,
        eval_data_name_list: List[str],
        test_data_folder: str,
        test_data_name_list: List[str],
        compute_dtype: str = "float32",
        loader_workers: int = 2,
        loader_worker_type: str = "process",
    ):
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.optimizer = optimizer
        self.optimizer_params = optimizer_params
        self.loss_function = loss_function
        self.epochs = epochs
        self.checkpoint_folder = checkpoint_folder
        self.test_model_path = test_model_path
        self.result_folder = result_folder
        self.log_folder = log_folder
        self.train_data_folder = train_data_folder
        self.train_data_name_list = train_data_name_list
        self.eval_data_folder = eval_data_folder
        self.eval_data_name_list = eval_data_name_list
        self.test_data_folder = test_data_folder
        self.test_data_name_list = test_data_name_list
        self.compute_dtype = compute_dtype
        self.loader_workers = loader_workers
        self.loader_worker_type = loader_worker_type

        if self.loader_worker_type not in ("thread", "process"):
            raise ValueError("loader_worker_type must be 'thread' or 'process'")
        if self.optimizer not in optimizers:
            raise ValueError(f"optimizer must be in {optimizers}")
        if self.loss_function not in loss_functions:
            raise ValueError(f"loss_function must be in {loss_functions}")

        # rank 0 alone makes folders under data parallelism
        for folder in (self.checkpoint_folder, self.result_folder, self.log_folder):
            if folder is not None and process_zero():
                os.makedirs(folder, exist_ok=True)

        for lst, label in ((train_data_name_list, "train"),
                           (eval_data_name_list, "eval"),
                           (test_data_name_list, "test")):
            if not lst:
                raise ValueError(f"{label}_data_name_list must be a non-empty list")

        self.train_data_path_list = [os.path.join(train_data_folder, n)
                                     for n in train_data_name_list]
        self.eval_data_path_list = [os.path.join(eval_data_folder, n)
                                    for n in eval_data_name_list]
        self.test_data_path_list = [os.path.join(test_data_folder, n)
                                    for n in test_data_name_list]
