"""Training steps (port of ``sisr_tpu/train/train_state.py``, PSNR mode).

The reference's epoch loop calls zero_grad / backward / step per batch
(experiments/experiment.py:364-380).  The JAX package does the same in one
jitted function of (state, batch, rng); here the step is eager: the forward
with ``deterministic=False`` (the kernels forward, their
``torch.autograd.Function``s backward), ``loss.backward()``, then the
optimizer's update in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn


class TrainState(NamedTuple):
    model: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model: nn.Module, tx: torch.optim.Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=tx)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every parameter group's learning rate, as the per-epoch cosine
    schedule (``configs.model_config.get_scheduler``) asks."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer, reference: bool = False) -> Callable:
    """Pixel-loss train step: ``step(lr_imgs, hr_imgs, generator) -> loss``
    on NHWC batches, updating the model's parameters in place.
    ``generator`` stands where JAX's step takes its dropout key: no layer of
    the port draws random numbers yet.  ``reference=True`` runs the plain
    versions instead of the kernels (the yardstick on the card)."""

    def step(lr_imgs: torch.Tensor, hr_imgs: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        sr = model(lr_imgs, reference=reference, deterministic=False)
        loss = loss_fn(sr, hr_imgs)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_eval_step(model: nn.Module) -> Callable:
    """Forward + clip to [0, 1] (reference experiment.py:746-748)."""

    def step(lr_imgs: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(lr_imgs).clamp(0.0, 1.0)

    return step
