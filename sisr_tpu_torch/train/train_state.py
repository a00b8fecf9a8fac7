"""Training steps (port of ``sisr_tpu/train/train_state.py``: PSNR mode
and GAN mode).

The reference's epoch loop calls zero_grad / backward / step per batch
(experiments/experiment.py:364-380; GAN variant
hitsir_pro_gan_experiment.py:117-165).  The JAX package does the same in
one jitted function of (state, batch, rng); here the step is eager: the
forward with ``deterministic=False`` (the kernels forward, their
``torch.autograd.Function``s backward), ``loss.backward()``, then the
optimizer's update in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from sisr_tpu_torch.train.losses import gan_loss


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


def gan_generator_loss(sr: torch.Tensor, hr_imgs: torch.Tensor, d_model: nn.Module,
                       pixel_loss: Callable, perceptual_loss: Optional[Callable],
                       perceptual_weight: float = 1.0,
                       adversarial_weight: float = 0.1) -> torch.Tensor:
    """The generator's loss: pixel + w_p * perceptual + w_a * BCE(D(sr), real)."""
    loss = pixel_loss(sr, hr_imgs)
    if perceptual_loss is not None:
        loss = loss + perceptual_weight * perceptual_loss(sr, hr_imgs)
    return loss + adversarial_weight * gan_loss(d_model(sr), True)


def gan_discriminator_backward(d_model: nn.Module, hr_imgs: torch.Tensor,
                               sr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """BCE(D(hr), real) and BCE(D(sr detached), fake), each run backward
    into D's gradients, as the reference does; returns both, detached."""
    l_real = gan_loss(d_model(hr_imgs), True)
    l_real.backward()
    l_fake = gan_loss(d_model(sr.detach()), False)
    l_fake.backward()
    return l_real.detach(), l_fake.detach()


def make_gan_train_step(
    g_model: nn.Module,
    d_model: nn.Module,
    pixel_loss: Callable,
    perceptual_loss: Optional[Callable],
    g_optimizer: torch.optim.Optimizer,
    d_optimizer: torch.optim.Optimizer,
    perceptual_weight: float = 1.0,
    adversarial_weight: float = 0.1,
    reference: bool = False,
) -> Callable:
    """Real-ESRGAN-style two-optimizer step (hitsir_pro_gan_experiment.py
    :117-165, JAX ``make_gan_train_step``):
    ``step(lr_imgs, hr_imgs, generator) -> (g_loss, d_loss)``.

      G: loss = pixel + w_p * perceptual + w_a * BCE(D(sr), real), with
         D's parameters taking no gradient (its train-mode forward still
         advances u, v, as torch's does); then G's optimizer step.
      D: BCE(D(hr), real) + BCE(D(sr detached), fake), u, v advancing on
         both forwards; then D's optimizer step.

    Returns G's loss over the sum of the loss weights and the mean of D's
    two losses, as the reference logs them.  ``reference=True`` runs the
    generator's plain versions instead of its kernels."""

    def step(lr_imgs: torch.Tensor, hr_imgs: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        g_optimizer.zero_grad(set_to_none=True)
        d_model.requires_grad_(False)
        try:
            sr = g_model(lr_imgs, reference=reference, deterministic=False)
            g_loss = gan_generator_loss(sr, hr_imgs, d_model, pixel_loss, perceptual_loss,
                                        perceptual_weight, adversarial_weight)
            g_loss.backward()
        finally:
            d_model.requires_grad_(True)
        g_optimizer.step()

        d_optimizer.zero_grad(set_to_none=True)
        l_real, l_fake = gan_discriminator_backward(d_model, hr_imgs, sr)
        d_optimizer.step()
        return (g_loss.detach() / (1.0 + perceptual_weight + adversarial_weight),
                (l_real + l_fake) / 2.0)

    return step


def make_eval_step(model: nn.Module) -> Callable:
    """Forward + clip to [0, 1] (reference experiment.py:746-748)."""

    def step(lr_imgs: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(lr_imgs).clamp(0.0, 1.0)

    return step
