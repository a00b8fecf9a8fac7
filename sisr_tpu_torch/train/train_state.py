"""Training steps (port of ``sisr_tpu/train/train_state.py``: PSNR mode
and GAN mode).

The reference's epoch loop calls zero_grad / backward / step per batch
(experiments/experiment.py:364-380; GAN variant
hitsir_pro_gan_experiment.py:117-165).  The JAX package does the same in
one jitted function of (state, batch, rng); here the step is eager: the
forward with ``deterministic=False`` (the kernels forward, their
``torch.autograd.Function``s backward), ``loss.backward()``, then the
optimizer's update in place.

Data parallelism (JAX: the batch sharded on the mesh's ``data`` axis, XLA's
gradient all-reduce) is written out: with a ``mesh`` each rank runs its
slice of the global batch, ``all_reduce_grads`` averages the gradients
after each backward, before the optimizer's step, and the returned losses
are the global batch's (``all_reduce_mean``); the dropout masks are drawn
at the global batch's shape from the step's generator, and each rank keeps
its rows (``ops/dropout.py``), so N ranks seeded alike drop what one
process drops over the whole batch.  No
``DistributedDataParallel``: the GAN step runs two backwards into D and
toggles its ``requires_grad``, spectral norm updates ``u``, ``v`` in place,
the kernels' backward recomputes plain forwards, and gloo offers only
all_reduce and broadcast for CUDA tensors.  A one-rank mesh (or none)
runs the same code with no collective.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from sisr_tpu_torch.ops.dropout import DropoutRng
from sisr_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, all_reduce_mean
from sisr_tpu_torch.train.losses import gan_loss
from sisr_tpu_torch.utils.profiling import span


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


def _global(mesh: Optional[Mesh], loss: torch.Tensor) -> torch.Tensor:
    """The loss of the global batch: the mean over the ranks."""
    return loss.detach() if mesh is None else all_reduce_mean(mesh, loss)


def _dropout_rng(mesh: Optional[Mesh], generator: Optional[torch.Generator]) -> DropoutRng:
    """The step's generator with this rank's slice of the global batch."""
    return DropoutRng(generator) if mesh is None else DropoutRng(generator, mesh.rank,
                                                                 mesh.size)


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Pixel-loss train step: ``step(lr_imgs, hr_imgs, generator) -> loss``
    on NHWC batches, updating the model's parameters in place.
    ``generator`` stands where JAX's step takes its dropout key: every
    dropout mask of the forward is drawn from it (None: torch's default
    generator, as the reference's ``nn.Dropout``), and with a generator the
    default generators are left as they were.  A bfloat16 model returns a
    bfloat16 SR, and the loss against the float32 HR promotes it to
    float32, as JAX's does; parameters and the optimizer's state stay
    float32, with no loss scaling (JAX has none).  With a ``mesh`` the
    batch is this rank's slice, the gradients are averaged over the ranks
    and the loss is the global batch's."""

    def step(lr_imgs: torch.Tensor, hr_imgs: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with span("step.forward"):
            sr = model(lr_imgs, deterministic=False, generator=_dropout_rng(mesh, generator))
            loss = loss_fn(sr, hr_imgs)
        with span("step.backward"):
            loss.backward()
        if mesh is not None:
            all_reduce_grads(mesh, model.parameters())
        optimizer.step()
        return _global(mesh, loss)

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
    mesh: Optional[Mesh] = None,
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
    two losses, as the reference logs them.  ``generator`` as
    ``make_train_step``'s.  A bfloat16 generator's SR goes to the float32
    discriminator and VGG19 as it is: each casts its input to its
    parameters' float32 where JAX's does (the VGG after its input norm).
    With a ``mesh`` each network's gradients are averaged over the ranks
    before its optimizer's step (D's after both of its backwards), and the
    losses are the global batch's."""

    def step(lr_imgs: torch.Tensor, hr_imgs: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        g_optimizer.zero_grad(set_to_none=True)
        d_model.requires_grad_(False)
        try:
            with span("step.forward"):
                sr = g_model(lr_imgs, deterministic=False,
                             generator=_dropout_rng(mesh, generator))
                g_loss = gan_generator_loss(sr, hr_imgs, d_model, pixel_loss,
                                            perceptual_loss, perceptual_weight,
                                            adversarial_weight)
            with span("step.backward"):
                g_loss.backward()
        finally:
            d_model.requires_grad_(True)
        if mesh is not None:
            all_reduce_grads(mesh, g_model.parameters())
        g_optimizer.step()

        d_optimizer.zero_grad(set_to_none=True)
        l_real, l_fake = gan_discriminator_backward(d_model, hr_imgs, sr)
        if mesh is not None:
            all_reduce_grads(mesh, d_model.parameters())
        d_optimizer.step()
        return (_global(mesh, g_loss) / (1.0 + perceptual_weight + adversarial_weight),
                _global(mesh, (l_real + l_fake) / 2.0))

    return step


def make_eval_step(model: nn.Module) -> Callable:
    """Forward + clip to [0, 1] (reference experiment.py:746-748)."""

    def step(lr_imgs: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(lr_imgs).clamp(0.0, 1.0)

    return step
