"""HiT-SIR-Pro GAN fine-tune experiment (port of
``sisr_tpu/experiments/hitsir_pro_gan_experiment.py``).

Parity with reference experiments/hitsir_pro_gan_experiment.py:15-279:
  * UNet-SN discriminator with its own Adam + cosine schedule + checkpoint
    (``discriminator_new_epoch_model.pth``, ``{'start_epoch', 'model',
    'optimizer'}``, its model carrying the spectral norm's
    ``weight_u``/``weight_v``; its start_epoch drives resume)
  * G step: pixel + 1.0 * VGG19-perceptual + 0.1 * adversarial BCE
  * D step: BCE(real) + BCE(fake-detached), one optimizer step
  * the generator optimizer is NOT loaded on the first GAN epoch (the G
    weights are pre-seeded from a PSNR run as new_epoch_model.pth)

Both optimizer updates run in one eager step
(``train/train_state.py::make_gan_train_step``), the generator on its
kernels.  Under data parallelism the discriminator, its optimizer state
and the perceptual VGG19 are rank 0's on every rank (a random VGG19 drawn
per rank would give each rank another perceptual loss), D's gradients are
averaged as G's, and rank 0 alone reads and writes D's checkpoint.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from sisr_tpu_torch.configs.model_config import get_optimizer
from sisr_tpu_torch.experiments.hitsir_pro_experiment import HITSIRPROExperiment, make_experiment
from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN
from sisr_tpu_torch.models.vgg import PerceptualLoss, load_perceptual_state
from sisr_tpu_torch.parallel.mesh import process_zero, replicate
from sisr_tpu_torch.train import checkpoint as ckpt
from sisr_tpu_torch.train.train_state import (create_train_state, make_gan_train_step,
                                              set_learning_rate)
from sisr_tpu_torch.utils.meters import AverageMeter, format_str


class HITSIRPROGANExperiment(HITSIRPROExperiment):
    gan_mode = True

    def __init__(self, *args, perceptual_weights_path: Optional[str] = None, **kwargs):
        """``perceptual_weights_path``: torchvision's VGG19 state dict,
        ``torch.save``d; without it the perceptual loss runs on a random
        VGG19 and warns."""
        self._perceptual_weights_path = perceptual_weights_path
        super().__init__(*args, **kwargs)

    def init_model(self):
        super().init_model()
        # seeded apart from the caller's generator, as the generator's
        # (the JAX runner inits the discriminator from PRNGKey(1)); its
        # checkpoint, when there is one, replaces it
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            discriminator = UNetDiscriminatorSN()
        self.discriminator = discriminator.to(self.device).train()

    def init_tools(self):
        super().init_tools()
        self.epoch_discriminator_loss = AverageMeter()

    def init_optimizer_loss_function(self):
        super().init_optimizer_loss_function()
        mc = self.model_config
        d_tx = get_optimizer(mc.optimizer, self.discriminator.parameters(), mc.learning_rate,
                             mc.optimizer_params)
        self.d_state = create_train_state(self.discriminator, d_tx)

        state = load_perceptual_state(self._perceptual_weights_path) if process_zero() else None
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            perceptual = PerceptualLoss(state_dict=state)
        self.f_loss_function = replicate(self.mesh, perceptual.to(self.device))
        self.f_loss_function_weight = 1.0
        self.d_loss_function_weight = 0.1
        self.gan_step = make_gan_train_step(
            self.model, self.discriminator, self.loss_function, self.f_loss_function,
            self.state.optimizer, d_tx, perceptual_weight=self.f_loss_function_weight,
            adversarial_weight=self.d_loss_function_weight, mesh=self.mesh)

    def load_model_weights_scheduler(self, is_gan_start: bool = False):
        self.discriminator_pretrain_model_path = os.path.join(
            self.model_config.checkpoint_folder, "discriminator_new_epoch_model.pth")
        if process_zero() and os.path.exists(self.discriminator_pretrain_model_path):
            # the model (with the spectral norm's u, v) and the optimizer
            loaded = ckpt.load_checkpoint(self.discriminator_pretrain_model_path,
                                          self.discriminator, self.d_state.optimizer)
            self.start_epoch = loaded["start_epoch"] + 1
            print(f"loaded discriminator, trained epochs: {self.start_epoch - 1}")
        super().load_model_weights_scheduler(is_gan_start=self.start_epoch == 1)

    def _replicate_state(self):
        super()._replicate_state()
        replicate(self.mesh, self.discriminator)
        replicate(self.mesh, self.d_state.optimizer)

    def _sync_epoch_lr(self):
        super()._sync_epoch_lr()
        set_learning_rate(self.d_state.optimizer, self.current_lr())

    def train_batch(self, lr_imgs: torch.Tensor, hr_imgs: torch.Tensor):
        g_loss, d_loss = self.gan_step(lr_imgs, hr_imgs, self._generator)
        n = len(hr_imgs) * self.mesh.size
        self.epoch_loss.update(float(g_loss), n)
        self.epoch_discriminator_loss.update(float(d_loss), n)

    def train_steps(self):
        self.epoch_discriminator_loss.reset()
        yield from super().train_steps()

    def train_dataloader_process(self):
        super().train_dataloader_process()
        if process_zero():
            ckpt.save_checkpoint(self.discriminator_pretrain_model_path, self.start_epoch,
                                 self.discriminator, self.d_state.optimizer)
        self.loss_log[-1].append(f"d_loss:{self.epoch_discriminator_loss.avg}")
        lr = format_str(self.lr_schedule(self.start_epoch), 25)
        self.lr_log[-1] = f"epoch:{self.start_epoch + 1},lr:{lr}, discriminator_lr:{lr}"
        self._write_rows(self.loss_log_path, self.loss_log)
        self._write_rows(self.lr_log_path, [[row] for row in self.lr_log])


# the reference's default train sets of the GAN fine-tune
GAN_TRAIN_SETS = ["RealSR(V3)", "DIV2K_train_HR", "wuthering_wave", "Flickr2K_HR", "blend"]


def hitsir_pro_gan_experiment(is_test: bool, **kwargs):
    """Build (and with ``run``, run) the GAN experiment: the arguments of
    ``hitsir_pro_experiment.make_experiment``, plus
    ``perceptual_weights_path`` and ``lpips_weights_path``."""
    return make_experiment(HITSIRPROGANExperiment, "hitsir_pro_gan", GAN_TRAIN_SETS, is_test,
                           **kwargs)
