"""The GAN fine-tune's generator step in bfloat16 on the CPU: the
generator (``test_model_parity.py``'s ``tiny_full``) in bfloat16, the
discriminator and a VGG19 at 1/8 of its widths in float32, as JAX's GAN
experiment builds them.  The generator's loss (L1 + perceptual + 0.1 x
adversarial, ``gan_generator_loss``) and every generator gradient against
the port's float32 step, which ``test_torch_gan.py`` holds to JAX's, at
``test_torch_bf16_train.py``'s bar: JAX's bfloat16 generator on the same
weights and batch gives the noise its bar allows.  Each evaluation starts
from the same discriminator state (its train-mode forward advances u, v).
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from test_model_parity import CASES
from test_torch_bf16_train import check_bf16
from test_torch_gan import _cfg8, _settled, _state
from test_torch_train import UNUSED

torch.set_num_threads(1)


def test_gan_generator_bf16_step_matches_jax_bf16_step():
    from sisr_tpu.models.discriminator import UNetDiscriminatorSN as JaxD
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu.models.vgg import PerceptualLoss as JaxPerceptual
    from sisr_tpu.models.vgg import VGGFeatures as JaxVGG
    from sisr_tpu.train.losses import gan_loss as jax_gan_loss, l1_loss as jax_l1
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR
    from sisr_tpu_torch.models.jax_port import (discriminator_state_dict_from_jax,
                                                state_dict_from_jax, vgg_state_dict_from_jax)
    from sisr_tpu_torch.models.vgg import VGG19_CFG, PerceptualLoss
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import gan_generator_loss

    cfg, cfg19, ndf = CASES["tiny_full"], _cfg8(VGG19_CFG), 16
    rng = np.random.default_rng(8)
    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    y = rng.random((2, 64, 64, 3), dtype=np.float32)
    jg, jd = JaxHiTSIR(**cfg, dtype=jnp.bfloat16), JaxD(ndf=ndf)
    g_params = jg.init(jax.random.PRNGKey(9), jnp.asarray(x))["params"]
    d_vars = _settled(jd, jd.init(jax.random.PRNGKey(10), jnp.asarray(y)), jnp.asarray(y))
    v_vars = JaxVGG(cfg=cfg19).init(jax.random.PRNGKey(11), jnp.asarray(y))
    jperceptual = JaxPerceptual(v_vars, cfg=cfg19)

    def g_loss_of(params):
        sr = jg.apply({"params": params}, jnp.asarray(x), deterministic=False,
                      rngs={"dropout": jax.random.PRNGKey(0)})
        loss = jax_l1(sr, jnp.asarray(y)) + jperceptual(sr, jnp.asarray(y))
        logits, _ = jd.apply(d_vars, sr, True, mutable=["spectral"])
        return loss + 0.1 * jax_gan_loss(logits, True)

    jloss, jgrads = jax.value_and_grad(g_loss_of)(g_params)
    ref = {k: np.asarray(v, np.float64) for k, v in state_dict_from_jax(jgrads).items()
           if k not in UNUSED}

    g = HiTSIR(**cfg)
    g.load_state_dict(_state(state_dict_from_jax(g_params)), strict=True)
    d0 = UNetDiscriminatorSN(ndf=ndf).train()
    d0.load_state_dict(_state(discriminator_state_dict_from_jax(d_vars["params"],
                                                                d_vars["spectral"])), strict=True)
    perceptual = PerceptualLoss(_state(vgg_state_dict_from_jax(v_vars, cfg19)), cfg=cfg19)
    loss_fn = lambda sr, hr: gan_generator_loss(sr, hr, copy.deepcopy(d0), l1_loss, perceptual)
    check_bf16(g, x, y, float(jloss), ref, loss_fn)
