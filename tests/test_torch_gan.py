"""The port's GAN fine-tune components against the reference's goldens and
the JAX package, on the CPU at small sizes.

- ``UNetDiscriminatorSN``: the reference's ``discriminator_unet.npz``
  (loads strictly, 4,376,897 parameters, eval output max abs < 1e-4); the
  power iteration of a train-mode forward; the JAX module from its own
  parameters and u, v (``discriminator_state_dict_from_jax``).
- ``VGGFeatures`` / ``PerceptualLoss`` / ``LPIPSVgg``: the random-weight
  goldens (``vgg19_random.npz``: taps atol 1e-5 / rtol 1e-4, the loss
  1e-6 / 1e-4; ``lpips_vgg_random.npz``: 1e-6 / 1e-4), and JAX's modules
  from their parameters (``vgg_state_dict_from_jax``,
  ``lpips_state_dict_from_jax``).
- Four generator steps of the composite loss (``gan_train_steps_tiny_full
  .npz``, rtol 3e-4 / atol 1e-6) and four discriminator steps with the end
  parameters and u, v (``gan_d_steps.npz``: losses rtol 3e-4, state 5e-5 /
  1e-3): test_gan_components.py's bars.
- ``make_gan_train_step`` against JAX's from the same state for 2 steps:
  g_loss and d_loss within 1e-4 relative, the discriminator's state at the
  D steps' bar.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_model_parity import CASES

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"


def _cfg8(cfg):
    """A torchvision VGG cfg at 1/8 of its widths (the goldens' towers)."""
    return tuple(c if c == "M" else c // 8 for c in cfg)


def _pick(blob, prefix):
    return {k[len(prefix):]: torch.from_numpy(np.array(blob[k])) for k in blob.files
            if k.startswith(prefix)}


def _nhwc(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1)))


def _state(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


# ------------------------------------------------------------------ discriminator

def test_discriminator_matches_reference_golden():
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN

    blob = np.load(GOLDEN / "discriminator_unet.npz")
    d = UNetDiscriminatorSN()
    assert sum(p.numel() for p in d.parameters()) == 4_376_897
    d.load_state_dict(_pick(blob, "sd__"), strict=True)
    d.eval()
    with torch.no_grad():
        y = d(_nhwc(blob["input"])).numpy().transpose(0, 3, 1, 2)
    assert y.shape == blob["output"].shape
    err = np.abs(y - blob["output"]).max()
    assert err < 1e-4, f"max abs err {err:.3e}"


def test_spectral_norm_power_iteration_updates():
    """A train-mode forward advances u (kept at unit norm); an eval-mode
    forward leaves it."""
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN

    torch.manual_seed(0)
    d = UNetDiscriminatorSN()
    x = torch.ones(1, 16, 16, 3)
    u0 = d.conv1.weight_u.clone()
    d.eval()
    with torch.no_grad():
        d(x)
    assert torch.equal(d.conv1.weight_u, u0)
    d.train()
    with torch.no_grad():
        d(x)
    u1 = d.conv1.weight_u
    assert not torch.allclose(u0, u1)
    assert abs(float(u1.norm()) - 1.0) < 1e-5


def _settled(jd, variables, x, n: int = 10):
    """JAX's discriminator variables after ``n`` train-mode forwards: the
    power iteration converged, as the goldens' (a fresh u, v estimates
    sigma far too small, and the logits run to 1e10)."""
    for _ in range(n):
        _, spectral = jd.apply(variables, x, True, mutable=["spectral"])
        variables = {"params": variables["params"], **spectral}
    return variables


def _jax_discriminator(ndf, x):
    from sisr_tpu.models.discriminator import UNetDiscriminatorSN as JaxD
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN
    from sisr_tpu_torch.models.jax_port import discriminator_state_dict_from_jax

    jd = JaxD(ndf=ndf)
    variables = _settled(jd, jd.init(jax.random.PRNGKey(2), jnp.asarray(x)), jnp.asarray(x))
    d = UNetDiscriminatorSN(ndf=ndf)
    d.load_state_dict(_state(discriminator_state_dict_from_jax(
        variables["params"], variables["spectral"])), strict=True)
    return jd, variables, d


def test_discriminator_matches_jax():
    """From JAX's parameters and u, v: the eval output, then a train-mode
    forward's output and its advanced u, v."""
    x = np.random.default_rng(3).random((2, 32, 24, 3), dtype=np.float32)
    jd, variables, d = _jax_discriminator(16, x)
    d.eval()
    with torch.no_grad():
        got = d(torch.from_numpy(x)).numpy()
    ref = np.asarray(jd.apply(variables, jnp.asarray(x), False))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    d.train()
    with torch.no_grad():
        got = d(torch.from_numpy(x)).numpy()
    ref, mutated = jd.apply(variables, jnp.asarray(x), True, mutable=["spectral"])
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-4)
    for i in range(1, 9):
        conv = getattr(d, f"conv{i}")
        for leaf in ("u", "v"):
            np.testing.assert_allclose(getattr(conv, f"weight_{leaf}").numpy(),
                                       np.asarray(mutated["spectral"][f"conv{i}"][leaf]),
                                       atol=1e-6, rtol=1e-4)


# ----------------------------------------------------------------- VGG and LPIPS

@pytest.fixture(scope="module")
def vgg19_golden():
    return np.load(GOLDEN / "vgg19_random.npz")


def _golden_vgg_state(z):
    return {k[len("sd."):]: torch.from_numpy(np.array(z[k])) for k in z.files
            if k.startswith("sd.features.")}


def test_vgg19_taps_match_golden(vgg19_golden):
    from sisr_tpu_torch.models.vgg import VGG19_CFG, VGGFeatures

    z = vgg19_golden
    model = VGGFeatures(cfg=_cfg8(VGG19_CFG), taps=(2, 7, 16, 25, 34))
    model.load_state_dict(_golden_vgg_state(z), strict=True)
    with torch.no_grad():
        taps = model(_nhwc(z["x"]))
    assert len(taps) == 5
    for i, tap in enumerate(taps):
        np.testing.assert_allclose(tap.numpy(), z[f"tap{i}"].transpose(0, 2, 3, 1),
                                   atol=1e-5, rtol=1e-4)


def test_perceptual_loss_matches_golden(vgg19_golden):
    from sisr_tpu_torch.models.vgg import VGG19_CFG, PerceptualLoss

    z = vgg19_golden
    loss = PerceptualLoss(state_dict=_golden_vgg_state(z), cfg=_cfg8(VGG19_CFG))
    got = float(loss(_nhwc(z["x"]), _nhwc(z["gt"])))
    np.testing.assert_allclose(got, float(z["perceptual"]), atol=1e-6, rtol=1e-4)


def test_lpips_matches_golden():
    from sisr_tpu_torch.models.vgg import VGG16_CFG, LPIPSVgg, lpips_state_dict

    z = np.load(GOLDEN / "lpips_vgg_random.npz")
    lin = {k: torch.from_numpy(np.array(z[k])) for k in z.files if k.startswith("lin")}
    model = LPIPSVgg(cfg=_cfg8(VGG16_CFG))
    model.load_state_dict(lpips_state_dict(lin, _golden_vgg_state(z)), strict=True)
    with torch.no_grad():
        got = model(_nhwc(z["a"]), _nhwc(z["b"]), normalize=True).numpy()
    np.testing.assert_allclose(got, z["lpips"], atol=1e-6, rtol=1e-4)


def test_vgg_and_lpips_match_jax():
    """VGG19 taps, the perceptual loss and LPIPS (both normalize modes)
    against JAX's modules from JAX's initial parameters."""
    from sisr_tpu.models.vgg import LPIPSVgg as JaxLPIPS
    from sisr_tpu.models.vgg import PerceptualLoss as JaxPerceptual
    from sisr_tpu.models.vgg import VGGFeatures as JaxVGG
    from sisr_tpu_torch.models.jax_port import (lpips_state_dict_from_jax,
                                                vgg_state_dict_from_jax)
    from sisr_tpu_torch.models.vgg import (VGG16_CFG, VGG19_CFG, LPIPSVgg, PerceptualLoss,
                                           VGGFeatures)

    rng = np.random.default_rng(4)
    x, gt = (rng.random((2, 20, 24, 3), dtype=np.float32) for _ in range(2))
    cfg19, cfg16 = _cfg8(VGG19_CFG), _cfg8(VGG16_CFG)
    jvgg = JaxVGG(cfg=cfg19)
    variables = jvgg.init(jax.random.PRNGKey(6), jnp.asarray(x))
    sd = _state(vgg_state_dict_from_jax(variables, cfg19))
    vgg = VGGFeatures(cfg=cfg19)
    vgg.load_state_dict(sd, strict=True)
    with torch.no_grad():
        for got, ref in zip(vgg(torch.from_numpy(x)), jvgg.apply(variables, jnp.asarray(x))):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)
        got = float(PerceptualLoss(sd, cfg=cfg19)(torch.from_numpy(x), torch.from_numpy(gt)))
    ref = float(JaxPerceptual(variables, cfg=cfg19)(jnp.asarray(x), jnp.asarray(gt)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-4)

    jlp = JaxLPIPS(cfg=cfg16)
    lvars = jlp.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(gt))
    lp = LPIPSVgg(cfg=cfg16)
    lp.load_state_dict(_state(lpips_state_dict_from_jax(lvars, cfg16)), strict=True)
    for normalize in (True, False):
        with torch.no_grad():
            got = lp(torch.from_numpy(x), torch.from_numpy(gt), normalize=normalize).numpy()
        ref = np.asarray(jlp.apply(lvars, jnp.asarray(x), jnp.asarray(gt), normalize=normalize))
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-4)


# ------------------------------------------------------------- the training steps

def test_gan_generator_steps_match_reference_golden():
    """Four generator Adam(2e-4) steps of pixel L1 + 1.0 x VGG19
    perceptual + 0.1 x BCE against the frozen, eval-mode discriminator,
    from the reference's state, reproduce its losses (the reference loop
    experiments/hitsir_pro_gan_experiment.py:117-143)."""
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR
    from sisr_tpu_torch.models.vgg import VGG19_CFG, PerceptualLoss
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import gan_generator_loss

    blob = np.load(GOLDEN / "gan_train_steps_tiny_full.npz")
    g = HiTSIR(**CASES["tiny_full"])
    g.load_state_dict(_pick(blob, "sd__"), strict=True)
    d = UNetDiscriminatorSN()
    d.load_state_dict(_pick(blob, "dsd__"), strict=True)
    d.eval().requires_grad_(False)
    perceptual = PerceptualLoss(state_dict=_pick(blob, "vsd__"), cfg=_cfg8(VGG19_CFG))
    opt = torch.optim.Adam(g.parameters(), lr=2e-4)
    losses = []
    for i in range(blob["lrs"].shape[0]):
        x, y = _nhwc(blob["lrs"][i]), _nhwc(blob["hrs"][i])
        opt.zero_grad(set_to_none=True)
        loss = gan_generator_loss(g(x, deterministic=False), y, d, l1_loss, perceptual)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, blob["losses"], rtol=3e-4, atol=1e-6)


def _assert_d_state(d, want: dict):
    got = d.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=5e-5, rtol=1e-3,
                                   err_msg=k)


def test_gan_discriminator_steps_match_reference_golden():
    """Four discriminator Adam(2e-4) steps, BCE(real) + BCE(fake) with u, v
    advancing on both forwards (the reference's D update, :144-165), from
    its state: the losses of every step, then the end parameters and u, v."""
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN
    from sisr_tpu_torch.train.train_state import gan_discriminator_backward

    blob = np.load(GOLDEN / "gan_d_steps.npz")
    d = UNetDiscriminatorSN(ndf=16)
    d.load_state_dict(_pick(blob, "d0__"), strict=True)
    d.train()
    opt = torch.optim.Adam(d.parameters(), lr=2e-4)
    for i in range(blob["srs"].shape[0]):
        opt.zero_grad(set_to_none=True)
        l_real, l_fake = gan_discriminator_backward(d, _nhwc(blob["hrs"][i]),
                                                    _nhwc(blob["srs"][i]))
        opt.step()
        np.testing.assert_allclose(float(l_real), blob["l_real"][i], rtol=3e-4, atol=1e-6)
        np.testing.assert_allclose(float(l_fake), blob["l_fake"][i], rtol=3e-4, atol=1e-6)
    _assert_d_state(d, {k: v.numpy() for k, v in _pick(blob, "d1__").items()})


def test_make_gan_train_step_matches_jax():
    """The port's two-optimizer step against JAX's ``make_gan_train_step``
    from the same generator, discriminator (with u, v), VGG19 and Adam
    state: 2 steps' g_loss and d_loss within 1e-4 relative, then the
    discriminator's parameters and u, v at the D steps' bar; the
    discriminator's parameters take no gradient in the G phase."""
    from sisr_tpu.configs.model_config import get_optimizer as jax_optimizer
    from sisr_tpu.models.discriminator import UNetDiscriminatorSN as JaxD
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu.models.vgg import PerceptualLoss as JaxPerceptual
    from sisr_tpu.models.vgg import VGGFeatures as JaxVGG
    from sisr_tpu.train.losses import l1_loss as jax_l1
    from sisr_tpu.train.train_state import GANTrainState as JaxGANState
    from sisr_tpu.train.train_state import create_train_state as jax_state
    from sisr_tpu.train.train_state import make_gan_train_step as jax_gan_step
    from sisr_tpu_torch.configs.model_config import get_optimizer
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR
    from sisr_tpu_torch.models.jax_port import (discriminator_state_dict_from_jax,
                                                state_dict_from_jax, vgg_state_dict_from_jax)
    from sisr_tpu_torch.models.vgg import VGG19_CFG, PerceptualLoss
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_gan_train_step

    cfg, cfg19, ndf = CASES["tiny_full"], _cfg8(VGG19_CFG), 16
    opt_kw = {"weight_decay": 0, "betas": [0.9, 0.99]}
    rng = np.random.default_rng(8)
    batches = [(rng.random((2, 16, 16, 3), dtype=np.float32),
                rng.random((2, 64, 64, 3), dtype=np.float32)) for _ in range(2)]

    jg, jd = JaxHiTSIR(**cfg), JaxD(ndf=ndf)
    g_params = jg.init(jax.random.PRNGKey(9), jnp.asarray(batches[0][0]))["params"]
    d_vars = _settled(jd, jd.init(jax.random.PRNGKey(10), jnp.asarray(batches[0][1])),
                      jnp.asarray(batches[0][1]))
    v_vars = JaxVGG(cfg=cfg19).init(jax.random.PRNGKey(11), jnp.asarray(batches[0][1]))
    g_tx, d_tx = (jax_optimizer("Adam", 2e-4, dict(opt_kw)) for _ in range(2))

    def d_apply(variables, x, update_stats=False, mutable=None):
        return jd.apply(variables, x, update_stats, mutable=mutable)

    jstep = jax_gan_step(
        g_apply=lambda v, x, deterministic, rngs: jg.apply(v, x, deterministic=deterministic,
                                                           rngs=rngs),
        d_apply=d_apply, pixel_loss=jax_l1, perceptual_loss=JaxPerceptual(v_vars, cfg=cfg19),
        g_tx=g_tx, d_tx=d_tx)
    state = JaxGANState(g=jax_state(g_params, g_tx), d=jax_state(d_vars["params"], d_tx),
                        d_variables={"spectral": d_vars["spectral"]})

    g = HiTSIR(**cfg)
    g.load_state_dict(_state(state_dict_from_jax(g_params)), strict=True)
    d = UNetDiscriminatorSN(ndf=ndf).train()
    d.load_state_dict(_state(discriminator_state_dict_from_jax(d_vars["params"],
                                                               d_vars["spectral"])), strict=True)
    perceptual = PerceptualLoss(_state(vgg_state_dict_from_jax(v_vars, cfg19)), cfg=cfg19)
    g_opt = get_optimizer("Adam", g.parameters(), 2e-4, dict(opt_kw))
    step = make_gan_train_step(g, d, l1_loss, perceptual, g_opt,
                               get_optimizer("Adam", d.parameters(), 2e-4, dict(opt_kw)))

    # the G phase leaves the discriminator without gradients
    seen = []
    hook = g_opt.register_step_pre_hook(lambda *_: seen.append(
        all(p.grad is None for p in d.parameters())))
    for i, (x, y) in enumerate(batches):
        state, jg_loss, jd_loss = jstep(state, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(i))
        d.zero_grad(set_to_none=True)   # the D phase starts so anyway
        g_loss, d_loss = step(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(g_loss), float(jg_loss), rtol=1e-4)
        np.testing.assert_allclose(float(d_loss), float(jd_loss), rtol=1e-4)
    hook.remove()
    assert seen == [True, True]
    _assert_d_state(d, discriminator_state_dict_from_jax(state.d.params,
                                                         state.d_variables["spectral"]))
    assert all(p.requires_grad for p in d.parameters())
