"""The UNet and Dense families of the port against the JAX package on the
CPU, at ``test_model_families.py``'s configs: the forward, one training
step through ``make_train_step`` (the loss, and every parameter's gradient
against ``jax.grad``), the side rule, the default parameter counts and the
fresh initialization.  Parameters cross through ``models/jax_port.py``.

Bars: forward max abs < 1e-3 and rms < 5e-5 (``test_model_parity.py:
63-68``); the loss 1e-5 relative and each gradient 1e-3 relative norm
error (``test_torch_train.py``); a fresh tensor's std within 10% of a fresh
JAX init's.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

UNET_CASES = {
    "two_stage": (dict(n_channels=16, ch_mults=(1, 2), is_attn=(False, True), n_blocks=1,
                       n_heads=2, upscale=4), (1, 16, 24, 3)),
    "one_stage": (dict(n_channels=8, ch_mults=(1,), is_attn=(False,), n_blocks=1),
                  (1, 8, 8, 3)),
}
DENSE_CASES = {
    "plain": (dict(num_blocks=(2, 2), skip_blocks=(0,), middle_channels=20, scale=4,
                   is_sa_attn=False, is_fusion=False, is_mult_size_conv_feat_extract=False),
              (2, 12, 16, 3)),
    "full": (dict(num_blocks=(2, 2), skip_blocks=(0,), middle_channels=20, scale=4,
                  is_sa_attn=True, is_fusion=True, is_mult_size_conv_feat_extract=True),
             (2, 12, 16, 3)),
}
CASES = {**{("unet", k): v for k, v in UNET_CASES.items()},
         **{("dense", k): v for k, v in DENSE_CASES.items()}}
# declared by the multi-size extraction but never read (reference
# hit_sir_pro.py:62): torch leaves its gradient None, JAX's is zero
UNUSED = ("conv_first.norm.weight", "conv_first.norm.bias")


def _classes(family):
    if family == "unet":
        from sisr_tpu.models.unet_sr import UNetSR as JaxModel
        from sisr_tpu_torch.models.jax_port import unet_state_dict_from_jax as convert
        from sisr_tpu_torch.models.unet_sr import UNetSR as Model
    else:
        from sisr_tpu.models.dense_sr import DenseSR as JaxModel
        from sisr_tpu_torch.models.dense_sr import DenseSR as Model
        from sisr_tpu_torch.models.jax_port import dense_state_dict_from_jax as convert
    return JaxModel, Model, convert


def _pair(family, cfg, shape, seed=0):
    """(JAX model, its variables, the port's model with the same weights)."""
    JaxModel, Model, convert = _classes(family)
    jm = JaxModel(**cfg)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32))
    model = Model(**cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           convert(variables).items()}, strict=True)
    return jm, variables, model


@pytest.mark.parametrize("family,name", sorted(CASES))
def test_forward_matches_jax(family, name):
    cfg, shape = CASES[(family, name)]
    jm, variables, model = _pair(family, cfg, shape)
    x = np.random.default_rng(2).random(shape, dtype=np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 4 * shape[1], 4 * shape[2], 3)
    err = np.abs(got - want)
    assert err.max() < 1e-3 and np.sqrt(np.mean(err ** 2)) < 5e-5, (err.max(), err.mean())


@pytest.mark.parametrize("family,name", sorted(CASES))
def test_train_step_matches_jax(family, name):
    """One step of the port's ``make_train_step`` (L1, Adam) against JAX's
    on the same weights and batch: the loss, and every parameter's
    gradient against ``jax.grad`` of the same loss."""
    from sisr_tpu.configs.model_config import get_optimizer as jax_optimizer
    from sisr_tpu.train.losses import l1_loss as jax_l1
    from sisr_tpu.train.train_state import (create_train_state,
                                            make_train_step as jax_train_step)
    from sisr_tpu_torch.configs.model_config import get_optimizer
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    cfg, shape = CASES[(family, name)]
    jm, variables, model = _pair(family, cfg, shape, seed=3)
    _, _, convert = _classes(family)
    rng = np.random.default_rng(4)
    lr = rng.random(shape, dtype=np.float32)
    hr = rng.random((shape[0], 4 * shape[1], 4 * shape[2], 3), dtype=np.float32)
    opt = {"weight_decay": 0, "betas": [0.9, 0.99]}

    tx = jax_optimizer("Adam", 2e-5, opt)
    _, jloss = jax_train_step(jm.apply, jax_l1, tx)(
        create_train_state(variables["params"], tx), jnp.asarray(lr), jnp.asarray(hr),
        jax.random.PRNGKey(0))
    jgrads = jax.grad(lambda p: jax_l1(jm.apply({"params": p}, jnp.asarray(lr)),
                                       jnp.asarray(hr)))(variables["params"])
    ref = convert({"params": jgrads})

    step = make_train_step(model, l1_loss, get_optimizer("Adam", model.parameters(), 2e-5, opt))
    loss = float(step(torch.from_numpy(lr), torch.from_numpy(hr)))
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss)), (loss, float(jloss))
    grads = dict(model.named_parameters())
    assert grads.keys() == ref.keys()
    top = max(np.linalg.norm(g) for g in ref.values())
    for key, p in grads.items():
        if key in UNUSED:
            assert p.grad is None and not ref[key].any(), key
            continue
        g = p.grad.numpy()
        if _zero_in_exact_arithmetic(model, key):
            # both sides are rounding noise, ~1e-8 of the largest gradient
            assert max(np.linalg.norm(g), np.linalg.norm(ref[key])) < 1e-5 * top, key
            continue
        err = np.linalg.norm(g - ref[key]) / max(np.linalg.norm(ref[key]), 1e-30)
        assert err < 1e-3, f"{key}: relative norm error {err:.2e}"


def _zero_in_exact_arithmetic(model, key: str) -> bool:
    """Parameters whose loss gradient is 0 in exact arithmetic: the
    attention's key bias (it shifts every logit of a query alike, which
    the softmax cancels), and a UNet conv1's bias where the GroupNorm after
    it normalises each channel on its own (as many groups as channels)."""
    if key.endswith("attn.key.bias"):
        return True
    norm2 = getattr(model.get_submodule(key.rsplit(".", 2)[0]), "norm2", None)
    return (key.endswith(".conv1.bias") and isinstance(norm2, torch.nn.GroupNorm)
            and norm2.num_groups == norm2.num_channels)


def test_unet_side_not_multiple_of_its_halvings_raises():
    """Two stages halve once: a side of 13 breaks JAX's skip concat, and the
    port refuses it before any conv."""
    cfg, _ = UNET_CASES["two_stage"]
    jm, variables, model = _pair("unet", cfg, (1, 16, 24, 3))
    x = np.random.default_rng(5).random((1, 13, 24, 3), dtype=np.float32)
    with pytest.raises(Exception):
        jm.apply(variables, jnp.asarray(x))
    with pytest.raises(ValueError):
        model(torch.from_numpy(x))


def _jax_param_count(JaxModel, **kw):
    shapes = jax.eval_shape(lambda: JaxModel(**kw).init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 64, 64, 3))))
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))


DEFAULTS = {
    "unet": ({}, 3_898_928),
    "dense": (dict(is_sa_attn=True, is_fusion=True, is_mult_size_conv_feat_extract=True,
                   num_blocks=(4, 4), skip_blocks=(0,), middle_channels=64), 1_367_399),
}


@pytest.mark.parametrize("family", sorted(DEFAULTS))
def test_default_parameter_count(family):
    """The experiments' defaults: ``unet_experiment`` and
    ``dense_experiment``'s model arguments."""
    JaxModel, Model, _ = _classes(family)
    kw, want = DEFAULTS[family]
    assert sum(p.numel() for p in Model(**kw).parameters()) == want
    assert _jax_param_count(JaxModel, **kw) == want


# a tensor of fewer elements has a sampled std too noisy for the 10% bar:
# those are held together, each scaled by sqrt(fan-in)
SMALL = 1000


@pytest.mark.parametrize("family", sorted(DEFAULTS))
def test_fresh_init_matches_jax_distribution(family):
    """A fresh port model at the defaults against a fresh JAX init: every
    tensor of at least ``SMALL`` elements has its std within 10% of JAX's
    (the kernels, lecun-normal), the smaller ones pooled; the biases are
    0 and the norm scales 1, exactly, as JAX's."""
    JaxModel, Model, convert = _classes(family)
    kw, _ = DEFAULTS[family]
    ref = convert(JaxModel(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))
    torch.manual_seed(0)
    got = {k: v.detach().numpy() for k, v in Model(**kw).state_dict().items()}
    assert got.keys() == ref.keys()
    pooled = {"port": [], "jax": []}
    for key, value in got.items():
        want = ref[key]
        if key.endswith("bias") or np.all(want == 1.0):
            np.testing.assert_array_equal(value, want, err_msg=key)
            continue
        if value.size >= SMALL:
            ratio = value.std() / want.std()
            assert abs(ratio - 1) < 0.1, f"{key}: std {value.std():.4g} against {want.std():.4g}"
        else:
            # the fan-in: every axis but the output's (torch's axis 0; a
            # transposed conv has none this small)
            fan = value[0].size
            pooled["port"].append(value.ravel() * np.sqrt(fan))
            pooled["jax"].append(want.ravel() * np.sqrt(fan))
    if pooled["port"]:
        a, b = np.concatenate(pooled["port"]), np.concatenate(pooled["jax"])
        assert abs(a.std() / b.std() - 1) < 0.1, (a.std(), b.std(), a.size)


@pytest.mark.parametrize("family,name", [("unet", "two_stage"), ("dense", "full")])
def test_eval_copy_computes_in_its_dtype(family, name):
    """``Experiment.init_eval``'s exact-precision eval model: a shallow copy
    with ``dtype`` set; the copy of a bfloat16 model computes in float32,
    sharing the parameters."""
    cfg, shape = CASES[(family, name)]
    _, Model, _ = _classes(family)
    torch.manual_seed(1)
    model = Model(**cfg, **({"dtype": torch.bfloat16}))
    f32 = copy.copy(model)
    f32.dtype = torch.float32
    x = torch.from_numpy(np.random.default_rng(6).random(shape, dtype=np.float32))
    with torch.no_grad():
        low, high = model(x), f32(x)
        ref = Model(**cfg)
        ref.load_state_dict(model.state_dict())
        want = ref(x)
    assert next(f32.parameters()) is next(model.parameters())
    torch.testing.assert_close(high.float(), want, atol=1e-6, rtol=1e-6)
    assert float((low.float() - want).abs().max()) > 0.0
