"""The port's training path against the reference's golden run and the JAX
package, on the CPU at small sizes.

- The reference's own six Adam steps (``train_steps_tiny_full.npz``),
  loaded strictly from its state dict, at ``test_training.py:209``'s bar.
- Every parameter's gradient against ``jax.grad`` of the JAX model on the
  same weights and batch: relative norm error 1e-3 per tensor.
- Losses, the schedule, Adam / AdamW against optax, the train and eval
  steps, checkpoints and the configs' fields.
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

# the golden's tiny config with the Fusion gate; and one without it whose
# windows 16 and 32 reflect-pad a 20x24 map (and window 8 its rows)
GRAD_CASES = {
    "tiny_full": (CASES["tiny_full"], (2, 16, 16, 3)),
    "padded": (dict(is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
                    is_fusion=False, embed_dim=24, depths=(4,), num_heads=(2,),
                    base_win_size=(8, 8), mlp_ratio=2.0, upsampler="nearest+conv",
                    upscale=4, hier_win_ratios=(0.5, 1, 2, 4)), (2, 20, 24, 3)),
}
# declared and checkpointed by the reference but never read (reference
# :62): torch leaves its gradient None, JAX's is zero
UNUSED = ("conv_first.norm.weight", "conv_first.norm.bias")


def _port_model(cfg, state=None):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    model = HiTSIR(**cfg)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                              strict=True)
    return model


def _synth_pair(cfg, seed):
    """The port's model and the JAX model's variables, the same weights."""
    from sisr_tpu.models.torch_port import convert_hit_sir_state_dict
    from sisr_tpu_torch.utils.param_synth import synth_state_dict

    model = _port_model(cfg)
    manifest = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    sd = synth_state_dict(manifest, seed)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model, convert_hit_sir_state_dict(sd)


def _golden_train():
    blob = np.load(GOLDEN / "train_steps_tiny_full.npz")
    sd = {k[len("sd__"):]: blob[k] for k in blob.files if k.startswith("sd__")}
    return blob, sd


def test_train_steps_match_reference_golden():
    """Six torch.optim.Adam(2e-4) steps through ``make_train_step`` from the
    reference's initial weights on its batches reproduce its losses."""
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    blob, sd = _golden_train()
    model = _port_model(CASES["tiny_full"], sd)
    step = make_train_step(model, l1_loss, torch.optim.Adam(model.parameters(), lr=2e-4))
    nhwc = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))
    losses = [float(step(nhwc(blob["lrs"][i]), nhwc(blob["hrs"][i])))
              for i in range(blob["lrs"].shape[0])]
    np.testing.assert_allclose(losses, blob["losses"], rtol=3e-4, atol=1e-6)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_every_gradient_matches_jax(name):
    """``loss.backward()`` of the training forward gives every parameter a
    gradient (123 of the golden config's 188 had none when the derived
    weights were cached outside autograd), each within a relative norm
    error of 1e-3 of ``jax.grad`` of the JAX model.  The loss is the mean
    squared error: L1's gradient flips sign at elements whose error lies
    within float32 rounding of zero, which moved a few parameters' float32
    gradients by 1e-3 against JAX's and against the port's own float64 run
    on the golden config (the MSE gradients differ by at most 2e-4)."""
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    cfg, shape = GRAD_CASES[name]
    model, variables = _synth_pair(cfg, seed=31)
    rng = np.random.default_rng(32)
    x = rng.random(shape, dtype=np.float32)
    y = rng.random((shape[0], 4 * shape[1], 4 * shape[2], 3), dtype=np.float32)

    jmodel = JaxHiTSIR(**cfg)

    def loss_of(params):
        sr = jmodel.apply({"params": params}, jnp.asarray(x), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.square(sr - jnp.asarray(y)).mean()

    jloss, jgrads = jax.value_and_grad(loss_of)(variables["params"])
    ref = state_dict_from_jax(jgrads)

    loss = (model(torch.from_numpy(x), deterministic=False) - torch.from_numpy(y)).square().mean()
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = dict(model.named_parameters())
    assert grads.keys() == ref.keys()
    for key, p in grads.items():
        if key in UNUSED:
            assert p.grad is None and not ref[key].any(), key
            continue
        assert p.grad is not None, f"{key} has no gradient"
        g = p.grad.numpy()
        err = np.linalg.norm(g - ref[key]) / max(np.linalg.norm(ref[key]), 1e-30)
        assert err < 1e-3, f"{key}: relative norm error {err:.2e}"


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_training_forward_equals_evaluation_forward(name):
    """deterministic=False (every block pools its own input) against the
    evaluation forward (stats threaded from each tail), within 1e-6
    absolute plus 1e-6 relative: where a window pads the map the threaded
    global sum adds the pad strips on their own, a float32 rounding apart."""
    cfg, shape = GRAD_CASES[name]
    model, _ = _synth_pair(cfg, seed=33)
    x = torch.from_numpy(np.random.default_rng(34).random(shape, dtype=np.float32))
    with torch.no_grad():
        train = model(x, deterministic=False)
        evaluation = model(x)
    torch.testing.assert_close(train, evaluation, atol=1e-6, rtol=1e-6)


def test_derived_weights_are_made_under_autograd_and_cached_without_it():
    """With gradients recorded the derived weights are made anew each
    forward and nothing is kept; under inference_mode they are cached."""
    cfg, shape = GRAD_CASES["tiny_full"]
    model, _ = _synth_pair(cfg, seed=35)
    x = torch.from_numpy(np.random.default_rng(36).random(shape, dtype=np.float32))
    conv = model.conv_after_body
    model(x, deterministic=False)
    assert not conv.__dict__.get("_derived")
    with torch.inference_mode():
        model(x)
    cached = conv.__dict__["_derived"][("conv", torch.float32, x.device)][1]
    with torch.inference_mode():
        model(x)
    assert conv.__dict__["_derived"][("conv", torch.float32, x.device)][1] is cached


@pytest.mark.parametrize("name", ["l1", "mse", "charbonnier", "tv", "gan_real", "gan_fake"])
def test_losses_match_jax(name):
    from sisr_tpu.train import losses as jx
    from sisr_tpu_torch.train import losses as pt

    rng = np.random.default_rng(37)
    a, b = (rng.normal(size=(2, 9, 7, 3)).astype(np.float32) for _ in range(2))
    calls = {"l1": lambda m, p, q: m.l1_loss(p, q),
             "mse": lambda m, p, q: m.mse_loss(p, q),
             "charbonnier": lambda m, p, q: m.charbonnier_loss(p, q),
             "tv": lambda m, p, q: m.tv_loss(p, 0.5),
             "gan_real": lambda m, p, q: m.gan_loss(p, True),
             "gan_fake": lambda m, p, q: m.gan_loss(p, False, fake_label_val=0.1)}
    got = float(calls[name](pt, torch.from_numpy(a), torch.from_numpy(b)))
    ref = float(calls[name](jx, jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref))


def test_loss_function_factory_matches_jax():
    from sisr_tpu.configs.model_config import get_loss_function as jx_get
    from sisr_tpu_torch.configs.model_config import get_loss_function, loss_functions

    rng = np.random.default_rng(38)
    a, b = (rng.normal(size=(1, 5, 6, 3)).astype(np.float32) for _ in range(2))
    for name in loss_functions:
        got = float(get_loss_function(name)(torch.from_numpy(a), torch.from_numpy(b)))
        assert abs(got - float(jx_get(name)(jnp.asarray(a), jnp.asarray(b)))) <= 1e-6
    with pytest.raises(ValueError):
        get_loss_function("ssim")


def test_scheduler_matches_jax_and_torch():
    from sisr_tpu.configs.model_config import get_scheduler as jx_sched
    from sisr_tpu_torch.configs.model_config import get_scheduler

    base, floor, epochs = 2e-5, 1e-7, 50
    sched_fn, jx_fn = get_scheduler(base, floor, epochs), jx_sched(base, floor, epochs)
    opt = torch.optim.Adam(torch.nn.Linear(1, 1).parameters(), lr=base)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=epochs, eta_min=floor)
    for epoch_idx in range(epochs + 1):
        assert abs(sched_fn(epoch_idx) - opt.param_groups[0]["lr"]) < 1e-12
        assert abs(sched_fn(epoch_idx) - jx_fn(epoch_idx)) < 1e-12
        sched.step()


@pytest.mark.parametrize("kwarg", [{"weight_decay": 0, "betas": [0.9, 0.99]},
                                   {"weight_decay": 1e-2, "betas": (0.8, 0.95), "eps": 1e-6}])
def test_optimizer_step_matches_optax(kwarg):
    """One step of the port's optimizer (Adam, or AdamW with weight decay)
    against the JAX package's optax transformation on the same gradients."""
    import optax
    from sisr_tpu.configs.model_config import get_optimizer as jx_opt
    from sisr_tpu_torch.configs.model_config import get_optimizer

    rng = np.random.default_rng(39)
    p0, g = (rng.normal(size=(4, 6)).astype(np.float32) for _ in range(2))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = get_optimizer("Adam", [param], 1e-3, dict(kwarg))
    assert isinstance(opt, torch.optim.AdamW if kwarg["weight_decay"] else torch.optim.Adam)
    param.grad = torch.from_numpy(g.copy())
    opt.step()
    tx = jx_opt("Adam", 1e-3, dict(kwarg))
    updates, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p0)), jnp.asarray(p0))
    ref = np.asarray(optax.apply_updates(jnp.asarray(p0), updates))
    np.testing.assert_allclose(param.detach().numpy(), ref, rtol=1e-6, atol=1e-7)


def test_train_step_reduces_loss_and_sets_learning_rate():
    """``test_training.py:47-73`` on the port: five steps lower the L1 loss;
    ``set_learning_rate`` writes every parameter group; the eval step clips."""
    from sisr_tpu_torch.configs.model_config import get_optimizer
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import (create_train_state, make_eval_step,
                                                  make_train_step, set_learning_rate)

    model, _ = _synth_pair(CASES["tiny_full"], seed=40)
    state = create_train_state(model, get_optimizer(
        "Adam", model.parameters(), 1e-3, {"weight_decay": 0, "betas": [0.9, 0.99]}))
    step = make_train_step(state.model, l1_loss, state.optimizer)
    rng = np.random.default_rng(0)
    lr_imgs = torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
    hr_imgs = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32))
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(lr_imgs, hr_imgs, gen)) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    set_learning_rate(state.optimizer, 5e-4)
    assert [g["lr"] for g in state.optimizer.param_groups] == [5e-4]
    out = make_eval_step(model)(lr_imgs)
    assert out.shape == hr_imgs.shape and float(out.min()) >= 0 and float(out.max()) <= 1


def test_checkpoint_round_trip(tmp_path):
    from sisr_tpu_torch.train import checkpoint as ckpt
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    cfg = CASES["tiny_full"]
    model, _ = _synth_pair(cfg, seed=41)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    rng = np.random.default_rng(42)
    make_train_step(model, l1_loss, opt)(
        torch.from_numpy(rng.random((1, 8, 8, 3), dtype=np.float32)),
        torch.from_numpy(rng.random((1, 32, 32, 3), dtype=np.float32)))
    path = str(tmp_path / "new_epoch_model.pth")
    ckpt.save_checkpoint(path, 7, model, opt)
    fresh = _port_model(cfg)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    loaded = ckpt.load_checkpoint(path, fresh, fresh_opt)
    assert loaded["start_epoch"] == 7
    for (k, a), (k2, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    want, got = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    assert want.keys() == got.keys()
    for i in want:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(want[i][name]), torch.as_tensor(got[i][name]))


@pytest.mark.parametrize("loader", ["load_any", "load_checkpoint"])
def test_reference_checkpoint_loads_strictly(tmp_path, loader):
    """A reference-layout .pth (the golden tiny_full state dict) loads
    strictly and reproduces the reference's recorded output."""
    from sisr_tpu_torch.train import checkpoint as ckpt

    blob = np.load(GOLDEN / "hit_sir_tiny_full.npz")
    sd = {k[len("sd__"):]: torch.from_numpy(blob[k]) for k in blob.files
          if k.startswith("sd__")}
    path = str(tmp_path / "ref.pth")
    torch.save({"start_epoch": 3, "model": sd, "optimizer": {}}, path)
    model = _port_model(CASES["tiny_full"])
    loaded = getattr(ckpt, loader)(path, model)
    assert loaded["start_epoch"] == 3 and loaded["optimizer"] is None
    with torch.inference_mode():
        y = model(torch.from_numpy(np.ascontiguousarray(blob["input"].transpose(0, 2, 3, 1))))
    assert np.abs(y.numpy().transpose(0, 3, 1, 2) - blob["output"]).max() < 1e-3
    if loader == "load_any":
        torch.save(sd, path)           # a bare state dict
        assert ckpt.load_any(path, _port_model(CASES["tiny_full"]))["start_epoch"] == 0


def test_configs_have_the_jax_fields(tmp_path):
    from sisr_tpu.configs.hit_model_config import HITModelConfig as JaxConfig
    from sisr_tpu_torch.configs.hit_model_config import HITModelConfig

    kw = dict(is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
              is_fusion=True, upsampler="nearest+conv", depths=(6,) * 6, num_heads=(6,) * 6,
              embed_dim=180, hier_win_ratios=(0.5, 1, 2, 4, 6, 8, 10, 12), batch_size=2,
              learning_rate=2e-5, min_learning_rate=1e-7, optimizer="Adam",
              optimizer_params={"weight_decay": 0, "betas": [0.9, 0.99]}, loss_function="l1",
              epochs=50, checkpoint_folder=str(tmp_path / "w"), test_model_path="best.pth",
              result_folder=str(tmp_path / "r"), log_folder=str(tmp_path / "l"),
              train_data_folder="train", train_data_name_list=["setA"],
              eval_data_folder="eval", eval_data_name_list=["setB"],
              test_data_folder="test", test_data_name_list=["setB"])
    assert vars(HITModelConfig(**kw)) == vars(JaxConfig(**kw))
    with pytest.raises(ValueError):
        HITModelConfig(**{**kw, "loss_function": "ssim"})
