"""HiTSIR's remaining options on the port against the JAX package on the CPU:
``drop_rate``, ``value_drop_rate``, ``drop_path_rate``, ``ape`` (with
``img_size``), ``resi_connection='3conv'`` and ``use_checkpoint``.

- ``test_hitsir_dormant_knobs``'s config with JAX's weights carried across
  (``absolute_pos_embed`` and ``layers.0.conv.{0,2,4}``): the forward
  within ``test_model_parity.py``'s bars;
- with the rates above 0, the evaluation forward equals the rate-0 one,
  two training draws differ, and with every dropout keeping everything the
  training forward's plain routes equal the kernel routes;
- ``use_checkpoint`` gives the loss and gradients of the plain step;
- the route each call takes: the kernel functions are mocked to record
  their calls, since the CPU counts no launches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

# test_model_families.py::test_hitsir_dormant_knobs
KNOBS = dict(is_mult_size_conv_feat_extract=False, is_channel_spatial_attn=False,
             is_fusion=False, embed_dim=20, depths=(2,), num_heads=(2,), base_win_size=(4, 4),
             hier_win_ratios=(0.5, 1), upsampler="pixelshuffledirect", upscale=4,
             drop_path_rate=0.3, ape=True, resi_connection="3conv")
# every option at once, on the kernels' path of the flagship's layout
# (SCA, the Fusion gate, the packed x4 head), two RHTBs of two blocks
RATES = dict(drop_rate=0.2, value_drop_rate=0.2, drop_path_rate=0.3)
SMALL = dict(embed_dim=20, depths=(2, 2), num_heads=(2, 2), base_win_size=(4, 4),
             hier_win_ratios=(0.5, 1))


def _x(shape, seed=4):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def _model(seed=0, **cfg):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    torch.manual_seed(seed)
    return HiTSIR(**cfg)


def test_dormant_knobs_match_jax():
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    x = _x((2, 8, 8, 3))
    jm = JaxHiTSIR(**KNOBS)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x.numpy()))
    model = _model(img_size=8, **KNOBS)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["absolute_pos_embed"] == (1, 64, 20)
    assert {k for k in shapes if k.startswith("layers.0.conv.")} == {
        f"layers.0.conv.{i}.{leaf}" for i in (0, 2, 4) for leaf in ("weight", "bias")}
    assert shapes["layers.0.conv.0.weight"] == (5, 20, 3, 3)
    assert shapes["layers.0.conv.2.weight"] == (5, 5, 1, 1)
    assert shapes["layers.0.conv.4.weight"] == (20, 5, 3, 3)
    sd = state_dict_from_jax(variables)
    assert {k: v.shape for k, v in sd.items()} == shapes
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = model(x).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x.numpy())))
    err = np.abs(got - want)
    assert err.max() < 1e-3 and np.sqrt(np.mean(err ** 2)) < 5e-5, err.max()


def test_ape_refuses_other_sizes():
    model = _model(img_size=8, **KNOBS)
    with pytest.raises(ValueError):
        model(_x((1, 12, 8, 3)))


def test_ape_init_is_trunc_normal_002():
    model = _model(img_size=64, **{**KNOBS, "embed_dim": 32, "num_heads": (2,)})
    pos = model.absolute_pos_embed.detach()
    assert pos.shape == (1, 4096, 32)
    assert abs(float(pos.std()) / 0.02 - 1) < 0.05 and float(pos.abs().max()) < 0.2


@pytest.mark.parametrize("cfg", [KNOBS, {**SMALL, **RATES}], ids=["knobs", "every_rate"])
def test_rates_change_nothing_at_evaluation(cfg):
    """deterministic (the default): the rates draw nothing, and the output is
    the rate-0 model's on the same weights."""
    extra = dict(img_size=8) if cfg.get("ape") else {}
    zero = {k: 0.0 for k in RATES}
    model, plain = _model(**cfg, **extra), _model(**{**cfg, **zero}, **extra)
    plain.load_state_dict(model.state_dict(), strict=True)
    x = _x((2, 8, 8, 3))
    with torch.no_grad():
        torch.testing.assert_close(model(x), plain(x), atol=0, rtol=0)


def test_two_training_draws_differ():
    model = _model(img_size=8, **KNOBS)
    x = _x((2, 8, 8, 3))
    with torch.no_grad():
        torch.manual_seed(1)
        y1 = model(x, deterministic=False)
        torch.manual_seed(2)
        y2 = model(x, deterministic=False)
        torch.manual_seed(1)
        y3 = model(x, deterministic=False)
    assert bool(torch.isfinite(y1).all())
    assert not torch.allclose(y1, y2)
    torch.testing.assert_close(y1, y3, atol=0, rtol=0)


def test_plain_routes_with_dropouts_keeping_everything_equal_the_kernel_routes(monkeypatch):
    """With the rates above 0 in training, SCC (value dropout) and the tails
    (dropout, drop-path) run their plain compositions; with every dropout
    patched to keep all, those equal the kernel routes' plain versions."""
    from sisr_tpu_torch.ops import dropout

    model = _model(**SMALL, **RATES)
    plain = _model(**SMALL)
    plain.load_state_dict(model.state_dict(), strict=True)
    x = _x((2, 16, 16, 3))
    with torch.no_grad():
        want = plain(x, deterministic=False)
        monkeypatch.setattr(dropout, "dropout", lambda t, rate, rng: t)
        monkeypatch.setattr(dropout, "drop_path", lambda t, rate, rng: t)
        got = model(x, deterministic=False)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _loss_and_grads(model, x, y, seed):
    model.zero_grad(set_to_none=True)
    torch.manual_seed(seed)
    loss = (model(x, deterministic=False) - y).square().mean()
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()
                                  if p.grad is not None}


@pytest.mark.parametrize("rates", [{}, RATES], ids=["rates_0", "every_rate"])
def test_use_checkpoint_gives_the_same_step(rates):
    """The checkpointed blocks replay their dropout draws in the backward
    (torch.utils.checkpoint keeps the generator's state): the same loss and
    gradients, 1e-6 relative."""
    model = _model(**SMALL, **rates)
    remat = _model(**SMALL, **rates, use_checkpoint=True)
    remat.load_state_dict(model.state_dict(), strict=True)
    x, y = _x((2, 16, 16, 3)), _x((2, 64, 64, 3), seed=5)
    loss, grads = _loss_and_grads(model, x, y, seed=7)
    loss_r, grads_r = _loss_and_grads(remat, x, y, seed=7)
    assert abs(loss_r - loss) <= 1e-6 * abs(loss)
    assert grads.keys() == grads_r.keys()
    for k, g in grads.items():
        err = float((grads_r[k] - g).norm() / max(float(g.norm()), 1e-30))
        assert err <= 1e-6, (k, err)


def _record(monkeypatch):
    """Wrap the model's kernel functions; returns their call counts."""
    from sisr_tpu_torch.models import hit_sir_pro as hsp

    calls = {"scc_block": 0, "htb_tail": 0, "htb_tail_stats": 0}
    for name in calls:
        fn = getattr(hsp, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(hsp, name, counted)
    return calls


# (options, deterministic) -> calls of scc_block, htb_tail, htb_tail_stats
# for SMALL's 4 blocks (2 RHTBs of 2); drop_path's linspace gives the first
# block rate 0, so its tail keeps the kernel
ROUTES = [
    ({}, True, (4, 2, 2)),
    ({}, False, (4, 4, 0)),
    (RATES, True, (4, 2, 2)),
    (dict(value_drop_rate=0.2), False, (0, 4, 0)),
    (dict(drop_rate=0.2), False, (4, 0, 0)),
    (dict(drop_path_rate=0.3), False, (4, 1, 0)),
    (RATES, False, (0, 0, 0)),
    (dict(use_checkpoint=True), True, (4, 4, 0)),
    (dict(use_checkpoint=True), False, (4, 4, 0)),
]


@pytest.mark.parametrize("opts,deterministic,want", ROUTES,
                         ids=[f"{'-'.join(o) or 'none'}-{'eval' if d else 'train'}"
                              for o, d, _ in ROUTES])
def test_routes(monkeypatch, opts, deterministic, want):
    """Which calls go through the kernel functions: every call at
    evaluation and with the rates at 0 (today's launches; in evaluation a
    block's tail emits the next block's statistics), none of SCC's with the
    value dropout in training, none of a tail's with dropout or drop-path
    in training (as JAX routes them)."""
    calls = _record(monkeypatch)
    model = _model(**SMALL, **opts)
    with torch.no_grad():
        model(_x((2, 16, 16, 3)), deterministic=deterministic)
    assert (calls["scc_block"], calls["htb_tail"], calls["htb_tail_stats"]) == want


@pytest.mark.parametrize("use_checkpoint,want", [(False, (4, 4)), (True, (8, 8))])
def test_use_checkpoint_runs_each_block_again_in_the_backward(monkeypatch, use_checkpoint,
                                                              want):
    """A training step's calls of scc_block and htb_tail: once a block, or
    with ``use_checkpoint`` twice (the forward, and its recompute in the
    backward), as ``chip_smoke.py``'s families phase counts the launches."""
    calls = _record(monkeypatch)
    model = _model(**SMALL, use_checkpoint=use_checkpoint)
    model(_x((2, 16, 16, 3)), deterministic=False).square().mean().backward()
    assert (calls["scc_block"], calls["htb_tail"]) == want
