"""The port's bfloat16 training step against JAX's bfloat16 step on the CPU:
HiTSIR's ``padded`` config of ``test_torch_train.py`` (windows 4 to 32,
reflect-padded maps: every window path), the same carried weights and
batch, the MSE loss (``test_torch_train.py`` says why not L1).

Two bfloat16 steps round differently, so neither is an oracle for the
other's bits: each is compared with the port's float32 step, which
``test_torch_train.py`` holds to ``jax.grad`` at 1e-3.  A tensor's error
is its relative norm error against the float32 gradient, normalised by
max(|g_f32|, ``REL_FLOOR`` x |the whole f32 gradient|), since a gradient
that is near zero (the SCA's ``qkv.linear1*`` under flax's init, ~1e-11 of
a total of ~1) has a relative error of order 1 in float32 already.  The
bar: the port's bfloat16 error at most ``JAX_MULT`` x JAX's plus
``FLOOR``, for every tensor, for the whole gradient and for the loss.

The error of one bfloat16 step is one draw of its rounding, and the max
pools of the SCA and of the Fusion gate make it jump: a rounding tie
moves an argmax, and with it the gradient.  DenseSR's ``full`` config
(SCA, Fusion gate, the multi-size extraction) gives a whole-gradient
error of 0.012-0.016 for some inputs and 0.065-0.127 for others 1e-3
away, on the port alone; JAX's one draw at this input fell at 0.017.  So
the port's step is taken at the input and at ``MOVES`` inputs one
bfloat16 ulp from it (each element x (1 +- 2^-8) at random: a float32 ulp
rarely moves the input's bfloat16 rounding), each against the float32
step at the same input.  The loss and the whole gradient of the draw with
the smallest whole-gradient error, and each tensor's smallest error over
the draws, are held to the bar.  A fault that moves the port's gradients
moves every draw.  The control, the chosen draw's gradients scaled by
1.1, must fail the bar.  One JAX bfloat16 gradient per file: HiTSIR's
runs eagerly for ~2 min on one core (``jax.jit`` compiles for longer).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from test_torch_train import GRAD_CASES, UNUSED, _synth_pair

torch.set_num_threads(1)

REL_FLOOR = 1e-3
JAX_MULT = 2.0
FLOOR = 1e-2
MOVES = 4


def bf16_rows(port: dict, jax_bf16: dict, f32_port: dict, f32: dict) -> list:
    """(name, port's error, JAX's error) per tensor, then for the whole
    gradient ("*"): the port's bfloat16 gradients against ``f32_port``
    (the float32 step at the port's input), JAX's against ``f32``."""
    total = float(np.sqrt(sum(np.sum(np.square(g)) for g in f32.values())))
    rows, dp, dj = [], 0.0, 0.0
    for k, want in f32.items():
        den = max(float(np.linalg.norm(want)), REL_FLOOR * total)
        ep = float(np.linalg.norm(port[k] - f32_port[k]))
        ej = float(np.linalg.norm(jax_bf16[k] - want))
        rows.append((k, ep / den, ej / den))
        dp, dj = dp + ep ** 2, dj + ej ** 2
    rows.append(("*", np.sqrt(dp) / total, np.sqrt(dj) / total))
    return rows


def over_bar(rows: list) -> list:
    return [r for r in rows if r[1] > JAX_MULT * r[2] + FLOOR]


def _bf16_move(x: np.ndarray, seed: int) -> np.ndarray:
    """x with every element moved by one bfloat16 ulp, up or down at random."""
    up = np.random.default_rng(seed).random(x.shape) < 0.5
    return (x * np.where(up, 1 + 2.0 ** -8, 1 - 2.0 ** -8)).astype(np.float32)


def port_grads(model, x, y, dtype=torch.float32, loss_fn=None):
    """(loss, {name: gradient}) of one training forward and backward of
    ``model`` computing in ``dtype``."""
    model.dtype = dtype
    model.zero_grad(set_to_none=True)
    sr = model(torch.from_numpy(x), deterministic=False)
    loss = (loss_fn or _mse)(sr, torch.from_numpy(y))
    loss.backward()
    return float(loss.detach()), {k: p.grad.double().numpy()
                                  for k, p in model.named_parameters() if p.grad is not None}


def _mse(sr, y):
    return (sr - y).square().mean()


def check_bf16(model, x, y, jax_loss: float, jax_bf16: dict, loss_fn=None) -> None:
    """The port's bfloat16 step of ``model`` on (x, y) against JAX's loss
    and gradients at the bar, its draw chosen as the module docstring
    says; then the control.  Leaves ``model`` in float32."""
    loss_f32, f32 = port_grads(model, x, y, loss_fn=loss_fn)
    draws = []
    for move in range(MOVES + 1):
        xm = x if move == 0 else _bf16_move(x, seed=move)
        lf, gf = port_grads(model, xm, y, loss_fn=loss_fn) if move else (loss_f32, f32)
        lb, gb = port_grads(model, xm, y, torch.bfloat16, loss_fn)
        draws.append((bf16_rows(gb, jax_bf16, gf, f32), lb, lf, gb, gf))
    model.dtype = torch.float32
    rows, lb, lf, gb, gf = min(draws, key=lambda d: d[0][-1][1])
    best = [min(d[0][i][1] for d in draws) for i in range(len(rows))]
    rows = [(k, ep if k == "*" else b, ej) for (k, ep, ej), b in zip(rows, best)]
    lp, lj = abs(lb - lf) / abs(lf), abs(jax_loss - loss_f32) / abs(loss_f32)
    assert lp <= JAX_MULT * lj + FLOOR, (lb, lf, jax_loss, loss_f32)
    assert set(jax_bf16) == set(f32) == set(gb)
    assert not over_bar(rows), over_bar(rows)
    scaled = bf16_rows({k: 1.1 * g for k, g in gb.items()}, jax_bf16, gf, f32)
    assert over_bar(scaled), "the control (the port's gradients x 1.1) passes the bar"


def test_hitsir_bf16_step_matches_jax_bf16_step():
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    cfg, shape = GRAD_CASES["padded"]
    model, variables = _synth_pair(cfg, seed=31)
    rng = np.random.default_rng(32)
    x = rng.random(shape, dtype=np.float32)
    y = rng.random((shape[0], 4 * shape[1], 4 * shape[2], 3), dtype=np.float32)

    jmodel = JaxHiTSIR(**cfg, dtype=jnp.bfloat16)

    def loss_of(params):
        sr = jmodel.apply({"params": params}, jnp.asarray(x), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.square(sr - jnp.asarray(y)).mean()

    jloss, jgrads = jax.value_and_grad(loss_of)(variables["params"])
    ref = {k: np.asarray(v, np.float64) for k, v in state_dict_from_jax(jgrads).items()
           if k not in UNUSED}
    check_bf16(model, x, y, float(jloss), ref)
    assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
               for p in model.parameters())
