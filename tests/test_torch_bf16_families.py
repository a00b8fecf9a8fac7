"""DenseSR's and UNetSR's bfloat16 training steps against JAX's on the CPU,
at ``test_torch_families.py``'s configs with JAX's init carried across:
DenseSR ``full`` (the multi-size extraction, SCA, the Fusion gate) and
UNetSR ``two_stage`` (two stages, attention in the second).  The loss and
every gradient at ``test_torch_bf16_train.py``'s bar, with its control;
the MSE loss, as there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bf16_train import check_bf16
from test_torch_families import CASES, _classes, _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("family,name", [("dense", "full"), ("unet", "two_stage")])
def test_bf16_step_matches_jax_bf16_step(family, name):
    cfg, shape = CASES[(family, name)]
    JaxModel, _, convert = _classes(family)
    _, variables, model = _pair(family, cfg, shape, seed=3)
    rng = np.random.default_rng(4)
    x = rng.random(shape, dtype=np.float32)
    y = rng.random((shape[0], 4 * shape[1], 4 * shape[2], 3), dtype=np.float32)
    jmodel = JaxModel(**cfg, dtype=jnp.bfloat16)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jnp.square(jmodel.apply({"params": p}, jnp.asarray(x))
                             - jnp.asarray(y)).mean())(variables["params"])
    named = {k for k, p in model.named_parameters() if k not in
             ("conv_first.norm.weight", "conv_first.norm.bias")}
    ref = {k: np.asarray(v, np.float64) for k, v in convert({"params": jgrads}).items()
           if k in named}
    check_bf16(model, x, y, float(jloss), ref)
