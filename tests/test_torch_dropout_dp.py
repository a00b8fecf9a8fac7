"""HiTSIR's dropouts (dropout, value dropout, drop-path) drawn from the
step's generator, in one process and under data parallelism, on the CPU.

- One process: the same generator seed gives the same masks, bit for bit
  (loss and every gradient); another seed other masks; torch's default
  generator is left as it was; ``use_checkpoint`` replays the masks in
  its recompute (loss and gradients within 1e-6 relative).
- ``ops/dropout.py``: a rank's mask is its rows of the global batch's draw.
- Two gloo ranks (``mesh.spawn``) against the single process on the whole
  batch, with the same generator seed: the loss within 1e-5 relative, each
  gradient within 1e-5 x its max abs (``test_torch_mesh.py``'s bar), the
  ranks' parameters and generators equal after 3 Adam steps; the control,
  each rank drawing masks at its own slice's shape, fails the bar.
- ``hitsir_pro_experiment(n_devices=2)`` with every rate > 0 for one epoch
  against the single-process run: the logged loss within 1e-5 relative.

The ranks import this module, so it imports no JAX.
"""

import functools
import os

import numpy as np
import pytest
import torch

from sisr_tpu_torch.parallel import mesh as M
from test_torch_dp_runner import FOLDERS, PSNR_KW, _in, _make_data

torch.set_num_threads(1)

TIMEOUT = 600.0
RATES = dict(drop_rate=0.2, value_drop_rate=0.2, drop_path_rate=0.3)
SMALL = dict(embed_dim=20, depths=(2, 2), num_heads=(2, 2), base_win_size=(4, 4),
             hier_win_ratios=(0.5, 1))
STEPS = 3


def _img(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


BATCH = (_img(2, (4, 16, 16, 3)), _img(5, (4, 64, 64, 3)))


def _model(**kw):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return HiTSIR(**SMALL, **RATES, **kw)


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


def _steps(mesh=None, seed=0, n=STEPS, batch=BATCH, **kw):
    """``make_train_step`` (L1, Adam 1e-3) with a generator seeded ``seed``
    on this rank's slice of ``batch``: the first step's loss and
    gradients, the parameters after ``n`` steps and the generator's state."""
    from sisr_tpu_torch.configs.model_config import get_optimizer
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    model = _model(**kw)
    step = make_train_step(model, l1_loss, get_optimizer("Adam", model.parameters(), 1e-3,
                                                         {"weight_decay": 0}), mesh=mesh)
    lr, hr = (torch.from_numpy(a) for a in (batch if mesh is None else
                                            M.shard_batch(mesh, batch)))
    g = torch.Generator().manual_seed(seed)
    loss = float(step(lr, hr, g))
    grads = _grads(model)
    for _ in range(n - 1):
        step(lr, hr, g)
    return loss, grads, {k: v.clone() for k, v in model.state_dict().items()}, g.get_state()


def _own_masks_grads(mesh, seed=0):
    """The control: the step's gradients with each rank drawing its masks
    at its own slice's shape (a bare generator, no rank slice)."""
    from sisr_tpu_torch.train.losses import l1_loss

    model = _model()
    lr, hr = (torch.from_numpy(a) for a in M.shard_batch(mesh, BATCH))
    g = torch.Generator().manual_seed(seed)
    l1_loss(model(lr, deterministic=False, generator=g), hr).backward()
    M.all_reduce_grads(mesh, model.parameters())
    return _grads(model)


def _rank(rank):
    mesh = M.make_mesh(2, device="cpu")
    loss, grads, params, gen = _steps(mesh)
    return dict(loss=loss, grads=grads, params=params, gen=gen,
                control=_own_masks_grads(mesh))


@pytest.fixture(scope="module")
def two():
    return M.spawn(_rank, 2, device="cpu", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def single():
    return _steps()


def _grad_errors(got, ref):
    """{name: max abs error / max abs of the reference gradient}."""
    assert got.keys() == ref.keys()
    return {k: float((got[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
            for k in ref}


# ------------------------------------------------------------------ one process

def test_same_seed_same_bits_other_seed_other_masks(single):
    loss, grads, params, gen = single
    again = _steps()
    assert again[0] == loss
    for k, g in grads.items():
        assert torch.equal(again[1][k], g), k
    for k, v in params.items():
        assert torch.equal(again[2][k], v), k
    assert torch.equal(again[3], gen)
    other = _steps(seed=1, n=1)
    assert other[0] != loss


def test_the_generator_decides_every_mask_and_leaves_the_default_alone():
    """Two steps under different global seeds with generators seeded alike
    draw the same masks, and the default generator's state is unchanged
    across each step; with no generator, the global seed decides."""
    states, results = [], []
    for global_seed in (11, 12):
        torch.manual_seed(global_seed)
        before = torch.get_rng_state()
        results.append(_steps(n=1))
        states.append(torch.equal(before, torch.get_rng_state()))
    assert states == [True, True]
    assert results[0][0] == results[1][0]
    x = torch.from_numpy(BATCH[0])
    model = _model()
    with torch.no_grad():
        torch.manual_seed(1)
        y1 = model(x, deterministic=False)
        torch.manual_seed(2)
        y2 = model(x, deterministic=False)
    assert not torch.equal(y1, y2)


def test_use_checkpoint_replays_the_generators_masks():
    """``use_checkpoint`` recomputes each block in the backward from a copy
    of the generator as it stood before the block: the same loss and
    gradients as without it (1e-6 relative), and the generator ends where
    the plain step's ends."""
    loss, grads, _, gen = _steps(n=1)
    loss_r, grads_r, _, gen_r = _steps(n=1, use_checkpoint=True)
    assert abs(loss_r - loss) <= 1e-6 * abs(loss)
    assert grads.keys() == grads_r.keys()
    for k, g in grads.items():
        err = float((grads_r[k] - g).norm() / max(float(g.norm()), 1e-30))
        assert err <= 1e-6, (k, err)
    assert torch.equal(gen_r, gen)


@pytest.mark.parametrize("rank,size", [(0, 1), (0, 2), (1, 2), (2, 4)])
def test_a_ranks_mask_is_its_rows_of_the_global_draw(rank, size):
    from sisr_tpu_torch.ops.dropout import DropoutRng, keep_mask

    like = torch.zeros(3, dtype=torch.bfloat16)
    whole = keep_mask((3 * size, 5, 7), 0.6, like, torch.Generator().manual_seed(4))
    got = keep_mask((3, 5, 7), 0.6, like,
                    DropoutRng(torch.Generator().manual_seed(4), rank, size))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, whole[3 * rank:3 * (rank + 1)])
    assert 0.4 < float(whole.float().mean()) < 0.8


# -------------------------------------------------------------- data parallel

def test_dp_step_with_every_dropout_matches_single_process(single, two):
    loss, grads, _, _ = single
    nonzero = [k for k, g in grads.items() if bool(g.abs().max() > 0)]
    assert len(nonzero) > len(grads) // 2
    for res in two:
        assert abs(res["loss"] - loss) <= 1e-5 * abs(loss)
        errs = _grad_errors(res["grads"], grads)
        assert max(errs.values()) < 1e-5, max(errs.items(), key=lambda kv: kv[1])
        control = _grad_errors(res["control"], grads)
        assert max(control[k] for k in nonzero) > 1e-5


def test_dp_ranks_stay_in_step(two):
    """After 3 Adam steps both ranks hold the same parameters, bit for
    bit, and their generators the same state."""
    for k, v in two[0]["params"].items():
        assert torch.equal(two[1]["params"][k], v), k
    assert torch.equal(two[0]["gen"], two[1]["gen"])


def _run_with_rates(root, data_root, **kw):
    """``hitsir_pro`` for one epoch in ``root`` with every rate > 0."""
    from sisr_tpu_torch.__main__ import main
    from sisr_tpu_torch.experiments import hitsir_pro_experiment as hpe

    hpe.HiTSIR = functools.partial(hpe.HiTSIR, **RATES)
    try:
        exp = _in(root, lambda: main("hitsir_pro", False, **{**PSNR_KW, "epochs": 1,
                                                              "data_root": data_root, **kw}))
    finally:
        hpe.HiTSIR = hpe.HiTSIR.func
    return exp.epoch_loss.avg, exp.model.drop_path_rate


def _runner_rank(rank, roots, data_root):
    return _run_with_rates(roots[rank], data_root, n_devices=2)


def test_dp_runner_with_dropouts_matches_single_process(tmp_path):
    data = _make_data(tmp_path / "data")
    roots = [tmp_path / f"rank{r}" for r in range(2)] + [tmp_path / "single"]
    for root in roots:
        root.mkdir()
    got = M.spawn(_runner_rank, 2, [str(r) for r in roots], str(data), device="cpu",
                  timeout=TIMEOUT)
    loss, rate = _run_with_rates(roots[2], str(data))
    assert rate == RATES["drop_path_rate"]
    for rank_loss, rank_rate in got:
        assert rank_rate == rate
        assert abs(rank_loss - loss) <= 1e-5 * abs(loss), (rank_loss, loss)
    logged = (roots[0] / "logs" / FOLDERS["hitsir_pro"] / "loss_log.txt").read_text()
    single = (roots[2] / "logs" / FOLDERS["hitsir_pro"] / "loss_log.txt").read_text()
    assert abs(float(logged.split("loss:")[1]) - float(single.split("loss:")[1])) \
        <= 1e-5 * abs(loss)
    assert not os.listdir(roots[1])
