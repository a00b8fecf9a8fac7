"""The port's experiment runner against the JAX runner on the CPU: the same
tiny configuration (``tests/test_experiment_runner.py``'s ``TINY_KW``), the
same synthesized folders (``_make_data``), 2 epochs, then the test stage.
The port's model starts from the JAX model's initial parameters
(``models/jax_port.py::state_dict_from_jax``); the loaders give both the
same batches.

Bars: losses 1e-4 relative (the bar for 5 Adam steps), PSNR 1e-3 dB, SSIM
1e-5, the learning-rate log identical, and the same log, checkpoint and
result files.
"""

import os

import numpy as np
import pytest
import torch

from test_experiment_runner import TINY_KW, _make_data

torch.set_num_threads(1)

FOLDER = ("hitsir_pro_loss(l1)_mulsizeconvextract(True)_casa(True)"
          "_fusion_embed_dim(20)_len(depths)(1)_augment")
EPOCHS = 2


def _in(root, fn):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return fn()
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX root, port root, JAX experiment, port experiment) after 2
    epochs and the test stage in each root."""
    from sisr_tpu.experiments.hitsir_pro_experiment import hitsir_pro_experiment as jax_exp
    from sisr_tpu_torch.experiments.hitsir_pro_experiment import hitsir_pro_experiment
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    jroot = _make_data(tmp_path_factory.mktemp("jax"))
    proot = _make_data(tmp_path_factory.mktemp("port"))
    jx = _in(jroot, lambda: jax_exp(is_test=False, epochs=EPOCHS, run=False, **TINY_KW))
    pt = _in(proot, lambda: hitsir_pro_experiment(is_test=False, epochs=EPOCHS, run=False,
                                                  device="cpu", **TINY_KW))
    sd = state_dict_from_jax(jx.state.params)
    pt.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                             strict=True)
    _in(jroot, jx.run)
    try:
        _in(proot, pt.run)
    finally:
        pt.close()
    _in(jroot, lambda: jax_exp(is_test=True, epochs=EPOCHS, **TINY_KW))
    _in(proot, lambda: hitsir_pro_experiment(is_test=True, epochs=EPOCHS, device="cpu",
                                             **TINY_KW))
    return jroot, proot, jx, pt


def _rows(root, name):
    return [line.split() for line in
            (root / "logs" / FOLDER / name).read_text().splitlines() if line.strip()]


def test_losses_match_jax(runs):
    jroot, proot, jx, pt = runs
    a, b = _rows(proot, "loss_log.txt"), _rows(jroot, "loss_log.txt")
    assert [r[0] for r in a] == [r[0] for r in b] == ["epoch:00001", "epoch:00002"]
    got = [float(r[1].split(":")[1]) for r in a]
    want = [float(r[1].split(":")[1]) for r in b]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(pt.epoch_loss.avg, float(jx.epoch_loss.avg), rtol=1e-4)


def test_eval_metrics_match_jax(runs):
    jroot, proot, _, _ = runs
    a, b = _rows(proot, "psnr_ssim_lpips_log.txt"), _rows(jroot, "psnr_ssim_lpips_log.txt")
    assert [r[0] for r in a] == [r[0] for r in b] == ["epoch:00001", "epoch:00002"]
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(float(ra[1]), float(rb[1]), atol=1e-3, rtol=0)
        np.testing.assert_allclose(float(ra[2]), float(rb[2]), atol=1e-5, rtol=0)
        assert float(ra[3]) == float(rb[3]) == 1.0


def test_best_epoch_log_matches_jax(runs):
    jroot, proot, _, _ = runs
    (a,), (b,) = (_rows(proot, "best_epoch_psnr_ssim_lpips_log.txt"),
                  _rows(jroot, "best_epoch_psnr_ssim_lpips_log.txt"))
    assert a[0] == b[0]
    np.testing.assert_allclose(float(a[1]), float(b[1]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(a[2]), float(b[2]), atol=1e-5, rtol=0)
    assert float(a[3]) == float(b[3])


def test_lr_log_identical(runs):
    jroot, proot, _, _ = runs
    assert (proot / "logs" / FOLDER / "lr_log.txt").read_text() == \
        (jroot / "logs" / FOLDER / "lr_log.txt").read_text()


def test_same_files(runs):
    """The same log, checkpoint and result files, the same parameter
    count, and the seconds logs with the same rows and columns."""
    jroot, proot, _, _ = runs

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file() and p.parts[len(root.parts)] != "data")

    assert files(proot) == files(jroot)
    assert (proot / "logs" / FOLDER / "模型参数量.txt").read_text() == \
        (jroot / "logs" / FOLDER / "模型参数量.txt").read_text()
    a, b = _rows(proot, "train_eval_seconds_consume_log.txt"), \
        _rows(jroot, "train_eval_seconds_consume_log.txt")
    assert [(r[0], r[1][:5], r[2][:5], r[3]) for r in a] == \
        [(r[0], r[1][:5], r[2][:5], r[3]) for r in b]
    assert len(_rows(proot, "total_seconds_consume_log.txt")) == 1


def test_test_stage_matches_jax(runs):
    jroot, proot, _, _ = runs
    sub = os.path.join("results", FOLDER, "best_psnr_ssim_lpips_model", "setB", "test_log.txt")
    a = (proot / sub).read_text().split()
    b = (jroot / sub).read_text().split()
    np.testing.assert_allclose(float(a[0].split(":")[1]), float(b[0].split(":")[1]),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(a[1].split(":")[1]), float(b[1].split(":")[1]),
                               atol=1e-5, rtol=0)
    assert a[2] == b[2] == "lpips:n/a"
