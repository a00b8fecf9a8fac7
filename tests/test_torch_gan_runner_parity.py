"""The port's GAN fine-tune runner against the JAX runner on the CPU: the
same tiny configuration (``tests/test_gan_experiment_runner.py``'s
``TINY_KW``), the same synthesized folders, 1 epoch, a resume to epoch 2
(from ``discriminator_new_epoch_model.pth``), then test mode.  Both start
from the JAX experiment's generator and discriminator (with its u, v),
carried across by ``models/jax_port.py``; both read the same random VGG19
and LPIPS weights, written for each package in its own format (flax
msgpack for JAX, ``torch.save`` for the port).

Bars: the generator and discriminator losses 1e-4 relative, PSNR 1e-3 dB,
SSIM 1e-5, LPIPS 1e-4 relative, the lr log identical, the same log,
checkpoint and result files.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_gan_experiment_runner import TINY_KW

torch.set_num_threads(1)

FOLDER = ("hitsir_pro_gan_loss(l1)_mulsizeconvextract(False)_casa(False)"
          "_embed_dim(20)_len(depths)(1)")


def _make_data(root):
    """test_gan_experiment_runner.py's folders."""
    rng = np.random.default_rng(0)
    for split, name, n, size in [("train", "setA", 2, (300, 280)),
                                 ("eval", "setB", 1, (72, 68)),
                                 ("test", "setB", 1, (72, 68))]:
        d = root / "data" / split / name
        d.mkdir(parents=True)
        for i in range(n):
            arr = (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"im{i}.png")
    return root


def _in(root, fn):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _weights(tmp):
    """Random full-width VGG19 (perceptual) and LPIPS(vgg) weights: flax
    msgpack files for JAX, torch files for the port."""
    import jax
    import jax.numpy as jnp
    from flax import serialization
    from sisr_tpu.models.vgg import LPIPSVgg, VGGFeatures
    from sisr_tpu_torch.models.jax_port import (lpips_state_dict_from_jax,
                                                vgg_state_dict_from_jax)

    x = jnp.zeros((1, 32, 32, 3))
    vgg = VGGFeatures().init(jax.random.PRNGKey(3), x)
    lp = LPIPSVgg().init(jax.random.PRNGKey(4), x, x)
    paths = {}
    for name, variables, port in (("perceptual", vgg, vgg_state_dict_from_jax(vgg)),
                                  ("lpips", lp, lpips_state_dict_from_jax(lp))):
        jpath, ppath = tmp / f"{name}.msgpack", tmp / f"{name}.pth"
        jpath.write_bytes(serialization.msgpack_serialize(
            {"params": serialization.to_state_dict(variables["params"])}))
        torch.save({k: torch.from_numpy(v) for k, v in port.items()}, ppath)
        paths[name] = (str(jpath), str(ppath))
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX root, port root) after 1 epoch, the resume to epoch 2 and
    the test stage in each."""
    from sisr_tpu.experiments.hitsir_pro_gan_experiment import (
        hitsir_pro_gan_experiment as jax_exp)
    from sisr_tpu_torch.experiments.hitsir_pro_gan_experiment import hitsir_pro_gan_experiment
    from sisr_tpu_torch.models.jax_port import (discriminator_state_dict_from_jax,
                                                state_dict_from_jax)

    paths = _weights(tmp_path_factory.mktemp("weights"))
    jkw = dict(TINY_KW, perceptual_weights_path=paths["perceptual"][0],
               lpips_weights_path=paths["lpips"][0])
    pkw = dict(TINY_KW, perceptual_weights_path=paths["perceptual"][1],
               lpips_weights_path=paths["lpips"][1], device="cpu")
    jroot = _make_data(tmp_path_factory.mktemp("jax"))
    proot = _make_data(tmp_path_factory.mktemp("port"))
    jx = _in(jroot, lambda: jax_exp(is_test=False, epochs=1, run=False, **jkw))
    pt = _in(proot, lambda: hitsir_pro_gan_experiment(is_test=False, epochs=1, run=False,
                                                      **pkw))
    load = lambda m, sd: m.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    load(pt.model, state_dict_from_jax(jx.state.params))
    load(pt.discriminator, discriminator_state_dict_from_jax(jx.d_state.params,
                                                             jx.d_collections))
    _in(jroot, jx.run)
    try:
        _in(proot, pt.run)
    finally:
        pt.close()
    for epochs, is_test in ((2, False), (2, True)):
        _in(jroot, lambda: jax_exp(is_test=is_test, epochs=epochs, **jkw))
        _in(proot, lambda: hitsir_pro_gan_experiment(is_test=is_test, epochs=epochs, **pkw))
    return jroot, proot


def _rows(root, name):
    return [line.split() for line in
            (root / "logs" / FOLDER / name).read_text().splitlines() if line.strip()]


def test_losses_match_jax(runs):
    """loss (the generator's, over the sum of the loss weights) and d_loss
    of both epochs."""
    jroot, proot = runs
    a, b = _rows(proot, "loss_log.txt"), _rows(jroot, "loss_log.txt")
    assert [r[0] for r in a] == [r[0] for r in b] == ["epoch:00001", "epoch:00002"]
    for ra, rb in zip(a, b):
        assert [c.split(":")[0] for c in ra[1:]] == [c.split(":")[0] for c in rb[1:]] == \
            ["loss", "d_loss"]
        np.testing.assert_allclose([float(c.split(":")[1]) for c in ra[1:]],
                                   [float(c.split(":")[1]) for c in rb[1:]], rtol=1e-4)


def test_eval_metrics_match_jax(runs):
    """PSNR, SSIM and a real LPIPS value (not the 1.0 sentinel)."""
    jroot, proot = runs
    a, b = _rows(proot, "psnr_ssim_lpips_log.txt"), _rows(jroot, "psnr_ssim_lpips_log.txt")
    assert [r[0] for r in a] == [r[0] for r in b] == ["epoch:00001", "epoch:00002"]
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(float(ra[1]), float(rb[1]), atol=1e-3, rtol=0)
        np.testing.assert_allclose(float(ra[2]), float(rb[2]), atol=1e-5, rtol=0)
        assert float(ra[3]) != 1.0 and np.isfinite(float(ra[3]))
        np.testing.assert_allclose(float(ra[3]), float(rb[3]), rtol=1e-4)


def test_lr_log_identical(runs):
    jroot, proot = runs
    text = (proot / "logs" / FOLDER / "lr_log.txt").read_text()
    assert text == (jroot / "logs" / FOLDER / "lr_log.txt").read_text()
    assert "discriminator_lr:" in text.splitlines()[-1]


def test_same_files(runs):
    jroot, proot = runs

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file() and p.parts[len(root.parts)] != "data")

    assert files(proot) == files(jroot)
    assert (proot / "logs" / FOLDER / "模型参数量.txt").read_text() == \
        (jroot / "logs" / FOLDER / "模型参数量.txt").read_text()


def test_discriminator_checkpoint(runs):
    """``discriminator_new_epoch_model.pth``: the reference's dict, epoch 2,
    the model with its spectral norm's u, v, the optimizer's state."""
    _, proot = runs
    dic = torch.load(proot / "weights" / FOLDER / "discriminator_new_epoch_model.pth",
                     map_location="cpu", weights_only=True)
    assert set(dic) == {"start_epoch", "model", "optimizer"} and dic["start_epoch"] == 2
    assert "conv1.weight_u" in dic["model"] and "conv8.weight_v" in dic["model"]
    assert len(dic["optimizer"]["state"]) == 12    # conv0, conv1-8 (weight_orig), conv9


def test_test_stage_matches_jax(runs):
    jroot, proot = runs
    sub = os.path.join("results", FOLDER, "best_psnr_ssim_lpips_model", "setB", "test_log.txt")
    a = (proot / sub).read_text().split()
    b = (jroot / sub).read_text().split()
    np.testing.assert_allclose(float(a[0].split(":")[1]), float(b[0].split(":")[1]),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(a[1].split(":")[1]), float(b[1].split(":")[1]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(a[2].split(":")[1]), float(b[2].split(":")[1]),
                               rtol=1e-4)
