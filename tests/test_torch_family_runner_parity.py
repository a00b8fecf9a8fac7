"""The port's ``main("dense" | "unet", ...)`` against the JAX package's
``main.py::main`` on the CPU: tiny widths of each family, the same
synthesized folders (eval and test images of LR 24x32, sides the UNet's
two stages take), 1 epoch, then test mode.  The port's model starts from
the JAX model's initial parameters (``models/jax_port.py``); the loaders
give both the same batches.

Bars (``test_torch_runner_parity.py``'s): the loss 1e-4 relative, PSNR
1e-3 dB, SSIM 1e-5, the learning-rate log identical, and the same log,
checkpoint and result files.  The port's command line still refuses the
two names, as root ``main.py``'s does.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)

# skip_blocks=None: both mains drop a None (the UNet takes no such argument)
COMMON = dict(loss="l1", epochs=1, batch_size=2, is_augment=True,
              train_data_name_list=["setA"], eval_data_name_list=["setB"],
              test_data_name_list=["setB"], progress=False, skip_blocks=None)
FAMILIES = {
    "dense": (dict(is_sa_attn=True, is_fusion=True, is_mult_size_conv_feat_extract=True,
                   num_blocks=(1,), skip_blocks=(0,), middle_channels=20),
              "dense_loss(l1)_sa(True)_fusion_c(20)", "dense_state_dict_from_jax"),
    "unet": (dict(n_channels=16, ch_mults=(1, 2), is_attn=(False, True), n_blocks=1,
                  n_heads=2),
             "unet_loss(l1)_n(16)_blocks(1)", "unet_state_dict_from_jax"),
}


def _make_data(root):
    """Two train images (crops of 256), one eval and one test image of HR
    96x128 (LR 24x32)."""
    rng = np.random.default_rng(0)
    for split, name, n, (h, w) in [("train", "setA", 2, (280, 300)),
                                   ("eval", "setB", 1, (96, 128)),
                                   ("test", "setB", 1, (96, 128))]:
        d = root / "data" / split / name
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(d / f"im{i}.png")
    return root


def _in(root, fn):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return fn()
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def runs(request, tmp_path_factory):
    """(family's log folder, JAX root, port root, JAX experiment, port
    experiment) after an epoch and the test stage in each root."""
    from main import main as jax_main
    from sisr_tpu_torch import __main__ as port
    from sisr_tpu_torch.models import jax_port

    family = request.param
    kw, folder, convert = FAMILIES[family]
    kw = {**COMMON, **kw}
    jroot = _make_data(tmp_path_factory.mktemp(f"jax_{family}"))
    proot = _make_data(tmp_path_factory.mktemp(f"port_{family}"))
    jx = _in(jroot, lambda: jax_main(family, is_test=False, run=False, **kw))
    pt = _in(proot, lambda: port.main(family, is_test=False, run=False, device="cpu", **kw))
    sd = getattr(jax_port, convert)(jx.state.params)
    pt.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                             strict=True)
    _in(jroot, jx.run)
    try:
        _in(proot, pt.run)
    finally:
        pt.close()
    _in(jroot, lambda: jax_main(family, is_test=True, **kw))
    _in(proot, lambda: port.main(family, is_test=True, device="cpu", **kw))
    return folder, jroot, proot, jx, pt


def _rows(root, folder, name):
    return [line.split() for line in
            (root / "logs" / folder / name).read_text().splitlines() if line.strip()]


def test_losses_match_jax(runs):
    folder, jroot, proot, jx, pt = runs
    a, b = _rows(proot, folder, "loss_log.txt"), _rows(jroot, folder, "loss_log.txt")
    assert [r[0] for r in a] == [r[0] for r in b] == ["epoch:00001"]
    np.testing.assert_allclose(float(a[0][1].split(":")[1]), float(b[0][1].split(":")[1]),
                               rtol=1e-4)
    np.testing.assert_allclose(pt.epoch_loss.avg, float(jx.epoch_loss.avg), rtol=1e-4)


def test_eval_metrics_match_jax(runs):
    folder, jroot, proot, _, _ = runs
    (a,), (b,) = (_rows(proot, folder, "psnr_ssim_lpips_log.txt"),
                  _rows(jroot, folder, "psnr_ssim_lpips_log.txt"))
    assert a[0] == b[0] == "epoch:00001"
    np.testing.assert_allclose(float(a[1]), float(b[1]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(a[2]), float(b[2]), atol=1e-5, rtol=0)
    assert float(a[3]) == float(b[3]) == 1.0


def test_lr_log_identical(runs):
    folder, jroot, proot, _, _ = runs
    assert (proot / "logs" / folder / "lr_log.txt").read_text() == \
        (jroot / "logs" / folder / "lr_log.txt").read_text()


def test_same_files_and_parameter_count(runs):
    folder, jroot, proot, _, _ = runs

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file() and p.parts[len(root.parts)] != "data")

    assert files(proot) == files(jroot)
    assert (proot / "logs" / folder / "模型参数量.txt").read_text() == \
        (jroot / "logs" / folder / "模型参数量.txt").read_text()


def test_test_stage_matches_jax(runs):
    folder, jroot, proot, _, _ = runs
    sub = os.path.join("results", folder, "best_psnr_ssim_lpips_model", "setB", "test_log.txt")
    a = (proot / sub).read_text().split()
    b = (jroot / sub).read_text().split()
    np.testing.assert_allclose(float(a[0].split(":")[1]), float(b[0].split(":")[1]),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(a[1].split(":")[1]), float(b[1].split(":")[1]),
                               atol=1e-5, rtol=0)
    assert a[2] == b[2] == "lpips:n/a"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_command_line_refuses_the_families(family):
    from sisr_tpu_torch.__main__ import parse_args

    with pytest.raises(SystemExit):
        parse_args([family])
