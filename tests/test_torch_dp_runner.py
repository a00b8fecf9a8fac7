"""The port's experiment runner under data parallelism on the CPU: two
gloo ranks, each in a working directory of its own (as JAX's
``tests/test_multiprocess.py`` runs its ranks), reading one data folder,
against the port's single-process run of the same experiment.

- ``hitsir_pro`` at ``test_experiment_runner.py``'s ``TINY_KW`` (batch 2,
  one image a rank): 1 epoch, the resume to epoch 2 (rank 0 reads the
  checkpoint, the others take its state), then test mode;
- ``hitsir_pro_gan`` (a random VGG19, replicated) for 1 epoch;
- DenseSR (``main("dense", ...)`` at test_torch_family_runner_parity.py's
  widths) for 1 epoch.

Bars: the logged losses and the eval PSNR / SSIM within rtol 1e-4 of the
single-process run's; the ranks' parameters bit-identical; rank 1's
directory empty (only rank 0 writes files or makes folders).

The parameters are not compared with the single-process run's.  Adam
moves every element by about lr per step whatever its gradient's size, so
a gradient near zero whose sign follows the summation order moves its
parameter by a whole lr one way or the other: comparing parameters after
Adam compares signs.  That is why the JAX runner's data-parallel test
(``test_experiment_runner.py::test_runner_data_parallel_matches_single_device``)
fails: one element of one leaf, 1.71e-5 against -1.57e-5 at lr 2e-5.  The
gradients of a data-parallel step are held to the single process's in
``test_torch_mesh.py``.

The ranks import this module, so it imports no JAX at module level.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sisr_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

TIMEOUT = 600.0
PSNR_KW = dict(
    loss="l1", is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
    is_fusion=True, is_augment=True, batch_size=2,
    test_model_name="best_psnr_ssim_lpips_model.pth", embed_dim=20, base_win_size=[4, 4],
    depths=[2], num_heads=[2], mlp_ratio=2, upsampler="nearest+conv",
    hier_win_ratios=[0.5, 1], train_data_name_list=["setA"], eval_data_name_list=["setB"],
    test_data_name_list=["setB"], progress=False, eval_tile=64, eval_tile_overlap=8,
    loader_workers=0, device="cpu")
DENSE_KW = dict(loss="l1", epochs=1, batch_size=2, is_augment=True, is_sa_attn=True,
                is_fusion=True, is_mult_size_conv_feat_extract=True, num_blocks=(1,),
                skip_blocks=(0,), middle_channels=20, train_data_name_list=["setA"],
                eval_data_name_list=["setB"], test_data_name_list=["setB"],
                progress=False, loader_workers=0, device="cpu")
FOLDERS = {
    "hitsir_pro": ("hitsir_pro_loss(l1)_mulsizeconvextract(True)_casa(True)"
                   "_fusion_embed_dim(20)_len(depths)(1)_augment"),
    "hitsir_pro_gan": ("hitsir_pro_gan_loss(l1)_mulsizeconvextract(True)_casa(True)"
                       "_fusion_embed_dim(20)_len(depths)(1)_augment"),
    "dense": "dense_loss(l1)_sa(True)_fusion_c(20)",
}
# (experiment, is_test, epochs) in the order each root runs them
RUNS = (("hitsir_pro", False, 1), ("hitsir_pro", False, 2), ("hitsir_pro", True, 2),
        ("hitsir_pro_gan", False, 1), ("dense", False, 1))


def _make_data(root: Path) -> Path:
    """Two train images (crops of 256), one eval and one test image."""
    rng = np.random.default_rng(0)
    for split, name, n, (h, w) in [("train", "setA", 2, (280, 300)),
                                   ("eval", "setB", 1, (96, 128)),
                                   ("test", "setB", 1, (96, 128))]:
        d = root / split / name
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(d / f"im{i}.png")
    return root


def _run(name: str, is_test: bool, epochs: int, data_root: str, **kw):
    """One experiment through the port's ``main`` in the current directory;
    returns what the checks read from it."""
    from sisr_tpu_torch.__main__ import main

    base = DENSE_KW if name == "dense" else PSNR_KW
    args = {**base, "epochs": epochs, "data_root": data_root, **kw}
    exp = main(name, is_test, **args)
    out = {"start_epoch": exp.start_epoch, "epoch_loss": exp.epoch_loss.avg,
           "params": {k: v.clone() for k, v in exp.model.state_dict().items()},
           "opt": exp.state.optimizer.state_dict()}
    if name == "hitsir_pro_gan":
        out["d_params"] = {k: v.clone() for k, v in exp.discriminator.state_dict().items()}
        out["vgg"] = {k: v.clone() for k, v in exp.f_loss_function.state_dict().items()}
    return out


def _in(root, fn):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _rank(rank, roots, data_root):
    """One rank: the refusals, then every run of ``RUNS`` in its own
    directory with ``n_devices=2``."""
    out = {}
    try:
        _in(roots[rank], lambda: _run("hitsir_pro", False, 1, data_root, run=False))
        out["no_n_devices"] = None
    except RuntimeError as exc:
        out["no_n_devices"] = str(exc)
    try:
        _in(roots[rank], lambda: _run("hitsir_pro", False, 1, data_root, n_devices=2,
                                      batch_size=3, run=False))
        out["odd_batch"] = None
    except ValueError as exc:
        out["odd_batch"] = str(exc)
    for name, is_test, epochs in RUNS:
        out[(name, is_test, epochs)] = _in(
            roots[rank], lambda: _run(name, is_test, epochs, data_root, n_devices=2))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(single-process root, the ranks' roots, single results, the ranks'
    results) after every run of ``RUNS`` in each."""
    data = str(_make_data(tmp_path_factory.mktemp("data")))
    single = tmp_path_factory.mktemp("single")
    roots = [str(tmp_path_factory.mktemp(f"rank{r}")) for r in range(2)]
    got = M.spawn(_rank, 2, roots, data, device="cpu", timeout=TIMEOUT)
    ref = {run: _in(single, lambda: _run(*run, data)) for run in RUNS}
    return single, [Path(r) for r in roots], ref, got


def _rows(root, name, log):
    return [line.split() for line in
            (Path(root) / "logs" / FOLDERS[name] / log).read_text().splitlines() if line.strip()]


def _losses(root, name):
    return [[float(c.split(":")[1]) for c in row[1:]] for row in _rows(root, name, "loss_log.txt")]


@pytest.mark.parametrize("name", sorted(FOLDERS))
def test_logged_losses_match_single_process(runs, name):
    single, roots, _, _ = runs
    want, got = _losses(single, name), _losses(roots[0], name)
    assert len(got) == len(want) == (2 if name == "hitsir_pro" else 1)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(FOLDERS))
def test_eval_metrics_match_single_process(runs, name):
    single, roots, _, _ = runs
    cols = lambda root: np.array([[float(c) for c in row[1:3]] for row in
                                  _rows(root, name, "psnr_ssim_lpips_log.txt")])
    want, got = cols(single), cols(roots[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("run", RUNS, ids=lambda r: str(r))
def test_ranks_bit_identical(runs, run):
    """Both ranks end every run with the same parameters and optimizer
    state (and, in GAN mode, discriminator and VGG19), bit for bit."""
    a, b = (res[run] for res in runs[3])
    assert a["start_epoch"] == b["start_epoch"]
    for key in ("params", "d_params", "vgg"):
        for k, v in a.get(key, {}).items():
            assert torch.equal(b[key][k], v), (key, k)
    for i, st in a["opt"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(b["opt"]["state"][i][k]), torch.as_tensor(v))


def test_resume_loads_on_rank_zero_and_agrees(runs):
    """The epoch-2 run resumed from rank 0's checkpoint: both ranks start
    at epoch 2 (rank 1 has no checkpoint of its own) and log the second
    epoch's loss as the single process does; test mode on both ranks."""
    single, roots, ref, got = runs
    for res in got:
        assert res[("hitsir_pro", False, 2)]["start_epoch"] == 2
        test_run = ("hitsir_pro", True, 2)
        assert res[test_run]["start_epoch"] == ref[test_run]["start_epoch"] > 1
    assert [r[0] for r in _rows(roots[0], "hitsir_pro", "loss_log.txt")] == \
        ["epoch:00001", "epoch:00002"]
    sr = lambda root: np.asarray(Image.open(
        Path(root) / "results" / FOLDERS["hitsir_pro"] / "best_psnr_ssim_lpips_model" / "setB"
        / "im0_sr.png"), dtype=np.float32)
    assert np.abs(sr(roots[0]) - sr(single)).max() <= 1.0


def test_rank_one_writes_nothing(runs):
    _, roots, _, _ = runs
    assert list(roots[1].iterdir()) == []
    assert (roots[0] / "weights" / FOLDERS["hitsir_pro_gan"]
            / "discriminator_new_epoch_model.pth").exists()
    assert sorted(p.name for p in (roots[0] / "logs" / FOLDERS["dense"]).iterdir()) == \
        sorted(p.name for p in (runs[0] / "logs" / FOLDERS["dense"]).iterdir())


def test_n_devices_needs_a_group_of_that_size(runs, tmp_path):
    """n_devices=2 without a process group raises, a group of 2 with
    n_devices None raises, and so does a batch that does not split."""
    _, _, _, got = runs
    for res in got:
        assert "n_devices=2" in res["no_n_devices"]
        assert "must divide" in res["odd_batch"]
    with pytest.raises(RuntimeError, match="torchrun"):
        _in(tmp_path, lambda: _run("hitsir_pro", False, 1, str(tmp_path), n_devices=2,
                                   run=False))
