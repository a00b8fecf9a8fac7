"""The port's experiment runner, command line and inference helpers on the
CPU: mirrors of ``tests/test_experiment_runner.py``'s cases (tiny model,
tiny synthesized folders, one module-scoped run), the resume contract with
the optimizer's state, LPIPS from a weights file, the other heads,
``n_devices`` without a process group, and ``python -m sisr_tpu_torch`` (both
experiments) / ``python -m sisr_tpu_torch.infer``.
The run against the JAX runner on the same data is in
``test_torch_runner_parity.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from test_experiment_runner import TINY_KW, _make_data

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FOLDER = ("hitsir_pro_loss(l1)_mulsizeconvextract(True)_casa(True)"
          "_fusion_embed_dim(20)_len(depths)(1)_augment")
TINY_FLAGS = ["--embed-dim", "20", "--depths", "2", "--num-heads", "2",
              "--base-win-size", "4", "4", "--hier-win-ratios", "0.5", "1",
              "--train-sets", "setA", "--eval-sets", "setB", "--test-sets", "setB",
              "--batch-size", "2"]


def _experiment(root, **kw):
    from sisr_tpu_torch.experiments.hitsir_pro_experiment import hitsir_pro_experiment

    args = dict(TINY_KW, device="cpu")
    args.update(kw)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return hitsir_pro_experiment(**args)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return _make_data(tmp_path_factory.mktemp("exp"))


@pytest.fixture(scope="module")
def ran_experiment(workdir):
    return _experiment(workdir, is_test=False, epochs=1), workdir


def _psnr(a, b):
    return 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def test_train_eval_artifacts(ran_experiment):
    exp, root = ran_experiment
    weights, logs = root / "weights" / FOLDER, root / "logs" / FOLDER
    for name in ("new_epoch_model.pth", "best_psnr_model.pth", "best_ssim_model.pth",
                 "best_psnr_ssim_lpips_model.pth"):
        assert (weights / name).exists(), name
    for log in ["loss_log.txt", "lr_log.txt", "psnr_ssim_lpips_log.txt",
                "best_epoch_psnr_ssim_lpips_log.txt",
                "train_eval_seconds_consume_log.txt",
                "total_seconds_consume_log.txt", "模型参数量.txt"]:
        assert (logs / log).exists(), log
    rows = (logs / "psnr_ssim_lpips_log.txt").read_text().splitlines()
    assert len(rows) == 1 and rows[0].startswith("epoch:00001")
    assert 3 < float(rows[0].split()[1]) < 60
    loss = (logs / "loss_log.txt").read_text().split()
    assert loss[0] == "epoch:00001" and float(loss[1].split(":")[1]) == exp.epoch_loss.avg
    assert exp.train_step_s > 0 and exp.train_wait_s >= 0
    assert (logs / "模型参数量.txt").read_text() == \
        f"Total parameters: {sum(p.numel() for p in exp.model.parameters())}\n"


def test_checkpoint_is_the_reference_layout(ran_experiment):
    exp, root = ran_experiment
    dic = torch.load(root / "weights" / FOLDER / "new_epoch_model.pth", map_location="cpu",
                     weights_only=True)
    assert set(dic) == {"start_epoch", "model", "optimizer"}
    assert dic["start_epoch"] == 1
    assert set(dic["model"]) == set(exp.model.state_dict())
    assert dic["optimizer"]["param_groups"][0]["betas"] == (0.9, 0.99)


def test_eval_mode_whole_vs_tiled(ran_experiment):
    exp, _ = ran_experiment
    lr = np.random.default_rng(3).random((1, 24, 20, 3), dtype=np.float32)
    exp.eval_mode = "whole"
    whole = exp._infer_one(lr)
    exp.eval_mode = "tiled"
    tiled = exp._infer_one(lr)
    exp.eval_mode = "whole"
    assert whole.shape == tiled.shape == (1, 96, 80, 3)
    assert whole.min() >= 0 and whole.max() <= 1
    # the JAX runner's bar for untrained weights
    assert _psnr(whole, tiled) > 20.0


def test_eval_precision_exact(ran_experiment):
    """'exact' evaluates a float32 copy of the model (sharing its
    parameters) with TF32 off, and gives the float32 forward's pixels."""
    exp, _ = ran_experiment
    lr = np.random.default_rng(7).random((1, 24, 20, 3), dtype=np.float32)
    with torch.no_grad():
        want = exp.model(torch.from_numpy(lr)).clamp(0, 1).numpy()
    exp.eval_precision = "exact"
    try:
        exp.init_eval()
        assert exp.eval_model is not exp.model and exp.eval_model.dtype == torch.float32
        assert exp.eval_model.conv_last.weight is exp.model.conv_last.weight
        got = exp._infer_one(lr)
    finally:
        exp.eval_precision = "fast"
        exp.init_eval()
    assert exp.eval_model is exp.model
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_eval_band_area_routing_boundary(ran_experiment):
    """Whole-image eval routes through BandedHeadSR exactly at
    eval_band_area (inclusive); both paths give the same pixels."""
    exp, _ = ran_experiment
    lr = np.random.default_rng(5).random((1, 24, 20, 3), dtype=np.float32)
    area = 24 * 20
    assert exp._banded_eval is not None  # nearest+conv upsampler
    calls = []
    real = exp._banded_eval

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    exp.eval_mode = "whole"
    old = exp.eval_band_area
    try:
        exp._banded_eval = spy
        exp.eval_band_area = area + 1  # just above -> plain whole forward
        a = exp._infer_one(lr)
        assert calls == []
        exp.eval_band_area = area      # at the threshold -> banded (>= inclusive)
        b = exp._infer_one(lr)
        assert calls == [(24, 20, 3)]
    finally:
        exp.eval_band_area = old
        exp._banded_eval = real
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_eval_bucket_pads_to_one_shape(ran_experiment):
    """eval_bucket pads every whole-image input up to bucket multiples
    (reflect, or symmetric where reflect cannot) and crops the output;
    the metrics stay within the JAX runner's bar of the exact shapes."""
    exp, _ = ran_experiment
    rng = np.random.default_rng(11)
    sizes = [(20, 24), (22, 21), (24, 18), (17, 23), (4, 6)]
    imgs = [rng.random((1, h, w, 3), dtype=np.float32) for h, w in sizes]
    exp.eval_mode = "whole"
    exact = [exp._infer_one(im) for im in imgs]
    shapes = []
    real = exp._whole_eval
    exp._whole_eval = lambda x: (shapes.append(tuple(x.shape)), real(x))[1]
    exp.eval_bucket = 24
    try:
        bucketed = [exp._infer_one(im) for im in imgs]
    finally:
        exp.eval_bucket = None
        exp._whole_eval = real
    assert shapes == [(1, 24, 24, 3)] * len(sizes)
    for (h, w), a, b in zip(sizes[:4], exact, bucketed):
        assert b.shape == a.shape == (1, h * 4, w * 4, 3)
        assert _psnr(a, b) > 20.0, (h, w)
    assert bucketed[-1].shape == (1, 16, 24, 3)   # symmetric pad: 4 < 20


def test_runner_process_pool_matches_thread_loader(ran_experiment, tmp_path_factory):
    """The default train loader is the spawned process pool; per-item
    seeding makes the epoch identical to a thread-loader run."""
    exp, root = ran_experiment
    assert exp.train_loaders[0].worker_type == "process"
    root2 = _make_data(tmp_path_factory.mktemp("thr"))
    thr = _experiment(root2, is_test=False, epochs=1, loader_worker_type="thread")
    assert thr.train_loaders[0].worker_type == "thread"
    assert thr.epoch_loss.avg == exp.epoch_loss.avg
    a = (root / "logs" / FOLDER / "loss_log.txt").read_text()
    b = (root2 / "logs" / FOLDER / "loss_log.txt").read_text()
    assert a.splitlines()[0] == b.splitlines()[0]


def test_resume_continues_from_checkpoint(ran_experiment):
    """A second run resumes at epoch 2 with the model, the optimizer's
    state and the epoch-2 learning rate of the cosine schedule."""
    from sisr_tpu_torch.configs.model_config import get_scheduler

    exp1, root = ran_experiment
    exp2 = _experiment(root, is_test=False, epochs=2, run=False)
    try:
        assert exp2.start_epoch == 2
        for (k, a), b in zip(exp1.model.state_dict().items(), exp2.model.state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
        s1, s2 = exp1.state.optimizer.state_dict(), exp2.state.optimizer.state_dict()
        assert s1["state"].keys() == s2["state"].keys() and len(s2["state"]) > 0
        for i in s1["state"]:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(s1["state"][i][key], s2["state"][i][key],
                                           rtol=0, atol=0)
        lr2 = get_scheduler(2e-5, 1e-7, 2)(1)
        assert exp2.state.optimizer.param_groups[0]["lr"] == lr2
        assert exp2.lr_log[-1].startswith("epoch:2,lr:")
        os.chdir(root)
        exp2.run()
    finally:
        os.chdir(REPO)
        exp2.close()
    rows = (root / "logs" / FOLDER / "loss_log.txt").read_text().splitlines()
    assert len(rows) == 2 and rows[1].startswith("epoch:00002")
    metrics = (root / "logs" / FOLDER / "psnr_ssim_lpips_log.txt").read_text().splitlines()
    assert len(metrics) == 2 and metrics[1].startswith("epoch:00002")
    assert int(torch.load(root / "weights" / FOLDER / "new_epoch_model.pth",
                          weights_only=True)["start_epoch"]) == 2


def test_interrupted_eval_repair(ran_experiment):
    """If the loss log is one epoch ahead of the metric log (training was
    killed mid-eval), run() backfills the missing eval before training
    (reference experiment.py:826-833)."""
    _, root = ran_experiment
    metrics_path = root / "logs" / FOLDER / "psnr_ssim_lpips_log.txt"
    saved = metrics_path.read_text()
    try:
        rows = saved.splitlines()
        metrics_path.write_text("\n".join(rows[:-1]) + ("\n" if rows[:-1] else ""))
        exp = _experiment(root, is_test=False, epochs=len(rows), run=False)
        assert exp.start_epoch - 2 == len(exp.psnr_ssim_lpips_log)
        os.chdir(root)
        try:
            exp.run()
        finally:
            os.chdir(REPO)
            exp.close()
        repaired = metrics_path.read_text().splitlines()
        assert len(repaired) == len(rows)
        assert repaired[len(rows) - 1].startswith(f"epoch:{len(rows):05d}")
    finally:
        metrics_path.write_text(saved)


def test_save_epoch_mode_5(ran_experiment, tmp_path):
    exp, _ = ran_experiment
    mc = exp.model_config
    old = (mc.checkpoint_folder, mc.log_folder)
    mc.checkpoint_folder, mc.log_folder = str(tmp_path / "w"), str(tmp_path / "l")
    try:
        os.makedirs(mc.checkpoint_folder)
        os.makedirs(mc.log_folder)
        (tmp_path / "w" / "a.pth").write_text("1")
        (tmp_path / "l" / "a.txt").write_text("1")
        exp.save_epoch_mode_5(4)
        assert not (tmp_path / "w" / "epoch=5").exists()
        exp.save_epoch_mode_5(5)
        exp.save_epoch_mode_5(10)
        assert (tmp_path / "w" / "epoch=10" / "a.pth").exists()
        assert (tmp_path / "l" / "epoch=10" / "a.txt").exists()
        assert not (tmp_path / "w" / "epoch=5").exists()
    finally:
        mc.checkpoint_folder, mc.log_folder = old


def test_nan_metric_raises(ran_experiment):
    exp, _ = ran_experiment
    hr = np.zeros((1, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="NaN"):
        exp.eval_batch(hr, np.full_like(hr, np.nan))


def test_test_stage_outputs(ran_experiment):
    _, root = ran_experiment
    exp = _experiment(root, is_test=True, epochs=2)
    result = root / "results" / FOLDER / "best_psnr_ssim_lpips_model" / "setB"
    for name in ("im0_hr.png", "im0_sr.png", "test_log.txt"):
        assert (result / name).exists(), name
    sr = np.asarray(Image.open(result / "im0_sr.png"))
    hr = np.asarray(Image.open(result / "im0_hr.png"))
    assert sr.shape == hr.shape == (84, 96, 3)
    log = (result / "test_log.txt").read_text().split()
    assert float(log[0].split(":")[1]) == exp.test_set_psnr.avg
    assert float(log[1].split(":")[1]) == exp.test_set_ssim.avg
    assert log[2] == "lpips:n/a"


# --------------------------------------------------------------------------
# what needs a process group, and the device rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw,item", [(dict(n_devices=2), "Multi-GPU")])
def test_not_ported_options_raise(workdir, kw, item):
    """The ROADMAP item ``item`` is ported now (data parallelism,
    test_torch_dp_runner.py): ``kw`` without the process group it needs
    raises, saying how to launch one."""
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        _experiment(workdir, is_test=False, epochs=1, run=False, **kw)


@pytest.mark.parametrize("kw", [dict(upsampler="pixelshuffle"),
                                dict(upsampler="pixelshuffledirect"),
                                dict(is_mult_size_conv_feat_extract=False)])
def test_other_heads_build(tmp_path, kw):
    """The other heads and the plain shallow conv build the runner; only
    the nearest+conv head evaluates through BandedHeadSR."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    exp = _experiment(_make_data(tmp_path), is_test=False, epochs=1, run=False, **kw)
    assert isinstance(exp.model, HiTSIR)
    assert (exp._banded_eval is not None) == (exp.model.upsampler == "nearest+conv")
    x = torch.from_numpy(np.random.default_rng(3).random((1, 8, 12, 3), dtype=np.float32))
    assert exp._whole_eval(x).shape == (1, 32, 48, 3)


def test_lpips_from_weights_file(workdir, tmp_path):
    """``lpips_weights_path`` (LPIPSVgg's state dict) gives the metric:
    LPIPSVgg on the Y images broadcast to RGB with normalize=False; the
    eval and test logs carry it, not the 1.0 sentinel."""
    from sisr_tpu_torch.models.vgg import LPIPSVgg

    torch.manual_seed(4)
    lp = LPIPSVgg()
    with torch.no_grad():   # lpips's heads are non-negative
        for i in range(5):
            getattr(lp, f"lin{i}").model[1].weight.abs_()
    path = tmp_path / "lpips_vgg.pth"
    torch.save(lp.state_dict(), path)
    exp = _experiment(workdir, is_test=False, epochs=1, run=False, lpips_weights_path=str(path))
    rng = np.random.default_rng(5)
    a, b = (rng.random((20, 24), dtype=np.float32) for _ in range(2))
    with torch.inference_mode():
        want = lp(*(torch.from_numpy(y)[None, :, :, None].repeat(1, 1, 1, 3) for y in (a, b)),
                  normalize=False)
    assert float(want[0]) > 0
    assert exp.lpips(a, b) == pytest.approx(float(want[0]), rel=1e-5)
    hr, sr = (rng.random((1, 20, 24, 3), dtype=np.float32) for _ in range(2))
    exp.eval_batch(hr, sr)
    assert exp.epoch_lpips.count == 1 and exp.epoch_lpips.avg != 1.0


def test_cuda_without_card_raises(workdir, monkeypatch):
    """The entry points default to the card and never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _experiment(workdir, is_test=False, epochs=1, run=False, device="cuda")


# --------------------------------------------------------------------------
# command lines
# --------------------------------------------------------------------------

def _main_py_kwargs(argv, monkeypatch):
    """What root main.py passes to its ``main`` for ``argv``."""
    import main as main_py

    got = {}
    monkeypatch.setattr(main_py, "main", lambda model, **kw: got.update(model=model, **kw))
    monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
    main_py._cli()
    return got


def _port_kwargs(argv, monkeypatch):
    import sisr_tpu_torch.__main__ as port_main

    got = {}
    monkeypatch.setattr(port_main, "main", lambda model, **kw: got.update(model=model, **kw))
    port_main.cli(argv)
    return got


@pytest.mark.parametrize("argv", [
    ["hitsir_pro"],
    ["hitsir_pro", "--test", "--test-model", "x.pth"],
    ["hitsir_pro_gan", "--epochs", "3"],
    ["hitsir_pro", "--loss", "charbonnier", "--epochs", "7", "--mlp-ratio", "1.5",
     "--upsampler", "pixelshuffle", "--no-augment", "--no-msce", "--no-casa",
     "--no-fusion", "--loader-workers", "0", "--loader-worker-type", "thread",
     "--eval-precision", "exact", "--data-root", "d"] + TINY_FLAGS,
])
def test_cli_takes_every_main_py_flag(argv, monkeypatch):
    """``python -m sisr_tpu_torch`` parses every flag of root main.py to
    the same arguments and defaults, plus ``device`` (default cuda)."""
    ref = _main_py_kwargs(argv, monkeypatch)
    got = _port_kwargs(argv, monkeypatch)
    assert got.pop("device") == "cuda"
    assert got == ref
    assert _port_kwargs(argv + ["--device", "cpu"], monkeypatch)["device"] == "cpu"


def test_cli_gan_needs_card(workdir, monkeypatch):
    """``hitsir_pro_gan`` runs on the card by default: without one it
    raises, and nothing carries on on the CPU."""
    from sisr_tpu_torch.__main__ import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(workdir)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli(["hitsir_pro_gan", "--epochs", "1"] + TINY_FLAGS)


def test_cli_no_msce_needs_card(workdir, monkeypatch):
    """``--no-msce`` as any other command: without a card it raises."""
    from sisr_tpu_torch.__main__ import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(workdir)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli(["hitsir_pro", "--no-msce", "--epochs", "1"] + TINY_FLAGS)


@pytest.mark.parametrize("argv,folder", [
    (["hitsir_pro_gan"], "hitsir_pro_gan_loss(l1)_mulsizeconvextract(True)_casa(True)"
                         "_fusion_embed_dim(20)_len(depths)(1)_augment"),
    (["hitsir_pro", "--no-msce", "--upsampler", "pixelshuffle"],
     "hitsir_pro_loss(l1)_mulsizeconvextract(False)_casa(True)_fusion_embed_dim(20)"
     "_len(depths)(1)_augment"),
], ids=["gan", "no_msce_pixelshuffle"])
def test_cli_gan_and_other_heads_run(argv, folder, tmp_path, monkeypatch):
    """``python -m sisr_tpu_torch hitsir_pro_gan --device cpu`` and
    ``hitsir_pro --no-msce --upsampler pixelshuffle``: one epoch (the GAN
    logs its d_loss), then test mode."""
    from sisr_tpu_torch.__main__ import cli

    root = _make_data(tmp_path)
    monkeypatch.chdir(root)
    base = argv + ["--device", "cpu", "--epochs", "1", "--loader-workers", "0"] + TINY_FLAGS
    cli(base)
    cli(base + ["--test"])
    loss = (root / "logs" / folder / "loss_log.txt").read_text().split()
    assert loss[0] == "epoch:00001" and np.isfinite(float(loss[1].split(":")[1]))
    assert (loss[2].startswith("d_loss:") if argv[0] == "hitsir_pro_gan" else len(loss) == 2)
    assert (root / "results" / folder / "best_psnr_ssim_lpips_model" / "setB"
            / "im0_sr.png").exists()


def test_cli_trains_and_tests_in_a_subprocess(tmp_path):
    """``python -m sisr_tpu_torch hitsir_pro --device cpu`` with the tiny
    flags: one epoch with the spawned loader workers, then test mode."""
    root = _make_data(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "sisr_tpu_torch", "hitsir_pro", "--device", "cpu",
            "--epochs", "1"] + TINY_FLAGS
    outs = []
    for extra in ([], ["--test"]):
        proc = subprocess.run(base + extra, cwd=root, env=env, capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs.append(proc.stdout)
    assert "training complete" in outs[0]
    assert "trained epochs: 1" in outs[1]
    assert (root / "logs" / FOLDER / "loss_log.txt").read_text().startswith("epoch:00001")
    assert (root / "results" / FOLDER / "best_psnr_ssim_lpips_model" / "setB"
            / "im0_sr.png").exists()


def test_infer_make_lr_matches_root_helper(tmp_path):
    """``infer --make-lr`` writes the /4 bicubic PNG of the root
    ``test_experiment.py::get_bicubic_lr``, bit for bit."""
    import test_experiment

    src = tmp_path / "hr.png"
    Image.fromarray((np.random.default_rng(2).random((83, 97, 3)) * 255)
                    .astype(np.uint8)).save(src)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "sisr_tpu_torch.infer", str(src),
                           "--make-lr"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = Path(proc.stdout.strip().splitlines()[-1])
    assert out == tmp_path / "hr_bicubic_lr.png"
    got = np.asarray(Image.open(out))
    assert got.shape == (20, 24, 3)
    out.rename(tmp_path / "port.png")
    ref = np.asarray(Image.open(test_experiment.get_bicubic_lr(str(src))))
    np.testing.assert_array_equal(got, ref)


def test_infer_main_show(tmp_path, monkeypatch):
    """``infer.main(..., show=True)`` shows the image it saved."""
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    tiny = dict(embed_dim=20, depths=(2,), num_heads=(2,), base_win_size=(4, 4),
                hier_win_ratios=(0.5, 1))
    monkeypatch.setattr(infer, "create_model",
                        lambda dtype, device: HiTSIR(**tiny).to(device).eval())
    shown = []
    monkeypatch.setattr(Image.Image, "show", lambda self, *a, **k: shown.append(self.size))
    src = tmp_path / "lr.png"
    Image.fromarray(np.zeros((12, 10, 3), np.uint8)).save(src)
    out = infer.main(str(src), str(tmp_path / "sr.png"), str(tmp_path / "absent.pth"),
                     tile="16", device="cpu", show=True)
    assert shown == [(40, 48)] and Path(out).exists()
