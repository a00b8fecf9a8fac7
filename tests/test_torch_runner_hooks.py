"""The runner's batch hooks (JAX ``experiment.py:403-413``) and its
bfloat16 runs, on the CPU.

- A subclass that overrides ``preprocess_train`` and
  ``process_{lr,hr,sr}_imgs`` sees every stage's batches where JAX's
  runner calls them (before each train epoch; train, eval and test), and
  what they return is what the step, the inference and the metrics take.
  By default they return their input.
- ``compute_dtype="bfloat16"`` (JAX's knob, which its experiments pass to
  the model): the PSNR and the GAN experiment train an epoch and evaluate
  with a bfloat16 generator; the parameters, their gradients and Adam's
  state stay float32, and the logged loss is finite.
"""

import os

import numpy as np
import torch

import pytest

from sisr_tpu_torch.experiments.hitsir_pro_experiment import (HITSIRPROExperiment,
                                                              make_experiment)
from sisr_tpu_torch.experiments.hitsir_pro_gan_experiment import HITSIRPROGANExperiment
from test_torch_dp_runner import PSNR_KW, _in, _make_data

torch.set_num_threads(1)


class Hooked(HITSIRPROExperiment):
    """Records each hook's calls and each consumer's arguments; every
    process hook returns a new tensor or array (x + 0), whose identity the
    consumers must receive; the eval SR is replaced by 0.5."""

    def __init__(self, *args, **kwargs):
        self.calls, self.returned, self.received = [], [], []
        super().__init__(*args, **kwargs)

    def preprocess_train(self):
        self.calls.append(("preprocess_train", self.start_epoch))

    def _hook(self, kind, stage, x):
        self.calls.append((kind, stage))
        out = np.full_like(x, 0.5) if (kind, stage) == ("sr", "eval") else x + 0
        self.returned.append(out)
        return out

    def process_lr_imgs(self, stage, lr_imgs):
        return self._hook("lr", stage, lr_imgs)

    def process_hr_imgs(self, stage, hr_imgs):
        return self._hook("hr", stage, hr_imgs)

    def process_sr_imgs(self, stage, sr_imgs):
        return self._hook("sr", stage, sr_imgs)

    def train_batch(self, lr_imgs, hr_imgs):
        self.received += [lr_imgs, hr_imgs]
        return super().train_batch(lr_imgs, hr_imgs)

    def _infer_one(self, lr_img):
        self.received.append(lr_img)
        return super()._infer_one(lr_img)

    def eval_batch(self, hr_img, sr_img):
        self.received += [hr_img, sr_img]
        return super().eval_batch(hr_img, sr_img)

    def test_batch(self, hr_img, sr_img, *args):
        self.received += [hr_img, sr_img]
        return super().test_batch(hr_img, sr_img, *args)


def _run(root, data, is_test):
    return _in(root, lambda: make_experiment(Hooked, "hitsir_pro", [], is_test, epochs=1,
                                             data_root=str(data), **PSNR_KW))


def test_hooks_see_every_stage_and_their_values_are_used(tmp_path):
    from sisr_tpu_torch.ops.metrics import psnr

    data = _make_data(tmp_path / "data")
    root = tmp_path / "run"
    root.mkdir()
    exp = _run(root, data, is_test=False)
    # one train step (batch 2 of 2 images), then one eval image
    assert exp.calls == [("preprocess_train", 1), ("lr", "train"), ("hr", "train"),
                         ("lr", "eval"), ("hr", "eval"), ("sr", "eval")]
    assert len(exp.received) == len(exp.returned) == 5
    assert all(got is ret for got, ret in zip(exp.received, exp.returned))
    # the metrics took the hook's SR (0.5 everywhere)
    hr = exp.returned[3]
    from sisr_tpu_torch.data.transforms import convert_image

    hr_y = convert_image(hr[0], source="[0,1]", target="y-channel")
    sr_y = convert_image(np.full_like(hr[0], 0.5), source="[0,1]", target="y-channel")
    assert abs(exp.epoch_psnr.avg - psnr(hr_y, sr_y, 1.0)) < 1e-9

    tested = _run(root, data, is_test=True)
    assert tested.calls == [("lr", "test"), ("hr", "test"), ("sr", "test")]
    assert all(got is ret for got, ret in zip(tested.received, tested.returned))
    assert os.path.exists(os.path.join(root, tested.result_path, "setB", "test_log.txt"))


def test_default_hooks_return_their_input():
    x = torch.zeros(1)
    for stage in ("train", "eval", "test"):
        for hook in (HITSIRPROExperiment.process_lr_imgs, HITSIRPROExperiment.process_hr_imgs,
                     HITSIRPROExperiment.process_sr_imgs):
            assert hook(None, stage, x) is x
    assert HITSIRPROExperiment.preprocess_train(None) is None


def _bf16(cls):
    class BF16(cls):
        def init_model(self):
            self.model_config.compute_dtype = "bfloat16"
            super().init_model()

    return BF16


@pytest.mark.parametrize("cls", [HITSIRPROExperiment, HITSIRPROGANExperiment],
                         ids=["psnr", "gan"])
def test_bf16_experiment_trains_with_float32_state(tmp_path, cls):
    data = _make_data(tmp_path / "data")
    root = tmp_path / "run"
    root.mkdir()
    exp = _in(root, lambda: make_experiment(_bf16(cls), "hitsir_pro", [], False, epochs=1,
                                            data_root=str(data), **PSNR_KW))
    assert exp.model.dtype == torch.bfloat16
    assert np.isfinite(exp.epoch_loss.avg) and np.isfinite(exp.epoch_psnr.avg)
    nets = [exp.model] + ([exp.discriminator] if cls is HITSIRPROGANExperiment else [])
    for net in nets:
        for p in net.parameters():
            assert p.dtype == torch.float32
            assert p.grad is None or p.grad.dtype == torch.float32
    for state in exp.state.optimizer.state.values():
        assert all(v.dtype == torch.float32 for k, v in state.items() if k != "step")
