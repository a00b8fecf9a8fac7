"""Config-driven experiment runner: train / eval / test / resume (port of
``sisr_tpu/experiments/experiment.py``).

Lifecycle parity with reference experiments/experiment.py:25-878:
  * data loaders per named dataset (train list, one-or-more eval/test sets)
  * model init hook (subclasses), trainable-param count logged to
    ``模型参数量.txt``
  * checkpoint contract: ``new_epoch_model.pth`` every epoch + four
    best-metric checkpoints on eval improvement (:517-537)
  * text-log contract under log_folder: loss_log.txt, lr_log.txt,
    psnr_ssim_lpips_log.txt, best_epoch_psnr_ssim_lpips_log.txt,
    train_eval_seconds_consume_log.txt, total_seconds_consume_log.txt;
    the logs double as resumable state (:282-340)
  * resume: weights and optimizer state from new_epoch_model.pth, cosine LR
    rebuilt from start_epoch (:247-252), interrupted-eval repair
    (:826-833), rolling epoch=N snapshot folders every 5 epochs (:857-878)
  * eval/test metrics: Y-channel PSNR / SSIM (+ gaussian SSIM in test
    mode), LPIPS when a weights file is given (else logged as its neutral
    1.0); NaN metrics raise (:489-491)
  * GAN mode (``gan_mode``, set by the GAN experiment): the discriminator's
    checkpoint drives the resume epoch, the generator's optimizer state is
    not loaded on the first GAN epoch, and the subclass writes the loss
    and lr logs

The train step is ``train_state.make_train_step`` (the kernels forward,
their autograd Functions backward), fed by the host loader through
``data/prefetch.py``; ``train_steps`` yields after each step of an epoch,
so that a caller can drive the runner one step at a time.  Eval and test run the whole image (``BandedHeadSR``
at or above ``eval_band_area`` input pixels) or overlap-blended tiles
(``TiledSR``).  Everything runs on ``device``, the card unless the caller
asks for the CPU.

Data parallelism (``n_devices`` > 1; JAX's batch sharded on a 1-D mesh):
one process per device, each in a process group of ``n_devices`` ranks
(``parallel/mesh.py::initialize_distributed``).  Each rank's train loader
collates its slice of every global batch; the step averages the gradients
over the ranks; rank 0 reads a checkpoint and ``replicate`` hands its
model, optimizer state and epoch to the others; eval and test run whole on
every rank; only rank 0 writes files or makes folders.  The dropout masks
come from one generator seeded alike on every rank and drawn at the global
batch's shape (``ops/dropout.py``), so the ranks drop what one process
drops over the whole batch.

Subclasses override the reference's batch hooks: ``preprocess_train``
before each train epoch, ``process_{lr,hr,sr}_imgs(stage, x)`` on every
batch of the stages "train", "eval" and "test" (identity by default).
"""

from __future__ import annotations

import contextlib
import copy
import glob
import os
import shutil
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from sisr_tpu_torch.configs.dataset_config import DatasetConfig
from sisr_tpu_torch.configs.model_config import (ModelConfig, get_loss_function,
                                                 get_optimizer, get_scheduler)
from sisr_tpu_torch.data.dataset import DataLoader, SRDataset
from sisr_tpu_torch.data.prefetch import device_prefetch
from sisr_tpu_torch.data.transforms import convert_image
from sisr_tpu_torch.ops.metrics import psnr as psnr_fn, ssim as ssim_fn
from sisr_tpu_torch.parallel.mesh import make_mesh, process_zero, replicate
from sisr_tpu_torch.parallel.tiling import BandedHeadSR, TiledSR
from sisr_tpu_torch.train import checkpoint as ckpt
from sisr_tpu_torch.train.train_state import (TrainState, create_train_state,
                                              make_train_step, set_learning_rate)
from sisr_tpu_torch.utils.meters import AverageMeter, format_str
from sisr_tpu_torch.utils.precision import exact_mode
from sisr_tpu_torch.utils.profiling import span


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises
    (nothing carries on on the CPU unless asked to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run on the CPU")
    return device


class Experiment:
    """Abstract experiment; subclasses implement ``init_model``, which sets
    ``self.model`` (an ``nn.Module`` on ``self.device``) and then calls
    this class's ``init_model``."""

    # GAN experiments own the resume epoch (driven by the discriminator
    # checkpoint) and the loss/lr log writes (they append d_loss first)
    gan_mode = False

    def __init__(
        self,
        train_data_config: DatasetConfig,
        eval_data_config: DatasetConfig,
        test_data_config: DatasetConfig,
        model_config: ModelConfig,
        is_test: bool,
        # 'whole' follows the reference eval protocol (whole-image forward,
        # experiment.py:746-748) so metric logs are comparable; 'tiled' is
        # the serving path
        eval_mode: str = "whole",
        eval_tile: int = 192,
        eval_tile_overlap: int = 16,
        # pad-to-bucket for whole-image eval: round (H, W) up to multiples
        # of this, run, crop.  None (default) keeps the exact reference
        # protocol: this model is NOT padding-invariant (window attention +
        # global SCA pooling see the pad), so bucketed metrics differ
        eval_bucket: Optional[int] = None,
        # 'fast' evaluates in the training compute dtype; 'exact' in
        # float32 with TF32 off (utils/precision.py::exact_mode), the
        # kernels still on
        eval_precision: str = "fast",
        # whole-image eval routes through the banded-head runner
        # (BandedHeadSR) at/above this input area (px); the head banding is
        # value-identical, it only bounds the head's activation memory
        eval_band_area: int = 640 * 640,
        # LPIPSVgg's state dict, torch.save'd (models/vgg.py); None logs
        # LPIPS as its neutral 1.0
        lpips_weights_path: Optional[str] = None,
        progress: bool = True,
        # data parallelism: the ranks of the initialized process group
        # (one process per device), each with its slice of every batch
        n_devices: Optional[int] = None,
        device="cuda",
    ):
        if eval_precision not in ("fast", "exact"):
            raise ValueError(f"eval_precision must be 'fast' or 'exact', got {eval_precision!r}")
        if eval_mode not in ("whole", "tiled"):
            raise ValueError(f"eval_mode must be 'whole' or 'tiled', got {eval_mode!r}")
        self.mesh = self._make_mesh(n_devices, model_config.batch_size, resolve_device(device))
        self.device = self.mesh.device
        self.eval_precision = eval_precision
        self.eval_band_area = eval_band_area
        self.eval_tile = eval_tile
        self.eval_tile_overlap = eval_tile_overlap
        self.eval_bucket = eval_bucket
        self.train_data_config = train_data_config
        self.eval_data_config = eval_data_config
        self.test_data_config = test_data_config
        self.model_config = model_config
        self.is_test = is_test
        self.eval_mode = eval_mode
        self.progress = progress

        self.lpips = self._init_lpips(lpips_weights_path)

        self.train_loaders: List[DataLoader] = []
        self.eval_loaders: List[DataLoader] = []
        self.test_loaders: List[DataLoader] = []

        # filled by init_model (subclass)
        self.model: Optional[torch.nn.Module] = None
        self.state: Optional[TrainState] = None
        self.loss_function: Optional[Callable] = None
        self.lr_schedule = None
        self.start_epoch = 1
        # stands where the JAX runner threads its step key: every dropout
        # mask of a train step (the rates are 0 in every experiment's
        # config) is drawn from it, seeded alike on every rank
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        # host time of the last train epoch: waiting on the loader, and in
        # the steps (each ends in a sync: the loss is read back)
        self.train_wait_s = 0.0
        self.train_step_s = 0.0

        cf = self.model_config.checkpoint_folder
        self.new_model_path = os.path.join(cf, "new_epoch_model.pth")
        self.best_psnr_model_path = os.path.join(cf, "best_psnr_model.pth")
        self.best_ssim_model_path = os.path.join(cf, "best_ssim_model.pth")
        self.best_lpips_model_path = os.path.join(cf, "best_lpips_model.pth")
        self.best_psnr_ssim_lpips_model_path = os.path.join(
            cf, "best_psnr_ssim_lpips_model.pth")

        self.init_data_loaders()
        self.init_model()
        self.init_optimizer_loss_function()
        self.load_model_weights_scheduler()

        self.result_path = os.path.join(
            self.model_config.result_folder,
            os.path.basename(self.model_config.test_model_path).split(".")[0])
        self.result_data_paths = [os.path.join(self.result_path, loader.name)
                                  for loader in self.test_loaders]

        # metric logs (lists of text rows, resumable)
        self.loss_log: List[List[str]] = []
        self.best_epoch_psnr_ssim_lpips_log = [-1, -1, -1, 1]
        self.psnr_ssim_lpips_log: List[List[str]] = []
        self.only_best_psnr = -1.0
        self.only_best_ssim = -1.0
        self.only_best_lpips = 1.0
        self.lr_log = [f"epoch:{self.start_epoch},lr:"
                       f"{format_str(self.current_lr(), 25)}"]
        self.train_eval_seconds_consume_log: List[List[str]] = []
        self.total_seconds_consume_log = [0.0]
        self.load_log()
        self.init_tools()

    # ------------------------------------------------------------------ setup

    @staticmethod
    def _make_mesh(n_devices: Optional[int], batch_size: int, device: torch.device):
        """The data-parallel mesh: the initialized group's ranks, which
        ``n_devices`` must name (``make_mesh`` raises on another size, or
        on n_devices > 1 with no group), else one rank on ``device``."""
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_available() and torch.distributed.is_initialized()
                 else 1)
        if n_devices is None and world > 1:
            raise RuntimeError(f"a process group of {world} ranks is initialized: pass "
                               f"n_devices={world}, or each rank trains alone on the same files")
        if n_devices and batch_size % n_devices:
            raise ValueError(f"batch_size {batch_size} must divide over n_devices "
                             f"{n_devices} for data parallelism")
        return make_mesh(n_devices, device=device)

    def _init_lpips(self, weights_path: Optional[str]):
        """LPIPS(vgg) as a function of two Y images, from ``LPIPSVgg``'s
        state dict in the file ``weights_path``; None (LPIPS logged as its
        neutral 1.0) without a file, as in the JAX runner.  Under data
        parallelism rank 0 reads the file and hands the weights on."""
        if not replicate(self.mesh, bool(weights_path and os.path.exists(weights_path))):
            return None
        from sisr_tpu_torch.models.vgg import LPIPSVgg

        model = LPIPSVgg()
        if process_zero():
            model.load_state_dict(torch.load(weights_path, map_location="cpu",
                                             weights_only=True), strict=True)
        model = replicate(self.mesh, model.to(self.device).eval())

        def compute(a_y: np.ndarray, b_y: np.ndarray) -> float:
            # reference quirks (experiment.py:469): LPIPS is fed the (h, w)
            # Y image, broadcast across RGB, with lpips.LPIPS's default
            # normalize=False: the [0,1] image is taken as already in [-1,1]
            a, b = (torch.from_numpy(np.ascontiguousarray(y, dtype=np.float32))
                    .to(self.device)[None, :, :, None].expand(1, *y.shape, 3)
                    for y in (a_y, b_y))
            with torch.inference_mode():
                return float(model(a, b, normalize=False)[0])

        return compute

    def init_data_loaders(self, is_shuffle: bool = True):
        mc = self.model_config
        for i, path in enumerate(mc.train_data_path_list):
            # per-set seed: augmentation/degradation randomness becomes a pure
            # function of (seed, epoch, index), reproducible across workers
            dataset = SRDataset(self.train_data_config, path, seed=1009 + i)
            loader = DataLoader(dataset, batch_size=mc.batch_size, shuffle=is_shuffle,
                                drop_last=True, seed=i,
                                name=mc.train_data_name_list[i],
                                num_workers=mc.loader_workers,
                                worker_type=mc.loader_worker_type,
                                rank=self.mesh.rank, world=self.mesh.size)
            self.train_loaders.append(loader)
        for i, path in enumerate(mc.eval_data_path_list):
            dataset = SRDataset(self.eval_data_config, path)
            loader = DataLoader(dataset, batch_size=1, name=mc.eval_data_name_list[i])
            self.eval_loaders.append(loader)
        if self.is_test:
            for i, path in enumerate(mc.test_data_path_list):
                dataset = SRDataset(self.test_data_config, path)
                loader = DataLoader(dataset, batch_size=1, name=mc.test_data_name_list[i])
                self.test_loaders.append(loader)

    def close(self):
        """Stop every loader's worker processes."""
        for loader in self.train_loaders + self.eval_loaders + self.test_loaders:
            loader.close()

    def init_model(self):
        if self.train_data_config.image_size % self.train_data_config.scaling_factor:
            raise ValueError("the HR crop must be a multiple of the scaling factor")
        self.print_total_params_num()
        self.init_eval()

    def init_eval(self):
        """The eval and test runners over ``self.model`` for the current
        ``eval_precision`` (its parameters, not copies of them)."""
        scale = getattr(self.model_config, "scaling_factor", 4)
        eval_model = self.model
        if self.eval_precision == "exact":
            # the same modules computing in float32 (as BandedHeadSR's
            # packed-head copy, a shallow copy shares every parameter)
            eval_model = copy.copy(self.model)
            eval_model.dtype = torch.float32
        self.eval_model = eval_model
        self.tiled = TiledSR(eval_model, scale=scale, tile=self.eval_tile,
                             overlap=self.eval_tile_overlap)
        self._whole_eval = lambda x: eval_model(x).clamp(0, 1)
        # large whole-image eval streams the x4 head over feature-row bands
        # (parallel/tiling.py::BandedHeadSR), which bounds the head's
        # activation memory (a 4x-resolution map of num_feat channels)
        self._banded_eval = None
        if getattr(self.model_config, "upsampler", None) == "nearest+conv":
            self._banded_eval = BandedHeadSR(eval_model)

    def print_total_params_num(self):
        total = sum(p.numel() for p in self.model.parameters())
        descr = f"Total parameters: {total}"
        print(descr)
        if not process_zero():
            return
        with open(os.path.join(self.model_config.log_folder, "模型参数量.txt"), "w") as f:
            f.write(descr + "\n")

    def init_optimizer_loss_function(self):
        mc = self.model_config
        tx = get_optimizer(mc.optimizer, self.model.parameters(), mc.learning_rate,
                           mc.optimizer_params)
        self.loss_function = get_loss_function(mc.loss_function)
        self.lr_schedule = get_scheduler(mc.learning_rate, mc.min_learning_rate, mc.epochs)
        self.state = create_train_state(self.model, tx)
        self.train_step = make_train_step(self.model, self.loss_function, tx, mesh=self.mesh)

    def load_model_weights_scheduler(self, is_gan_start: bool = False):
        """Load ``new_epoch_model.pth`` (test mode: the test model): the
        weights, and the optimizer's state unless ``is_gan_start`` (the
        first GAN epoch starts a fresh optimizer on PSNR-trained weights).
        In GAN mode the discriminator's checkpoint sets the epoch.  Rank 0
        reads the file; ``_replicate_state`` hands the state on."""
        path = self.model_config.test_model_path if self.is_test else self.new_model_path
        if process_zero() and os.path.exists(path):
            loaded = ckpt.load_any(path, self.model,
                                   None if is_gan_start else self.state.optimizer)
            if not self.gan_mode:
                self.start_epoch = loaded["start_epoch"] + 1
            print(f"loaded weights from {path}, trained epochs: {self.start_epoch - 1}")
        self._replicate_state()
        self._sync_epoch_lr()

    def _replicate_state(self):
        """Rank 0's model, optimizer state and epoch on every rank, after
        the init and after every load (no collective without a group)."""
        replicate(self.mesh, self.model)
        replicate(self.mesh, self.state.optimizer)
        self.start_epoch = replicate(self.mesh, self.start_epoch)

    def current_lr(self) -> float:
        return self.lr_schedule(self.start_epoch - 1)

    def _sync_epoch_lr(self):
        """Drive the per-epoch cosine schedule into the optimizer's lr
        (replaces torch's scheduler reconstruction, experiment.py:247-252)."""
        set_learning_rate(self.state.optimizer, self.current_lr())

    def save_model_weights(self, model_path: str):
        """The checkpoint at ``model_path``, traced as ``sisr.ckpt.save``."""
        if not process_zero():
            return
        with span("ckpt.save"):
            ckpt.save_checkpoint(model_path, self.start_epoch, self.state.model,
                                 self.state.optimizer)

    def init_tools(self):
        self.epoch_loss = AverageMeter()
        self.train_start_time = None
        self.epoch_psnr = AverageMeter()
        self.epoch_ssim = AverageMeter()
        self.epoch_lpips = AverageMeter()
        self.eval_start_time = None
        self.test_set_psnr = AverageMeter()
        self.test_set_ssim = AverageMeter()
        self.test_set_lpips = AverageMeter()
        self.test_start_time = None

    # ------------------------------------------------------------------- logs

    def _log_paths(self):
        lf = self.model_config.log_folder
        return {
            "loss": os.path.join(lf, "loss_log.txt"),
            "psnr_ssim_lpips": os.path.join(lf, "psnr_ssim_lpips_log.txt"),
            "best": os.path.join(lf, "best_epoch_psnr_ssim_lpips_log.txt"),
            "lr": os.path.join(lf, "lr_log.txt"),
            "seconds": os.path.join(lf, "train_eval_seconds_consume_log.txt"),
            "total_seconds": os.path.join(lf, "total_seconds_consume_log.txt"),
        }

    @staticmethod
    def _write_rows(path: str, rows):
        if not process_zero():
            return
        with open(path, "w") as f:
            for row in rows:
                f.write(" ".join(str(c) for c in row) if isinstance(row, (list, tuple))
                        else str(row))
                f.write("\n")

    @staticmethod
    def _read_rows(path: str) -> List[List[str]]:
        with open(path) as f:
            return [line.split() for line in f.read().splitlines() if line.strip()]

    def load_log(self):
        if self.is_test:
            return
        p = self._log_paths()
        self.loss_log_path = p["loss"]
        self.psnr_ssim_lpips_log_path = p["psnr_ssim_lpips"]
        self.best_epoch_psnr_ssim_lpips_log_path = p["best"]
        self.lr_log_path = p["lr"]
        self.train_eval_seconds_consume_log_path = p["seconds"]
        self.total_seconds_consume_log_path = p["total_seconds"]

        if os.path.exists(p["loss"]):
            self.loss_log = self._read_rows(p["loss"])
        if os.path.exists(p["psnr_ssim_lpips"]):
            self.psnr_ssim_lpips_log = self._read_rows(p["psnr_ssim_lpips"])
            arr = np.array(self.psnr_ssim_lpips_log)
            self.only_best_psnr = arr[:, 1].astype(float).max()
            self.only_best_ssim = arr[:, 2].astype(float).max()
            self.only_best_lpips = arr[:, 3].astype(float).min()
        if os.path.exists(p["best"]):
            rows = self._read_rows(p["best"])
            flat = [c for row in rows for c in row]
            self.best_epoch_psnr_ssim_lpips_log = [float(x) for x in flat[:4]]
        if os.path.exists(p["lr"]):
            self.lr_log = [" ".join(r) for r in self._read_rows(p["lr"])]
        if not self.gan_mode and self.lr_log:
            self.lr_log[-1] = (f"epoch:{self.start_epoch},"
                               f"lr:{format_str(self.current_lr(), 25)}")
        if os.path.exists(p["seconds"]):
            self.train_eval_seconds_consume_log = self._read_rows(p["seconds"])
            for item in self.train_eval_seconds_consume_log:
                self.total_seconds_consume_log[0] += float(item[1].split("训练时长:")[1])
                if item[2] != "None":
                    self.total_seconds_consume_log[0] += float(item[2].split("验证时长:")[1])
        # rank 0's logs on every rank: they decide the interrupted-eval
        # repair, and a rank in a directory of its own has none
        names = ("loss_log", "psnr_ssim_lpips_log", "only_best_psnr", "only_best_ssim",
                 "only_best_lpips", "best_epoch_psnr_ssim_lpips_log", "lr_log",
                 "train_eval_seconds_consume_log", "total_seconds_consume_log")
        for k, v in replicate(self.mesh, {k: getattr(self, k) for k in names}).items():
            setattr(self, k, v)

    def __save_log(self):
        self._write_rows(self.train_eval_seconds_consume_log_path,
                         self.train_eval_seconds_consume_log)
        self._write_rows(self.psnr_ssim_lpips_log_path, self.psnr_ssim_lpips_log)
        self._write_rows(self.best_epoch_psnr_ssim_lpips_log_path,
                         [self.best_epoch_psnr_ssim_lpips_log])
        self._write_rows(self.total_seconds_consume_log_path,
                         [self.total_seconds_consume_log[0]])

    # ------------------------------------------------------------------ train

    def preprocess_train(self):
        """Runs before each train epoch (the reference's hook)."""

    def process_lr_imgs(self, stage: str, lr_imgs):
        """The LR batch of ``stage`` ("train", "eval", "test") as the step
        or the inference takes it."""
        return lr_imgs

    def process_hr_imgs(self, stage: str, hr_imgs):
        """The HR batch of ``stage`` as the loss or the metrics take it."""
        return hr_imgs

    def process_sr_imgs(self, stage: str, sr_imgs):
        """The SR of ``stage`` ("eval", "test") as the metrics take it."""
        return sr_imgs

    def train_batch(self, lr_imgs: torch.Tensor, hr_imgs: torch.Tensor):
        # the global batch's loss, counted at the global batch's size
        loss = self.train_step(lr_imgs, hr_imgs, self._generator)
        self.epoch_loss.update(float(loss), len(hr_imgs) * self.mesh.size)

    def train(self):
        """One epoch: ``train_steps`` run to its end."""
        for _ in self.train_steps():
            pass

    def train_steps(self):
        """One epoch of train steps, yielding after each (a caller may drive
        the runner a step at a time); after the last, the epoch's
        bookkeeping and checkpoint (``train_dataloader_process``).  The wait
        for each batch is timed into ``train_wait_s`` and traced as
        ``sisr.loader.wait``."""
        self.epoch_loss.reset()
        self.train_wait_s = self.train_step_s = 0.0
        self.train_start_time = time.time()
        for loader in self.train_loaders:
            it = device_prefetch(loader, size=2, device=self.device)
            if self.progress:
                from tqdm import tqdm
                it = tqdm(it, total=len(loader),
                          desc=f"train_epoch {self.start_epoch}/"
                               f"{self.model_config.epochs}, data: {loader.name}")
            batches = iter(it)
            while True:
                t_wait = time.perf_counter()
                with span("loader.wait"):
                    item = next(batches, None)
                if item is None:
                    break
                lr_imgs, hr_imgs, _ = item
                t_step = time.perf_counter()
                self.train_wait_s += t_step - t_wait
                self.train_batch(self.process_lr_imgs("train", lr_imgs),
                                 self.process_hr_imgs("train", hr_imgs))
                self.train_step_s += time.perf_counter() - t_step
                yield
            if self.progress:
                it.set_postfix({"loss": f"{self.epoch_loss.avg:.6f}"})
        self.train_dataloader_process()

    def train_dataloader_process(self):
        self.loss_log.append([f"epoch:{self.start_epoch:05d}",
                              f"loss:{self.epoch_loss.avg}"])
        train_time = time.time() - self.train_start_time
        self.train_eval_seconds_consume_log.append(
            [f"epoch:{self.start_epoch:05d}",
             format_str(f"训练时长:{train_time}", 25), "None", "None"])
        self.total_seconds_consume_log[0] += train_time
        self.save_model_weights(self.new_model_path)
        # next-epoch lr (cosine stepped per epoch)
        next_lr = self.lr_schedule(self.start_epoch)
        self.lr_log.append(f"epoch:{self.start_epoch + 1},lr:{format_str(next_lr, 25)}")
        if not self.gan_mode:
            self._write_rows(self.loss_log_path, self.loss_log)
            self._write_rows(self.lr_log_path, [[row] for row in self.lr_log])
        self._write_rows(self.train_eval_seconds_consume_log_path,
                         self.train_eval_seconds_consume_log)

    # ------------------------------------------------------------------- eval

    def _infer_one(self, lr_img: np.ndarray) -> np.ndarray:
        """(1,h,w,3) -> clipped (1,H,W,3) SR via the tiled or whole-image path."""
        exact = exact_mode() if self.eval_precision == "exact" else contextlib.nullcontext()
        with torch.inference_mode(), exact:
            if self.eval_mode == "tiled":
                sr = self.tiled(self._to_device(lr_img)[0])[None]
                return np.clip(sr.float().cpu().numpy(), 0, 1)
            if self.eval_bucket:
                bkt = self.eval_bucket
                h, w = lr_img.shape[1:3]
                ph, pw = (-h) % bkt, (-w) % bkt
                if ph or pw:
                    mode = "reflect" if (ph < h and pw < w) else "symmetric"
                    padded = np.pad(lr_img, ((0, 0), (0, ph), (0, pw), (0, 0)),
                                    mode=mode)
                    sr = self._whole_forward(padded)
                    s = getattr(self.model_config, "scaling_factor", 4)
                    return sr[:, :h * s, :w * s]
            return self._whole_forward(lr_img)

    def _to_device(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)).to(self.device)

    def _whole_forward(self, lr_img: np.ndarray) -> np.ndarray:
        x = self._to_device(lr_img)
        if (self._banded_eval is not None
                and lr_img.shape[1] * lr_img.shape[2] >= self.eval_band_area):
            sr = self._banded_eval(x[0])[None].clamp(0, 1)
        else:
            sr = self._whole_eval(x)
        return sr.float().cpu().numpy()

    def _metrics_of(self, hr: np.ndarray, sr: np.ndarray, gaussian: bool):
        """(PSNR, SSIM, LPIPS or None) on the Y channel."""
        hr_y = convert_image(hr[0], source="[0,1]", target="y-channel")
        sr_y = convert_image(sr[0], source="[0,1]", target="y-channel")
        lp = self.lpips(hr_y, sr_y) if self.lpips else None
        return (psnr_fn(hr_y, sr_y, 1.0), ssim_fn(hr_y, sr_y, 1.0, gaussian_weights=gaussian),
                lp)

    def eval_batch(self, hr_img, sr_img):
        p, s, lp = self._metrics_of(hr_img, sr_img, gaussian=False)
        if np.isnan(p) or np.isnan(s) or (lp is not None and np.isnan(lp)):
            raise ValueError("experiment metric is NaN")
        self.epoch_psnr.update(p, 1)
        self.epoch_ssim.update(s, 1)
        if lp is not None:
            self.epoch_lpips.update(lp, 1)

    def eval(self, start_epoch: Optional[int] = None):
        self.epoch_psnr.reset()
        self.epoch_ssim.reset()
        self.epoch_lpips.reset()
        self.eval_start_time = time.time()
        for i, loader in enumerate(self.eval_loaders):
            it = loader
            if self.progress:
                from tqdm import tqdm
                it = tqdm(loader, total=len(loader),
                          desc=f"eval_epoch {start_epoch or self.start_epoch}/"
                               f"{self.model_config.epochs}, data: {loader.name}")
            for lr_imgs, hr_imgs, _ in it:
                lr_imgs = self.process_lr_imgs("eval", lr_imgs)
                hr_imgs = self.process_hr_imgs("eval", hr_imgs)
                self.eval_batch(hr_imgs, self.process_sr_imgs("eval", self._infer_one(lr_imgs)))
            if i == len(self.eval_loaders) - 1:
                self.__eval_dataloader_process(loader.name, start_epoch)

    def __eval_dataloader_process(self, dataloader_name: str,
                                  start_epoch: Optional[int] = None):
        start_epoch = start_epoch if start_epoch is not None else self.start_epoch
        if self.epoch_lpips.avg == 0:
            # all-lpips-failed sentinel (reference :505-506); must stay a
            # decimal string: format_str zero-pads, and "1" would become 1e17
            self.epoch_lpips.avg = 1.0

        self.psnr_ssim_lpips_log.append([
            f"epoch:{start_epoch:05d}",
            format_str(f"{self.epoch_psnr.avg}"),
            format_str(f"{self.epoch_ssim.avg}"),
            format_str(f"{self.epoch_lpips.avg}"),
        ])
        if self.epoch_psnr.avg > self.only_best_psnr:
            self.only_best_psnr = self.epoch_psnr.avg
            self.save_model_weights(self.best_psnr_model_path)
        if self.epoch_ssim.avg > self.only_best_ssim:
            self.only_best_ssim = self.epoch_ssim.avg
            self.save_model_weights(self.best_ssim_model_path)
        if self.epoch_lpips.avg < self.only_best_lpips:
            self.only_best_lpips = self.epoch_lpips.avg
            self.save_model_weights(self.best_lpips_model_path)
        # without LPIPS the metric is pinned at 1.0: it must not veto the
        # combined-best rule (reference semantics assume lpips present)
        best_lpips = float(self.best_epoch_psnr_ssim_lpips_log[3])
        lpips_improved = (self.epoch_lpips.avg < best_lpips if self.lpips
                          else self.epoch_lpips.avg <= best_lpips)
        if (self.epoch_psnr.avg > float(self.best_epoch_psnr_ssim_lpips_log[1])
                and self.epoch_ssim.avg > float(self.best_epoch_psnr_ssim_lpips_log[2])
                and lpips_improved):
            self.best_epoch_psnr_ssim_lpips_log = [
                f"{start_epoch:05d}", self.epoch_psnr.avg,
                self.epoch_ssim.avg, self.epoch_lpips.avg]
            self.save_model_weights(self.best_psnr_ssim_lpips_model_path)

        eval_time = time.time() - self.eval_start_time
        self.train_eval_seconds_consume_log[-1][2] = format_str(f"验证时长:{eval_time}", 25)
        if str(self.train_eval_seconds_consume_log[-1][3]) == "None":
            self.train_eval_seconds_consume_log[-1][3] = f"验证数据集:{dataloader_name}"
        else:
            self.train_eval_seconds_consume_log[-1][3] += f"、{dataloader_name}"
        self.total_seconds_consume_log[0] += eval_time
        self.__save_log()

    # ------------------------------------------------------------------- test

    def test_batch(self, hr_img, sr_img, filename, suffix, dataloader_name):
        p, s, lp = self._metrics_of(hr_img, sr_img, gaussian=True)
        self.test_set_psnr.update(p, 1)
        self.test_set_ssim.update(s, 1)
        if lp is not None:
            self.test_set_lpips.update(lp, 1)
        if not process_zero():
            return

        result_path = os.path.join(self.result_path, dataloader_name)
        os.makedirs(result_path, exist_ok=True)
        from PIL import Image

        for tag, img in (("hr", hr_img), ("sr", sr_img)):
            arr = (np.clip(img[0], 0, 1) * 255.0).round().astype(np.uint8)
            Image.fromarray(arr).save(
                os.path.join(result_path, f"{filename}_{tag}.{suffix}"))

    def __save_test_log(self, subfolder: str):
        rows = [[f"psnr:{self.test_set_psnr.avg}", f"ssim:{self.test_set_ssim.avg}",
                 f"lpips:{self.test_set_lpips.avg if self.test_set_lpips.count else 'n/a'}"],
                ["test_time:", time.time() - self.test_start_time, " "]]
        self._write_rows(os.path.join(self.result_path, subfolder, "test_log.txt"), rows)

    def _test(self):
        if process_zero():
            os.makedirs(self.result_path, exist_ok=True)
            for path in self.result_data_paths:
                os.makedirs(path, exist_ok=True)
        for loader in self.test_loaders:
            self.test_set_psnr.reset()
            self.test_set_ssim.reset()
            self.test_set_lpips.reset()
            self.test_start_time = time.time()
            it = loader
            if self.progress:
                from tqdm import tqdm
                it = tqdm(loader, total=len(loader),
                          desc=f"start test, current test data: {loader.name}")
            for lr_imgs, hr_imgs, (filenames, suffixes) in it:
                lr_imgs = self.process_lr_imgs("test", lr_imgs)
                hr_imgs = self.process_hr_imgs("test", hr_imgs)
                sr_imgs = self.process_sr_imgs("test", self._infer_one(lr_imgs))
                self.test_batch(hr_imgs, sr_imgs, filenames[0], suffixes[0], loader.name)
            self.__save_test_log(loader.name)

    # -------------------------------------------------------------------- run

    def run(self):
        print(f"{type(self).__name__}.run...")
        if not self.is_test:
            # repair an interrupted eval: loss log one epoch ahead of metrics
            if self.start_epoch - 2 == len(self.psnr_ssim_lpips_log) \
                    and self.start_epoch >= 2:
                self.eval_start_time = time.time()
                self.eval(start_epoch=self.start_epoch - 1)
                self.save_epoch_mode_5(self.start_epoch - 1)

            for epoch in range(self.start_epoch, self.model_config.epochs + 1):
                self.start_epoch = epoch
                self._sync_epoch_lr()
                self.preprocess_train()
                self.train()
                self.eval()
                self.save_epoch_mode_5(epoch)
            print("training complete")
        else:
            self._test()

    def save_epoch_mode_5(self, epoch: int):
        """Rolling epoch=N snapshot of weights/ and logs/ every 5 epochs
        (reference experiment.py:857-878)."""
        if epoch % 5 != 0 or not process_zero():
            return
        for folder, pattern in ((self.model_config.checkpoint_folder, "/*.pth"),
                                (self.model_config.log_folder, "/*.txt")):
            files = glob.glob(folder + pattern)
            old = os.path.join(folder, f"epoch={5 if epoch == 5 else epoch - 5}")
            os.makedirs(old, exist_ok=True)
            new = old if epoch == 5 else os.path.join(folder, f"epoch={epoch}")
            if new != old:
                os.rename(old, new)
            for f in files:
                shutil.copy(f, os.path.join(new, os.path.basename(f)))
