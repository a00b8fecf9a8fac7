"""File-backed SR dataset + a host DataLoader with background prefetch
(port of ``sisr_tpu/data/dataset.py``: the same items, batches and batch
order for the same seeds).

Semantics parity with reference datasets/dataset.py:16-98:
  * items glob ``data_folder/*``
  * train: HR random crop (image_size = crop * scale), paired bicubic LR via
    a shared crop box, joint flip/rot augmentation, then the bicubic LR is
    *discarded* and the (lr, hr) pair regenerated by the BSRGAN degradation
    (the reference does the same: dataset.py:83-89)
  * eval/test: center mod-crop HR + bicubic /scale LR
  * returns (lr, hr, (filename, suffix)) with HWC float arrays

Arrays are HWC float32 numpy (the model takes NHWC); batching and
shuffling live in ``DataLoader``, which prefetches batches on worker
threads or spawned worker processes, so that the degradation overlaps the
card's work.  Workers never touch CUDA: ``data/prefetch.py`` pins batches
and copies them to the card in the main process.
"""

from __future__ import annotations

import glob
import os
import queue
import random
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from sisr_tpu_torch.configs.dataset_config import DatasetConfig
from sisr_tpu_torch.data.degradation import degradation_bsrgan
from sisr_tpu_torch.data.transforms import ImageTransforms, augment, draw_augment_params


class SRDataset:
    def __init__(self, config: DatasetConfig, data_folder: str,
                 seed: Optional[int] = None):
        self.config = config
        self.data_folder = data_folder
        # with a seed, augmentation + degradation randomness is a pure
        # function of (seed, epoch, index) — reproducible across runs and
        # loader threads; DataLoader advances ``epoch`` each iteration
        self.seed = seed
        self.epoch = 0
        self.images_path: List[str] = sorted(glob.glob(os.path.join(data_folder, "*")))

        self.hr_transform = ImageTransforms(
            split=config.split, crop_size=config.image_size,
            scaling_factor=config.scaling_factor, img_type=config.hr_img_type,
            is_lr=False, is_lr_amplify=False)
        self.lr_transform = ImageTransforms(
            split=config.split, crop_size=config.image_size,
            scaling_factor=config.scaling_factor, img_type=config.lr_img_type,
            is_lr=True, is_lr_amplify=config.is_lr_amplify)

    def __len__(self) -> int:
        return len(self.images_path)

    def _item_rngs(self, i: int):
        """Per-item (random.Random, np.random.Generator) derived from
        (seed, epoch, index); (None, None) when unseeded (module defaults)."""
        if self.seed is None:
            return None, None
        state = np.random.SeedSequence(
            [self.seed, self.epoch, i]).generate_state(2)
        return random.Random(int(state[0])), np.random.default_rng(state[1])

    def __getitem__(self, i: int):
        path = self.images_path[i]
        rng, nrng = self._item_rngs(i)
        with Image.open(path) as handle:
            img = handle.convert("RGB")

        hr, box = self.hr_transform(img, rng=rng)
        lr, _ = self.lr_transform(img, box=box)

        if self.config.split == "train" and self.config.is_augment:
            hflip, vflip, rot90 = draw_augment_params(rng=rng)
            lr = augment(lr, hflip, vflip, rot90)
            hr = augment(hr, hflip, vflip, rot90)

        base = os.path.basename(path).split(".")
        filename, suffix = base[0], base[-1]

        if self.config.split == "train":
            # blind-SR: regenerate the pair through the degradation pipeline
            lr, hr = degradation_bsrgan(
                hr, self.config.scaling_factor,
                lq_patchsize=self.config.crop_size, rng=rng, nrng=nrng)

        return lr.astype(np.float32), hr.astype(np.float32), (filename, suffix)


_POOL_DATASET: Optional["SRDataset"] = None


def _pool_init(dataset: "SRDataset"):
    global _POOL_DATASET
    _POOL_DATASET = dataset


def _pool_ping():
    """Health-check task: proves a spawn worker bootstrapped (imported this
    module and ran ``_pool_init``)."""
    return _POOL_DATASET is not None


def _pool_collate(job):
    """(epoch, idxs) -> stacked batch, in a worker process."""
    epoch, idxs = job
    ds = _POOL_DATASET
    ds.epoch = epoch
    items = [ds[i] for i in idxs]
    lr = np.stack([it[0] for it in items])
    hr = np.stack([it[1] for it in items])
    names = ([it[2][0] for it in items], [it[2][1] for it in items])
    return lr, hr, names


class DataLoader:
    """Minimal batching loader with shuffle/drop_last and background prefetch.

    Yields (lr, hr, (filename, suffix)) with lr/hr stacked NHWC float32.
    Eval/test use batch_size=1 (variable image sizes).

    ``worker_type``:
      * "thread"  — worker threads; cv2/PIL release the GIL for the codec and
        convolution heavy parts, but the numpy glue serializes (~1 core).
      * "process" — a spawn-based process pool; the BSRGAN degradation scales
        with host cores (the reference trains with num_workers=0 and is
        input-bound).  Requires a
        seeded dataset for reproducibility (worker draws are a pure function
        of (seed, epoch, index)).

    ``rank`` / ``world``: data parallelism.  Every rank draws the same
    shuffled order of global batches of ``batch_size`` and collates only
    its contiguous slice of each, ``batch_size // world`` items.  The items
    of a seeded dataset are a pure function of (seed, epoch, index), so the
    ranks' slices together are the single-device batch, bit for bit.  Only
    a seeded dataset with ``drop_last`` is sharded.
    """

    def __init__(self, dataset: SRDataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 2, prefetch: int = 4,
                 seed: Optional[int] = None, name: str = "",
                 worker_type: str = "thread",
                 result_timeout: float = 600.0,
                 bootstrap_timeout: float = 600.0,
                 rank: int = 0, world: int = 1):
        if world > 1 and (dataset.seed is None or batch_size % world or not drop_last):
            raise ValueError(f"DataLoader({name!r}): sharding over {world} ranks needs a "
                             f"seeded dataset, drop_last and a batch size divisible by "
                             f"{world}, got seed {dataset.seed}, drop_last {drop_last} and "
                             f"batch size {batch_size}")
        self.rank, self.world = rank, world
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.name = name
        self.worker_type = worker_type
        self._result_timeout = result_timeout
        self._bootstrap_timeout = bootstrap_timeout
        self._pool = None
        self._rng = random.Random(seed)
        self._epoch = 0

    def _ensure_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            import sys

            import sisr_tpu_torch

            # Spawn children REPLACE their sys.path with the parent's copy
            # (multiprocessing/spawn.py: prepare() assigns data['sys_path'];
            # PYTHONPATH is irrelevant), and the copy rewrites a cwd-relative
            # '' entry to the cwd at first-multiprocessing-import time.  When
            # the parent imported the package through '' and has since chdir'd
            # (command-line runs inside the experiment root), children die with
            # ModuleNotFoundError before _pool_init runs and the pool
            # respawn-loops forever.  Pin the absolute package root into the
            # parent's sys.path so every spawned child inherits it.
            pkg_root = os.path.dirname(
                os.path.dirname(os.path.abspath(sisr_tpu_torch.__file__)))
            if pkg_root not in sys.path:
                sys.path.insert(0, pkg_root)

            # spawn, not fork: the parent holds a CUDA context, which a
            # forked child must not inherit
            ctx = mp.get_context("spawn")
            pool = ctx.Pool(self.num_workers, initializer=_pool_init,
                            initargs=(self.dataset,))
            # fail fast (instead of hanging) if workers cannot bootstrap: a
            # bad spawn env kills children at unpickle time in seconds while
            # the pool silently respawns them forever and every job pends.
            # Detection is by ORIGINAL-worker death (a broken bootstrap exits
            # near-instantly), not by a tight deadline — healthy workers may
            # legitimately import (torch among them) for minutes on a loaded host.
            import time as _time
            first_workers = list(pool._pool)
            ping = pool.apply_async(_pool_ping)
            deadline = _time.monotonic() + self._bootstrap_timeout
            while True:
                try:
                    ok = ping.get(timeout=5)
                    break
                except mp.TimeoutError:
                    all_dead = all(p.exitcode is not None for p in first_workers)
                    if all_dead or _time.monotonic() > deadline:
                        pool.terminate()
                        why = ("every spawn worker exited during bootstrap"
                               if all_dead else
                               f"no bootstrap within {self._bootstrap_timeout:.0f}s")
                        raise RuntimeError(
                            f"DataLoader({self.name!r}): process-pool workers "
                            f"failed to start ({why}) — spawn children likely "
                            "cannot import the parent's modules; check "
                            "sys.path / picklability of the dataset") from None
            if not ok:
                raise RuntimeError("process-pool worker bootstrapped without a dataset")
            self._pool = pool
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> List[Sequence[int]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.world > 1:
            per = self.batch_size // self.world
            batches = [b[self.rank * per:(self.rank + 1) * per] for b in batches]
        return batches

    def _collate(self, idxs: Sequence[int]):
        items = [self.dataset[i] for i in idxs]
        lr = np.stack([it[0] for it in items])
        hr = np.stack([it[1] for it in items])
        names = ([it[2][0] for it in items], [it[2][1] for it in items])
        return lr, hr, names

    def _iter_process_pool(self, batches) -> Iterator:
        import collections
        import multiprocessing as mp

        pool = self._ensure_pool()
        pending = collections.deque()
        it = iter(batches)

        def submit():
            try:
                b = next(it)
            except StopIteration:
                return False
            pending.append(pool.apply_async(_pool_collate, ((self._epoch, b),)))
            return True

        for _ in range(self.num_workers + self.prefetch):
            if not submit():
                break
        while pending:
            # bounded get: a wedged/respawn-looping pool raises instead of
            # blocking the training loop forever
            try:
                item = pending.popleft().get(timeout=self._result_timeout)
            except mp.TimeoutError:
                self.close()
                raise RuntimeError(
                    f"DataLoader({self.name!r}): no batch from the process "
                    f"pool within {self._result_timeout:.0f}s — workers are "
                    "dead or wedged") from None
            submit()
            yield item

    def __iter__(self) -> Iterator:
        self._epoch += 1
        self.dataset.epoch = self._epoch  # advances per-item RNG derivation
        batches = self._batches()
        if self.worker_type == "process" and self.num_workers > 0:
            yield from self._iter_process_pool(batches)
            return
        if self.num_workers == 0:
            for b in batches:
                yield self._collate(b)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        job_q: "queue.Queue" = queue.Queue()
        for pos, b in enumerate(batches):
            job_q.put((pos, b))

        results = {}
        lock = threading.Lock()

        def worker():
            while True:
                try:
                    pos, b = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = self._collate(b)
                except Exception as exc:  # surface loader errors to consumer
                    item = exc
                with lock:
                    results[pos] = item
                out_q.put(pos)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        next_pos = 0
        pending = len(batches)
        while pending:
            out_q.get()
            while True:
                with lock:
                    item = results.pop(next_pos, None)
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
                next_pos += 1
                pending -= 1
