"""The port's data pipeline (transforms, BSRGAN degradation, dataset, loader,
device prefetch) against the JAX package's on the same seeded inputs, on
the CPU.

Both packages run the degradation through cv2 with the same draws in the
same order, so every seeded item must be bit-identical (tolerance 0), and
the loaders must give the same batches in the same order for the same
seeds, with thread and spawned-process workers.
"""

import random

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i, size in enumerate([(300, 280), (320, 300), (290, 310), (280, 260)]):
        arr = (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img{i}.png")
    return str(d)


def _same(a, b):
    """Equal items: arrays bit for bit, everything else by ==."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _hr(seed, shape=(280, 300, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("source,target", [("[0,1]", "[-1,1]"), ("[-1,1]", "[0,1]"),
                                           ("[0,1]", "[0,255]"), ("[0,1]", "y-channel"),
                                           ("[0,1]", "[0,1]")])
def test_convert_image_matches_jax(source, target):
    from sisr_tpu.data.transforms import convert_image as conv_jax
    from sisr_tpu_torch.data.transforms import convert_image

    img = _hr(1, (8, 9, 3))
    _same(convert_image(img, source, target), conv_jax(img, source, target))


def test_convert_image_pil_matches_jax():
    from sisr_tpu.data.transforms import convert_image as conv_jax
    from sisr_tpu_torch.data.transforms import convert_image

    img = _hr(2, (8, 9, 3))
    _same(np.asarray(convert_image(img, "[0,1]", "pil")),
          np.asarray(conv_jax(img, "[0,1]", "pil")))
    pil = Image.fromarray((img * 255).astype(np.uint8))
    _same(convert_image(pil, "pil", "[0,1]"), conv_jax(pil, "pil", "[0,1]"))
    with pytest.raises(ValueError):
        convert_image(img, "[0,255]", "[0,1]")


@pytest.mark.parametrize("split,is_lr,amplify", [("train", False, False), ("train", True, False),
                                                 ("eval|test", False, False),
                                                 ("eval|test", True, False),
                                                 ("eval|test", True, True)])
def test_image_transforms_match_jax(split, is_lr, amplify):
    from sisr_tpu.data.transforms import ImageTransforms as TJax
    from sisr_tpu_torch.data.transforms import ImageTransforms

    img = Image.fromarray((_hr(3, (301, 287, 3)) * 255).astype(np.uint8))
    args = (split, 256, 4, "[0,1]", is_lr, amplify)
    got, box = ImageTransforms(*args)(img, rng=random.Random(4))
    ref, ref_box = TJax(*args)(img, rng=random.Random(4))
    assert box == ref_box
    _same(got, ref)


def test_augment_matches_jax():
    from sisr_tpu.data.transforms import augment as aug_jax
    from sisr_tpu.data.transforms import draw_augment_params as draw_jax
    from sisr_tpu_torch.data.transforms import augment, draw_augment_params

    img = _hr(5, (16, 16, 3))
    for seed in range(6):
        params = draw_augment_params(rng=random.Random(seed))
        assert params == draw_jax(rng=random.Random(seed))
        _same(augment(img, *params), aug_jax(img, *params))
    with pytest.raises(ValueError):
        augment(_hr(5, (16, 12, 3)), True, False, False)


# --------------------------------------------------------------------------
# degradation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 42])
def test_degradation_bsrgan_bit_identical_to_jax(seed):
    from sisr_tpu.data.degradation import degradation_bsrgan as deg_jax
    from sisr_tpu_torch.data.degradation import degradation_bsrgan

    hr = _hr(seed + 10)
    got = degradation_bsrgan(hr, 4, 64, rng=random.Random(seed),
                             nrng=np.random.default_rng(seed))
    ref = deg_jax(hr, 4, 64, rng=random.Random(seed), nrng=np.random.default_rng(seed))
    _same(got, ref)
    lq, hq = got
    assert lq.shape == (64, 64, 3) and hq.shape == (256, 256, 3)
    assert 0 <= lq.min() and lq.max() <= 1


@pytest.mark.parametrize("seed,sharp", [(0, False), (1, True), (7, False)])
def test_degradation_bsrgan_plus_bit_identical_to_jax(seed, sharp):
    from sisr_tpu.data.degradation import degradation_bsrgan_plus as deg_jax
    from sisr_tpu_torch.data.degradation import degradation_bsrgan_plus

    hr = _hr(seed + 20)
    kw = dict(sf=4, lq_patchsize=64, use_sharp=sharp)
    got = degradation_bsrgan_plus(hr, rng=random.Random(seed),
                                  nrng=np.random.default_rng(seed), **kw)
    ref = deg_jax(hr, rng=random.Random(seed), nrng=np.random.default_rng(seed), **kw)
    _same(got, ref)


def test_degradation_kernels_match_jax():
    import sisr_tpu.data.degradation as dj
    import sisr_tpu_torch.data.degradation as dp

    _same(dp.gaussian_kernel(15, 2.0), dj.gaussian_kernel(15, 2.0))
    _same(dp.anisotropic_gaussian_kernel(15, 0.7, 4.0, 1.0),
          dj.anisotropic_gaussian_kernel(15, 0.7, 4.0, 1.0))
    _same(dp.shifted_downsample_kernel(25, 1.3, 4), dj.shifted_downsample_kernel(25, 1.3, 4))
    img = _hr(6, (40, 44, 3))
    _same(dp.add_jpeg_noise(img, random.Random(3)), dj.add_jpeg_noise(img, random.Random(3)))
    _same(dp.add_blur(img, 4, random.Random(9)), dj.add_blur(img, 4, random.Random(9)))


def test_degradation_statistics():
    """tests/test_data_pipeline.py's distribution bars on the port."""
    from sisr_tpu_torch.data.degradation import degradation_bsrgan
    from sisr_tpu_torch.ops.resize import imresize_matlab_np

    rng, nrng = random.Random(42), np.random.default_rng(42)
    base = np.clip(_hr(7), 0, 1)
    psnrs = []
    for _ in range(12):
        lq, hq = degradation_bsrgan(base, sf=4, lq_patchsize=64, rng=rng, nrng=nrng)
        clean = imresize_matlab_np(hq, 0.25)
        mse = float(np.mean((lq - np.clip(clean, 0, 1)) ** 2))
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-12)))
    psnrs = np.asarray(psnrs)
    assert 5.0 < psnrs.mean() < 40.0
    assert psnrs.std() > 0.1


def test_degradation_too_small_raises():
    from sisr_tpu_torch.data.degradation import degradation_bsrgan

    with pytest.raises(ValueError):
        degradation_bsrgan(np.zeros((64, 64, 3), np.float32), sf=4, lq_patchsize=64)


# --------------------------------------------------------------------------
# dataset and loader
# --------------------------------------------------------------------------

def _configs(split, augment):
    from sisr_tpu.configs.dataset_config import DatasetConfig as CJax
    from sisr_tpu_torch.configs.dataset_config import DatasetConfig

    kw = dict(split=split, crop_size=64, scaling_factor=4, is_augment=augment)
    return DatasetConfig(**kw), CJax(**kw)


def test_dataset_config_fields_match_jax():
    port, ref = _configs("train", True)
    assert vars(port) == vars(ref)
    from sisr_tpu_torch.configs.dataset_config import DatasetConfig
    with pytest.raises(ValueError):
        DatasetConfig(split="valid")


@pytest.mark.parametrize("epoch", [0, 1])
def test_dataset_train_items_match_jax(image_dir, epoch):
    from sisr_tpu.data.dataset import SRDataset as DJax
    from sisr_tpu_torch.data.dataset import SRDataset

    port_cfg, jax_cfg = _configs("train", True)
    port, ref = SRDataset(port_cfg, image_dir, seed=1009), DJax(jax_cfg, image_dir, seed=1009)
    port.epoch = ref.epoch = epoch
    assert len(port) == len(ref) == 4
    for i in range(len(port)):
        _same(port[i], ref[i])


def test_dataset_eval_items_match_jax(image_dir):
    from sisr_tpu.data.dataset import SRDataset as DJax
    from sisr_tpu_torch.data.dataset import SRDataset

    port_cfg, jax_cfg = _configs("eval|test", False)
    port, ref = SRDataset(port_cfg, image_dir), DJax(jax_cfg, image_dir)
    for i in range(len(port)):
        item = port[i]
        _same(item, ref[i])
        assert item[1].shape[0] == 4 * item[0].shape[0]
        assert item[2][1] == "png"


def _loaders(image_dir, worker_type, num_workers=2):
    from sisr_tpu.data.dataset import DataLoader as LJax, SRDataset as DJax
    from sisr_tpu_torch.data.dataset import DataLoader, SRDataset

    port_cfg, jax_cfg = _configs("train", True)
    kw = dict(batch_size=2, shuffle=True, drop_last=True, seed=3)
    port = DataLoader(SRDataset(port_cfg, image_dir, seed=5), num_workers=num_workers,
                      worker_type=worker_type, **kw)
    ref = LJax(DJax(jax_cfg, image_dir, seed=5), num_workers=2, worker_type="thread", **kw)
    return port, ref


@pytest.mark.parametrize("worker_type,num_workers", [("thread", 2), ("thread", 0),
                                                     ("process", 2)])
def test_dataloader_batches_match_jax(image_dir, worker_type, num_workers):
    """Two epochs of the same seeds: the same batches in the same order
    (JAX's loader with threads as the reference)."""
    port, ref = _loaders(image_dir, worker_type, num_workers)
    try:
        assert len(port) == len(ref) == 2
        for _ in range(2):
            got, want = list(port), list(ref)
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                _same(a, b)
                assert a[0].shape == (2, 64, 64, 3) and a[0].dtype == np.float32
    finally:
        port.close()


def test_dataloader_eval_order_unshuffled(image_dir):
    from sisr_tpu_torch.data.dataset import DataLoader, SRDataset

    cfg, _ = _configs("eval|test", False)
    names = [b[2][0][0] for b in DataLoader(SRDataset(cfg, image_dir), batch_size=1)]
    assert names == [f"img{i}" for i in range(4)]


def test_device_prefetch_passthrough():
    from sisr_tpu_torch.data.prefetch import device_prefetch

    items = [(np.ones((2, 4, 4, 3), np.float32) * i,
              np.ones((2, 8, 8, 3), np.float32) * i,
              ([f"n{i}"], ["png"])) for i in range(5)]
    for size in (1, 2, 8):
        out = list(device_prefetch(iter(items), size=size, device="cpu"))
        assert len(out) == 5
        for i, (lr, hr, names) in enumerate(out):
            assert isinstance(lr, torch.Tensor) and lr.device.type == "cpu"
            np.testing.assert_array_equal(lr.numpy(), items[i][0])
            np.testing.assert_array_equal(hr.numpy(), items[i][1])
            assert names == ([f"n{i}"], ["png"])


def test_device_prefetch_stays_size_ahead():
    """``size`` items are taken from the loader before the first is used,
    and one more after each."""
    from sisr_tpu_torch.data.prefetch import device_prefetch

    pulled = []

    def source():
        for i in range(4):
            pulled.append(i)
            yield (np.full((1,), i, np.float32),)

    it = device_prefetch(source(), size=2, device="cpu")
    assert float(next(it)[0]) == 0 and pulled == [0, 1]
    assert float(next(it)[0]) == 1 and pulled == [0, 1, 2]
    assert [float(x[0]) for x in it] == [2, 3]
