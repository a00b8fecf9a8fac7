"""The port's TiledSR and single-image app vs the JAX package."""

import numpy as np
import torch

import jax.numpy as jnp

from test_torch_model import CONFIGS, _jax_params, _port_model

torch.set_num_threads(1)


def _pair(seed=21):
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    jmodel, variables = _jax_params(CONFIGS["a"], None, seed=seed)
    model = _port_model(CONFIGS["a"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax(variables).items()}, strict=True)
    return jmodel, variables, model


def test_tile_positions_match_jax():
    from sisr_tpu.parallel.tiling import tile_positions as jx
    from sisr_tpu_torch.parallel.tiling import tile_positions

    for args in ((100, 32, 8), (16, 32, 8), (192, 192, 16), (481, 192, 16)):
        assert tile_positions(*args) == jx(*args)


def test_tiled_sr_matches_jax():
    """Overlapping tiles of a non-multiple image, then an image smaller
    than the tile (padded, run, cropped): same canvas as JAX."""
    from sisr_tpu.parallel.tiling import TiledSR as JaxTiledSR
    from sisr_tpu_torch.parallel.tiling import TiledSR

    jmodel, variables, model = _pair()
    rng = np.random.default_rng(22)
    for shape, chunk in (((27, 21, 3), 2), ((10, 13, 3), 1)):
        img = rng.random(shape, dtype=np.float32)
        ref = np.asarray(JaxTiledSR(lambda v, x: jmodel.apply(v, x), scale=4,
                                    tile=16, overlap=4, chunk=chunk)(
            variables, jnp.asarray(img)))
        with torch.inference_mode():
            got = TiledSR(model, scale=4, tile=16, overlap=4, chunk=chunk)(
                torch.from_numpy(img)).numpy()
        assert got.shape == ref.shape == (shape[0] * 4, shape[1] * 4, 3)
        err = np.abs(got - ref)
        assert err.max() < 1e-3 and np.sqrt(np.mean(err ** 2)) < 5e-5


def test_tiny_image_pads_symmetric():
    from sisr_tpu.parallel.tiling import TiledSR as JaxTiledSR
    from sisr_tpu_torch.parallel.tiling import TiledSR

    # nearest x4 of a pointwise map: exposes the padding
    def up_jax(v, x):
        return jnp.repeat(jnp.repeat(x * 2.0 + 0.25, 4, axis=1), 4, axis=2)

    def up(x):
        y = x * 2.0 + 0.25
        return y.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)

    img = np.random.default_rng(23).random((5, 3, 3), dtype=np.float32)
    ref = np.asarray(JaxTiledSR(up_jax, scale=4, tile=8, overlap=2)(
        {}, jnp.asarray(img)))
    got = TiledSR(up, scale=4, tile=8, overlap=2)(torch.from_numpy(img)).numpy()
    assert got.shape == (20, 12, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_infer_main_end_to_end_on_cpu(tmp_path, monkeypatch):
    """``infer.main`` on a tiny PNG through a small model with the Fusion
    gate: missing weights warn and fall back to seeded synthesis; a saved
    reference-layout .pth loads strictly."""
    from PIL import Image
    from sisr_tpu_torch import infer

    monkeypatch.setattr(infer, "create_model",
                        lambda dtype, device: _port_model(CONFIGS["c"]))
    lr = np.random.default_rng(24).integers(0, 256, (12, 10, 3), dtype=np.uint8)
    src = tmp_path / "lr.png"
    Image.fromarray(lr).save(src)
    out = infer.main(str(src), weights_path=str(tmp_path / "none.pth"),
                     tile="16", device="cpu")
    first = np.asarray(Image.open(out))
    assert first.shape == (48, 40, 3)

    model = _port_model(CONFIGS["c"])
    infer.load_model_weights(model, str(tmp_path / "none.pth"))
    ckpt = tmp_path / "w.pth"
    torch.save({"start_epoch": 3, "model": model.state_dict()}, ckpt)
    out2 = infer.main(str(src), str(tmp_path / "sr2.png"), str(ckpt),
                      tile="16", device="cpu")
    np.testing.assert_array_equal(np.asarray(Image.open(out2)), first)


def test_infer_builds_the_flagship_and_loads_a_fusion_checkpoint(tmp_path):
    """``create_model`` is the full flagship (Fusion gate on), and a
    checkpoint in the reference's layout with the golden manifest's names
    (the ``fusion.*`` tensors included) loads into it strictly."""
    from test_torch_model import _manifest
    from sisr_tpu_torch import infer
    from sisr_tpu_torch.utils.param_synth import synth_state_dict

    model = infer.create_model("float32", "cpu")
    assert sum(p.numel() for p in model.parameters()) == 10_220_014
    sd = synth_state_dict(_manifest(), seed=3)
    assert any(name.startswith("fusion.") for name in sd)
    ckpt = tmp_path / "best_psnr_ssim_lpips_model.pth"
    torch.save({"start_epoch": 7, "model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               ckpt)
    infer.load_model_weights(model, str(ckpt))
    got = model.state_dict()
    for name in ("fusion.union_attention2.conv_last.weight", "conv_hr.bias"):
        np.testing.assert_array_equal(got[name].numpy(), sd[name])
