"""The port's HiT-SIR-Pro vs the JAX model: weights and the whole forward.

Both packages get the same weights: JAX parameters go through
``state_dict_from_jax`` into the port's ``load_state_dict(strict=True)``.
The bar is the reference's own (test_model_parity.py): max abs < 1e-3,
rms < 5e-5 in float32.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"

# small configs: MSCE + CASA on, nearest+conv x4; "a"/"b" without the
# Fusion gate, "c"/"d" with it
CONFIGS = {
    "a": dict(is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
              is_fusion=False, embed_dim=20, depths=(3,), num_heads=(2,),
              base_win_size=(4, 4), mlp_ratio=2.0, upsampler="nearest+conv",
              upscale=4, hier_win_ratios=(0.5, 1, 2)),
    # windows 4..32 on a 40x48 input: blocks reflect-pad, so the threaded
    # stats are transformed under the padding
    "b": dict(is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
              is_fusion=False, embed_dim=24, depths=(4,), num_heads=(2,),
              base_win_size=(8, 8), mlp_ratio=2.0, upsampler="nearest+conv",
              upscale=4, hier_win_ratios=(0.5, 1, 2, 4)),
    # test_model_parity.py's tiny_full
    "c": dict(is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
              is_fusion=True, embed_dim=20, depths=(3,), num_heads=(2,),
              base_win_size=(4, 4), mlp_ratio=2.0, upsampler="nearest+conv",
              upscale=4, hier_win_ratios=(0.5, 1, 2)),
    "d": dict(is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
              is_fusion=True, embed_dim=24, depths=(2, 2), num_heads=(2, 3),
              base_win_size=(8, 8), mlp_ratio=2.0, upsampler="nearest+conv",
              upscale=4, hier_win_ratios=(0.5, 1, 2, 4)),
}
INPUTS = {"a": (1, 12, 16, 3), "b": (1, 40, 48, 3), "c": (1, 12, 10, 3),
          "d": (1, 24, 40, 3)}


def _manifest():
    blob = np.load(GOLDEN / "hit_sir_flagship.npz")
    return [(str(n), tuple(int(v) for v in s.split(",")))
            for n, s in zip(blob["manifest_names"], blob["manifest_shapes"])]


def _port_model(cfg):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    return HiTSIR(**cfg).eval()


def test_state_dict_round_trip_through_jax_layout():
    from sisr_tpu.models.torch_port import convert_hit_sir_state_dict
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax
    from sisr_tpu_torch.utils.param_synth import synth_state_dict

    sd = synth_state_dict(_manifest())
    back = state_dict_from_jax(convert_hit_sir_state_dict(sd))
    assert back.keys() == sd.keys()
    for name, value in sd.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)


def test_flagship_without_fusion_names_shapes_and_count():
    """The slice's model has exactly the reference state dict minus the
    Fusion gate, in the reference order: 10,220,014 - 875,511 params."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config

    with torch.device("meta"):
        model = HiTSIR(**flagship_config(is_fusion=False))
    got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    assert got == [(n, s) for n, s in _manifest() if not n.startswith("fusion.")]
    assert sum(p.numel() for p in model.parameters()) == 9_344_503


def test_flagship_names_shapes_and_count():
    """The full flagship (Fusion gate on) has exactly the reference state
    dict, in the reference order: 10,220,014 params."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config

    with torch.device("meta"):
        model = HiTSIR(**flagship_config())
    got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    assert got == _manifest()
    assert sum(p.numel() for p in model.parameters()) == 10_220_014


def test_unported_settings_raise():
    """The reference's heads take no other scale (JAX asserts as much);
    every shallow conv and head is ported (``test_torch_heads.py``)."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config

    with torch.device("meta"):
        for over in ({"upscale": 2}, {"upsampler": "pixelshuffle", "upscale": 3}):
            with pytest.raises(ValueError):
                HiTSIR(**flagship_config(**over))
    model = _port_model(CONFIGS["a"])
    with pytest.raises(ValueError):
        model(torch.zeros(1, 8, 8, 3), stage="body")


def _jax_params(cfg, shape, seed):
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu.models.torch_port import convert_hit_sir_state_dict
    from sisr_tpu_torch.utils.param_synth import synth_state_dict

    # well-conditioned weights from the manifest of the port's own model
    manifest = [(k, tuple(v.shape))
                for k, v in _port_model(cfg).state_dict().items()]
    variables = convert_hit_sir_state_dict(synth_state_dict(manifest, seed))
    return JaxHiTSIR(**cfg), variables


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    cfg, shape = CONFIGS[name], INPUTS[name]
    jmodel, variables = _jax_params(cfg, shape, seed=11)
    x = np.random.default_rng(12).random(shape, dtype=np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))

    model = _port_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax(variables).items()}, strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, shape[1] * 4, shape[2] * 4, 3)
    err = np.abs(got - ref)
    assert err.max() < 1e-3, f"max abs err {err.max():.3e}"
    assert np.sqrt(np.mean(err ** 2)) < 5e-5, "rms err"


def test_derived_weights_follow_load_state_dict():
    """The weights a module derives for its kernels are cached; loading new
    parameters must replace them, not serve the old ones."""
    from sisr_tpu_torch.utils.param_synth import synth_state_dict

    model = _port_model(CONFIGS["a"])
    manifest = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    x = torch.from_numpy(np.random.default_rng(13).random((1, 8, 12, 3),
                                                          dtype=np.float32))
    outs = []
    for seed in (1, 2):
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               synth_state_dict(manifest, seed).items()})
        fresh = _port_model(CONFIGS["a"])
        fresh.load_state_dict(model.state_dict())
        with torch.inference_mode():
            outs.append(model(x))
            np.testing.assert_array_equal(outs[-1].numpy(), fresh(x).numpy())
    assert not torch.equal(outs[0], outs[1])


def test_fusion_module_matches_jax():
    """The port's Fusion against the JAX module, weights carried across,
    called positionally as fusion(deep, shallow)."""
    from sisr_tpu.models.hit_sir_pro import Fusion as JaxFusion
    from sisr_tpu_torch.models.hit_sir_pro import Fusion
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    c = 12
    rng = np.random.default_rng(14)
    a, b = (rng.normal(size=(2, 16, 8, c)).astype(np.float32) for _ in range(2))
    jmod = JaxFusion(c)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(a), jnp.asarray(b))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(a), jnp.asarray(b)))
    mod = Fusion(c)
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         state_dict_from_jax(variables).items()}, strict=True)
    with torch.inference_mode():
        got = mod(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_packed_head_matches_jax():
    """The packed x4 head (folded conv_up1, shuffled conv_up2, shuffled
    conv_hr + conv_last) against the JAX head (stage='head') on the CPU."""
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax
    from sisr_tpu_torch.ops.color import IMAGENET_ISH_RGB_MEAN

    cfg = CONFIGS["c"]
    jmodel, variables = _jax_params(cfg, None, seed=15)
    y = np.random.default_rng(16).normal(size=(1, 6, 10, 64)).astype(np.float32) * 0.5
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(y), stage="head"))
    model = _port_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax(variables).items()}, strict=True)
    mean = np.asarray(IMAGENET_ISH_RGB_MEAN, np.float32)   # stage='head' adds it back
    with torch.inference_mode():
        got = model._x4_head(torch.from_numpy(y)).numpy() + mean
    assert got.shape == ref.shape == (1, 24, 40, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def _loaded_pair(name, seed, **port_kw):
    """The JAX model and its variables, and the port's model with the same
    weights loaded strictly."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    jmodel, variables = _jax_params(CONFIGS[name], None, seed=seed)
    model = HiTSIR(**CONFIGS[name], **port_kw).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_jax(variables).items()}, strict=True)
    return jmodel, variables, model


def _parity(got, ref):
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert err.max() < 1e-3, f"max abs err {err.max():.3e}"
    assert np.sqrt(np.mean(err ** 2)) < 5e-5, "rms err"


@pytest.mark.parametrize("name,packed,shape", [("c", False, INPUTS["c"]), ("c", True, (1, 12, 8, 3)),
                                               ("b", True, INPUTS["b"])])
def test_stages_match_jax(name, packed, shape):
    """stage='features' and stage='head' (plain and packed output) against
    JAX's ``apply(..., stage=...)`` and ``.clone(head_packed=True)``."""
    jmodel, variables, model = _loaded_pair(name, seed=17, head_packed=packed)
    x = np.random.default_rng(18).random(shape, dtype=np.float32)
    feat_ref = np.array(jmodel.apply(variables, jnp.asarray(x), stage="features"))
    jhead = jmodel.clone(head_packed=True) if packed else jmodel
    head_ref = np.asarray(jhead.apply(variables, jnp.asarray(feat_ref), stage="head"))
    with torch.inference_mode():
        feat = model(torch.from_numpy(x), stage="features").numpy()
        head = model(torch.from_numpy(feat_ref), stage="head").numpy()
    assert feat.shape == (*shape[:3], 64)
    _parity(feat, feat_ref)
    w4 = 4 * shape[2]
    assert head.shape == ((1, 4 * shape[1], w4 // 16, 48) if packed
                          else (1, 4 * shape[1], w4, 3))
    _parity(head, head_ref)


def test_fused_htb_model_matches_jax():
    """fused_htb=True on the CPU (the degenerate-window blocks through
    htb_fused's plain version) against the JAX forward, on a map the 4- and
    8-windows divide and one they do not."""
    from sisr_tpu_torch.models.hit_sir_pro import flagship_config

    jmodel, variables, model = _loaded_pair("d", seed=19, fused_htb=True)
    assert [b.fused_htb for layer in model.layers
            for b in layer.residual_group.blocks] == [True, True] * 2
    for shape in (INPUTS["d"], (1, 20, 28, 3)):
        x = np.random.default_rng(20).random(shape, dtype=np.float32)
        ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
        with torch.inference_mode():
            got = model(torch.from_numpy(x)).numpy()
        _parity(got, ref)
    with torch.device("meta"):
        from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

        flag = HiTSIR(**flagship_config(), fused_htb=True)
    fused = [b.fused_htb for layer in flag.layers for b in layer.residual_group.blocks]
    assert sum(fused) == 12 and fused[:6] == [True, True, False, False, False, False]


def test_stage_and_fused_settings_add_no_parameters():
    """Neither fused_htb nor head_packed adds parameters: a state dict from
    JAX loads strictly, and the flagship still counts 10,220,014."""
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR, flagship_config

    _loaded_pair("c", seed=21, fused_htb=True, head_packed=True)
    with torch.device("meta"):
        model = HiTSIR(**flagship_config(), fused_htb=True, head_packed=True)
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == _manifest()
    assert sum(p.numel() for p in model.parameters()) == 10_220_014


def test_model_layer_norm_in_slabs_equals_whole_map(monkeypatch):
    """The model-level LayerNorms go a slab of rows at a time on large maps
    (peak memory); every value equals the whole map's ``layer_norm``."""
    import sisr_tpu_torch.models.hit_sir_pro as hm
    from sisr_tpu_torch.ops.kernels.ffn import layer_norm

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 13, 7, 20)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.normal(size=20).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=20).astype(np.float32))
    monkeypatch.setattr(hm, "LN_SLAB_ELEMS", 2 * 7 * 20 * 4)      # 4 rows a slab
    got = hm._layer_norm_slabs(x, scale, bias)
    torch.testing.assert_close(got, layer_norm(x, scale, bias), atol=0, rtol=0)


def test_multi_size_conv_in_slabs_equals_whole_map(monkeypatch):
    """The multi-size conv (conv_first) goes a slab of rows at a time on
    large maps (peak memory), each slab's im2col over the zero-padded rows
    around it: the same values as the whole map."""
    import sisr_tpu_torch.models.hit_sir_pro as hm

    torch.manual_seed(0)
    block = hm.MultipleSizeConvExtract(3, 8)
    x = torch.randn(2, 13, 11, 3)
    whole = block(x, torch.float32)
    monkeypatch.setattr(hm, "LN_SLAB_ELEMS", 2 * 11 * 4 * 8 * 3)    # 3 rows a slab
    torch.testing.assert_close(block(x, torch.float32), whole, rtol=1e-5, atol=1e-6)
