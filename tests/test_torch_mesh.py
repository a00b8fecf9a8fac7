"""The port's multi-device layer on gloo ranks on the CPU: the helpers of
``parallel/mesh.py``, ``TiledSR`` / ``BandedHeadSR.sharded_call`` against
the JAX package's ``sharded_call``s on the 8-device CPU mesh (test_tiling.py's
models and inputs), and the data-parallel steps against the JAX sharded
step (test_training.py's) and the port's single-process step.

The ranks run in processes that ``mesh.spawn`` starts; they import this
module by name, so it imports no JAX at module level (the tests import it
inside).  One spawn per world size serves several tests (a spawn of 3 ranks
costs ~8 s here), each with a timeout, so that a hang fails a test rather
than the suite.

Bars: the sharded outputs 1e-5 (test_tiling.py's); the DP loss 1e-5 from
JAX's sharded step; a gradient within 1e-5 x its tensor's max abs of the
single-process gradient of the same global batch (the ranks sum in another
order), which the control (the sum over ranks with no division by the
world size) must fail.
"""

import numpy as np
import pytest
import torch

from sisr_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

TIMEOUT = 300.0
# test_training.py's tiny model (MSCE, CASA, Fusion gate)
TINY = dict(is_mult_size_conv_feat_extract=True, is_channel_spatial_attn=True,
            is_fusion=True, embed_dim=20, depths=(2,), num_heads=(2,),
            base_win_size=(4, 4), mlp_ratio=2.0, upsampler="nearest+conv",
            upscale=4, hier_win_ratios=(0.5, 1))
# test_tiling.py:177-201's banded model
BANDED = dict(is_mult_size_conv_feat_extract=False, is_channel_spatial_attn=False,
              is_fusion=False, embed_dim=16, depths=(1,), num_heads=(2,),
              base_win_size=(4, 4), mlp_ratio=1.0, upsampler="nearest+conv",
              num_feat=8, upscale=4, hier_win_ratios=(1,))
# the GAN step's discriminator width and its VGG19 at 1/8 of the widths
NDF = 16


def _img(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# test_tiling.py:64-81's image (6 tiles of 32, overlap 8), and one of 4 tiles
TILE_CASES = {2: [(_img(3, (70, 53, 3)), 1)],
              3: [(_img(3, (70, 53, 3)), 4), (_img(4, (50, 53, 3)), 1)]}
DP_BATCH = (_img(2, (4, 16, 16, 3)), _img(5, (4, 64, 64, 3)))


def _fake_up(x):
    """test_tiling.py:70's pointwise model: nearest x4 of x * 1.5 + 0.125."""
    return (x * 1.5 + 0.125).repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)


def _model(cfg, sd=None):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    model = HiTSIR(**cfg)
    if sd is not None:
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                              strict=True)
    return model


def _gan_parts(g_sd, d_sd):
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN
    from sisr_tpu_torch.models.vgg import VGG19_CFG, PerceptualLoss

    d = UNetDiscriminatorSN(ndf=NDF)
    d.load_state_dict(d_sd, strict=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        perceptual = PerceptualLoss(cfg=tuple(c if c == "M" else c // 8 for c in VGG19_CFG))
    return _model(TINY, g_sd).train(), d.train(), perceptual


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


def _dp_step(mesh, sd, batch, n_steps=1):
    """``make_train_step`` (L1, Adam 1e-3) on this rank's slice of
    ``batch`` from the state dict ``sd``: the first step's loss and
    gradients, and the parameters after ``n_steps`` steps."""
    from sisr_tpu_torch.configs.model_config import get_optimizer
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    model = _model(TINY, sd).train()
    opt = get_optimizer("Adam", model.parameters(), 1e-3, {"weight_decay": 0})
    step = make_train_step(model, l1_loss, opt, mesh=mesh)
    lr, hr = (torch.from_numpy(a) for a in (batch if mesh is None else
                                            M.shard_batch(mesh, batch)))
    loss = float(step(lr, hr))
    grads = _grads(model)
    for _ in range(n_steps - 1):
        step(lr, hr)
    return loss, grads, {k: v.clone() for k, v in model.state_dict().items()}


def _gan_step(mesh, g_sd, d_sd, batch):
    """One ``make_gan_train_step`` (L1 + 1.0 perceptual + 0.1 adversarial,
    Adam 2e-4): both losses, D's gradients and D's state (u, v) after."""
    from sisr_tpu_torch.configs.model_config import get_optimizer
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_gan_train_step

    g, d, perceptual = _gan_parts(g_sd, d_sd)
    kw = {"weight_decay": 0, "betas": [0.9, 0.99]}
    step = make_gan_train_step(g, d, l1_loss, perceptual,
                               get_optimizer("Adam", g.parameters(), 2e-4, dict(kw)),
                               get_optimizer("Adam", d.parameters(), 2e-4, dict(kw)),
                               mesh=mesh)
    lr, hr = (torch.from_numpy(a) for a in (batch if mesh is None else
                                            M.shard_batch(mesh, batch)))
    g_loss, d_loss = step(lr, hr)
    return (float(g_loss), float(d_loss), _grads(d),
            {k: v.clone() for k, v in d.state_dict().items()})


def _summed_grads(mesh, params):
    """The control's gradient all-reduce: the sum over the ranks, with no
    division by the world size."""
    import torch.distributed as dist

    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=mesh.group)


# --------------------------------------------------------------- rank functions

def _rank_three(rank, tiles, img):
    """3 ranks: the helpers, and the tile-sharded calls."""
    mesh = M.make_mesh(3)
    out = {"process_zero": M.process_zero(), "size": mesh.size, "rank": mesh.rank,
           "shard": M.shard_batch(mesh, (torch.arange(12).reshape(6, 2), np.arange(6)))}
    try:
        M.make_mesh(2)
        out["wrong_size"] = None
    except ValueError as exc:
        out["wrong_size"] = str(exc)
    # replicate: every rank its own weights and optimizer state; rank 1
    # runs an inference forward first (its derived weights cached), then
    # takes rank 0's and must compute rank 0's output
    from sisr_tpu_torch.configs.model_config import get_optimizer
    from sisr_tpu_torch.train.losses import l1_loss
    from sisr_tpu_torch.train.train_state import make_train_step

    torch.manual_seed(rank)
    model = _model(TINY).train()
    opt = get_optimizer("Adam", model.parameters(), 1e-3, {"weight_decay": 0})
    lr = torch.from_numpy(_img(10 + rank, (1, 16, 16, 3)))
    make_train_step(model, l1_loss, opt)(lr, torch.from_numpy(_img(20, (1, 64, 64, 3))))
    x = torch.from_numpy(img)
    model.eval()
    with torch.no_grad():
        out["before"] = model(x)
    M.replicate(mesh, model)
    M.replicate(mesh, opt)
    with torch.no_grad():
        out["after"] = model(x)
    out["params"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["opt"] = opt.state_dict()
    out["value"] = M.replicate(mesh, {"epoch": 5} if rank == 0 else None)
    # all_reduce_grads: the mean of each dtype's gradients; no grad stays None
    ps = [torch.nn.Parameter(torch.zeros(3)),
          torch.nn.Parameter(torch.zeros(2, dtype=torch.bfloat16)),
          torch.nn.Parameter(torch.zeros(1))]
    ps[0].grad = torch.full((3,), float(rank + 1))
    ps[1].grad = torch.full((2,), float(2 * rank), dtype=torch.bfloat16)
    M.all_reduce_grads(mesh, ps)
    out["grads"] = [None if p.grad is None else p.grad.clone() for p in ps]
    out["mean"] = M.all_reduce_mean(mesh, torch.tensor(float(rank)))
    tile_mesh = M.make_mesh(3, axis_name="tile")
    from sisr_tpu_torch.parallel.tiling import TiledSR

    out["tiles"] = [TiledSR(_fake_up, 4, tile=32, overlap=8, chunk=c).sharded_call(
        torch.from_numpy(im), tile_mesh) for im, c in tiles]
    return out


def _rank_two(rank, tiles, sd, batch, g_sd, d_sd, gan_batch):
    """2 ranks: the tile-sharded call, the DP step (and its control, and
    3 steps' parameters), the GAN step."""
    from sisr_tpu_torch.parallel.tiling import TiledSR
    from sisr_tpu_torch.train import train_state

    mesh = M.make_mesh(2)
    out = {"tiles": [TiledSR(_fake_up, 4, tile=32, overlap=8, chunk=c).sharded_call(
        torch.from_numpy(im), M.make_mesh(2, axis_name="tile")) for im, c in tiles]}
    out["loss"], out["grads"], out["params3"] = _dp_step(mesh, sd, batch, n_steps=3)
    sound = train_state.all_reduce_grads
    train_state.all_reduce_grads = _summed_grads
    try:
        out["control_loss"], out["control_grads"], _ = _dp_step(mesh, sd, batch)
    finally:
        train_state.all_reduce_grads = sound
    out["gan"] = _gan_step(mesh, g_sd, d_sd, gan_batch)
    return out


def _rank_banded(rank, sd, img, band_rows):
    from sisr_tpu_torch.parallel.tiling import BandedHeadSR

    runner = BandedHeadSR(_model(BANDED, sd).eval(), band_rows=band_rows)
    with torch.no_grad():
        return runner.sharded_call(torch.from_numpy(img), M.make_mesh(4, axis_name="band"))


# ------------------------------------------------------------------- spawns

@pytest.fixture(scope="module")
def tiny_jax():
    """test_training.py's tiny model: JAX's init from PRNGKey(0) and the
    port's state dict of it."""
    import jax
    import jax.numpy as jnp
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax

    model = JaxHiTSIR(**TINY)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    return model, variables, state_dict_from_jax(variables["params"])


@pytest.fixture(scope="module")
def gan_state(tiny_jax):
    """A discriminator with its power iteration settled (10 train-mode
    forwards: a fresh u, v drive the logits to 1e10) and a batch."""
    from sisr_tpu_torch.models.discriminator import UNetDiscriminatorSN

    torch.manual_seed(3)
    d = UNetDiscriminatorSN(ndf=NDF).train()
    hr = _img(7, (4, 64, 64, 3))
    with torch.no_grad():
        for _ in range(10):
            d(torch.from_numpy(hr))
    return ({k: v.clone() for k, v in d.state_dict().items()},
            (_img(6, (4, 16, 16, 3)), hr))


@pytest.fixture(scope="module")
def three():
    return M.spawn(_rank_three, 3, TILE_CASES[3], _img(9, (1, 12, 10, 3)),
                   device="cpu", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def two(tiny_jax, gan_state):
    d_sd, gan_batch = gan_state
    return M.spawn(_rank_two, 2, TILE_CASES[2], tiny_jax[2], DP_BATCH, tiny_jax[2], d_sd,
                   gan_batch, device="cpu", timeout=TIMEOUT)


# ------------------------------------------------------------------ helpers

def test_process_zero_and_ranks(three):
    assert [r["process_zero"] for r in three] == [True, False, False]
    assert [(r["rank"], r["size"]) for r in three] == [(0, 3), (1, 3), (2, 3)]
    assert M.process_zero() and M.make_mesh(1, device="cpu").group is None


def test_shard_batch_slices(three):
    for r, res in enumerate(three):
        t, a = res["shard"]
        assert torch.equal(t, torch.arange(12).reshape(6, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(a, np.arange(6)[2 * r:2 * r + 2])
    with pytest.raises(ValueError):
        M.shard_batch(M.Mesh("data", 4, 0, torch.device("cpu")), torch.zeros(6))


def test_make_mesh_refuses_a_wrong_size(three):
    assert all("not n_devices=2" in r["wrong_size"] for r in three)
    with pytest.raises(RuntimeError, match="process group"):
        M.make_mesh(2, device="cpu")


def test_replicate_leaves_no_stale_cache(three):
    """After replicate every rank holds rank 0's parameters, buffers and
    Adam state bit for bit, and computes rank 0's output, though rank 1
    had cached derived weights of its own before."""
    ref = three[0]
    assert not torch.equal(three[1]["before"], ref["before"])
    for res in three[1:]:
        torch.testing.assert_close(res["after"], ref["after"], rtol=0, atol=0)
        for k, v in ref["params"].items():
            assert torch.equal(res["params"][k], v), k
        assert res["opt"]["param_groups"] == ref["opt"]["param_groups"]
        for i, st in ref["opt"]["state"].items():
            for k, v in st.items():
                assert torch.equal(res["opt"]["state"][i][k], v), (i, k)
        assert res["value"] == {"epoch": 5}
    torch.testing.assert_close(ref["after"], ref["before"], rtol=0, atol=0)


def test_all_reduce_grads_and_mean(three):
    for res in three:
        g = res["grads"]
        torch.testing.assert_close(g[0], torch.full((3,), 2.0), rtol=0, atol=0)
        torch.testing.assert_close(g[1], torch.full((2,), 2.0, dtype=torch.bfloat16),
                                   rtol=0, atol=0)
        assert g[2] is None
        assert float(res["mean"]) == 1.0


def test_kernel_launches_run_under_their_tensors_device(monkeypatch):
    """``build.launch`` makes the tensors' device current for the C call
    (a rank's tensors on cuda:1 while cuda:0 is current), and every
    wrapper launches through it."""
    import ast
    import contextlib
    from pathlib import Path
    from sisr_tpu_torch.ops.kernels import build

    entered = []

    @contextlib.contextmanager
    def device(d):
        entered.append(("in", d))
        yield
        entered.append(("out", d))

    monkeypatch.setattr(build.torch.cuda, "device", device)
    monkeypatch.setattr(build, "stream", lambda d: ("stream", d))
    dev = torch.device("cuda", 1)
    got = build.launch(lambda *a: (entered.append(("call", a)), 0)[1], dev, 7, 8)
    assert got == 0
    assert entered == [("in", dev), ("call", (7, 8, ("stream", dev))), ("out", dev)]
    kernels = Path(build.__file__).parent
    for path in sorted(kernels.glob("*.py")):
        if path.name == "build.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and node.attr == "stream":
                assert not (isinstance(node.value, ast.Name) and node.value.id == "build"), \
                    f"{path.name} takes a stream outside build.launch"


# ------------------------------------------------------------ sharded calls

def _jax_tiled(img, chunk, n_dev=8):
    import jax
    import jax.numpy as jnp
    from sisr_tpu.ops.resize import nearest_upsample
    from sisr_tpu.parallel.mesh import make_mesh
    from sisr_tpu.parallel.tiling import TiledSR as JaxTiledSR

    runner = JaxTiledSR(lambda v, x: nearest_upsample(x * 1.5 + v["b"], 4), scale=4,
                        tile=32, overlap=8, chunk=chunk)
    mesh = make_mesh(min(n_dev, jax.device_count()), axis_name="tile")
    return np.asarray(runner.sharded_call({"b": jnp.float32(0.125)}, jnp.asarray(img), mesh))


@pytest.mark.parametrize("world", [2, 3])
def test_tiled_sharded_call_matches_jax(world, two, three):
    """TiledSR.sharded_call at 2 and 3 ranks (at 3, 6 tiles in chunks of 4
    and 4 tiles: counts the ranks do not divide) against JAX's sharded_call
    on the 8-device CPU mesh and the port's own __call__."""
    from sisr_tpu_torch.parallel.tiling import TiledSR

    results = {2: two, 3: three}[world]
    for i, (img, chunk) in enumerate(TILE_CASES[world]):
        ref = _jax_tiled(img, chunk)
        whole = TiledSR(_fake_up, 4, tile=32, overlap=8, chunk=chunk)(torch.from_numpy(img))
        for res in results:
            got = res["tiles"][i].numpy()
            assert got.shape == ref.shape == (4 * img.shape[0], 4 * img.shape[1], 3)
            np.testing.assert_allclose(got, ref, atol=1e-5)
            np.testing.assert_allclose(got, whole.numpy(), atol=1e-5)


def _closure(fn, name):
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_sharded_positions_match_jax(n_dev):
    """The ranks' tile runs and band plans against the positions JAX's
    ``_build_sharded``s shard (read from their closures)."""
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu.parallel.mesh import make_mesh
    from sisr_tpu.parallel.tiling import BandedHeadSR as JaxBanded, TiledSR as JaxTiledSR
    from sisr_tpu_torch.parallel.tiling import BandedHeadSR, TiledSR

    for (h, w), tile, chunk in (((70, 53), 32, 1), ((70, 53), 32, 4), ((480, 640), 192, 1)):
        mesh = make_mesh(n_dev, axis_name="tile")
        run = JaxTiledSR(lambda v, x: x, 4, tile=tile, overlap=16 if tile == 192 else 8,
                         chunk=chunk)._build_sharded(h, w, mesh)
        pos = TiledSR(None, 4, tile=tile, overlap=16 if tile == 192 else 8,
                      chunk=chunk).sharded_positions(h, w, n_dev)
        np.testing.assert_array_equal(np.asarray(_closure(run, "pos_arr")).reshape(-1, 2), pos)
    jmodel = JaxHiTSIR(**BANDED)
    port = BandedHeadSR(_model(BANDED), band_rows=4)
    for h, band in ((24, 4), (256, 120), (1088, 120), (40, 16), (8, 120)):
        mesh = make_mesh(n_dev, axis_name="band")
        run = JaxBanded(jmodel, band_rows=band)._build_sharded(h, 16, mesh, "band")
        port.band_rows = band
        tbe, rows, pos = port.sharded_plan(h, n_dev)
        np.testing.assert_array_equal(np.asarray(_closure(run, "pos_arr")).reshape(-1, 3),
                                      np.asarray(pos))
    assert port.sharded_plan(1088, 2)[:2] == (68, 72)
    assert len(port.sharded_plan(1088, 2)[2]) == 16
    with pytest.raises(ValueError):
        port.sharded_plan(26, n_dev)


def test_banded_sharded_call_matches_jax():
    """BandedHeadSR.sharded_call with test_tiling.py:177-201's model and
    image, 6 bands over 4 ranks (2 pad slots), JAX's weights carried
    across: against JAX's sharded_call on the 8-device mesh and the port's
    own __call__ (atol 1e-5)."""
    import jax
    import jax.numpy as jnp
    from sisr_tpu.models.hit_sir_pro import HiTSIR as JaxHiTSIR
    from sisr_tpu.parallel.mesh import make_mesh
    from sisr_tpu.parallel.tiling import BandedHeadSR as JaxBanded
    from sisr_tpu_torch.models.jax_port import state_dict_from_jax
    from sisr_tpu_torch.parallel.tiling import BandedHeadSR

    img = _img(8, (24, 16, 3))
    jmodel = JaxHiTSIR(**BANDED)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img)[None])
    ref = np.asarray(JaxBanded(jmodel, band_rows=4).sharded_call(
        variables, jnp.asarray(img), make_mesh(min(8, jax.device_count()), axis_name="band")))
    sd = state_dict_from_jax(variables["params"])
    got = M.spawn(_rank_banded, 4, sd, img, 4, device="cpu", timeout=TIMEOUT)
    with torch.no_grad():
        whole = BandedHeadSR(_model(BANDED, sd).eval(), band_rows=4)(torch.from_numpy(img))
    for res in got:
        assert res.shape == ref.shape == (96, 64, 3)
        np.testing.assert_allclose(res.numpy(), ref, atol=1e-5)
        np.testing.assert_allclose(res.numpy(), whole.numpy(), atol=1e-5)


# ------------------------------------------------------------- data parallel

def test_dp_step_loss_matches_jax_sharded_step(tiny_jax, two):
    """The all-reduced loss of the 2-rank step (batch 4, 2 a rank) against
    JAX's step over a 2-device mesh (test_training.py:145-170) within
    1e-5, and equal on both ranks."""
    import jax
    from sisr_tpu.configs.model_config import get_optimizer
    from sisr_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from sisr_tpu.train.losses import l1_loss
    from sisr_tpu.train.train_state import create_train_state, make_train_step

    model, variables, _ = tiny_jax
    mesh = make_mesh(2)
    tx = get_optimizer("Adam", 1e-3, {"weight_decay": 0})
    state = replicate(mesh, create_train_state(variables["params"], tx))
    lr, hr = shard_batch(mesh, DP_BATCH)
    _, loss = make_train_step(model.apply, l1_loss, tx)(state, lr, hr, jax.random.PRNGKey(0))
    assert two[0]["loss"] == two[1]["loss"]
    assert abs(two[0]["loss"] - float(loss)) < 1e-5


def _grad_errors(got, ref):
    """{name: max abs error / max abs of the reference gradient}."""
    assert got.keys() == ref.keys()
    return {k: float((got[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
            for k in ref}


def test_dp_step_gradients_match_single_process(tiny_jax, two):
    """Each all-reduced gradient within 1e-5 x its max abs of the
    single-process step's on the whole batch of 4; the control (the sum
    over the ranks, no division) fails that bar."""
    loss, ref, _ = _dp_step(None, tiny_jax[2], DP_BATCH)
    for res in two:
        assert abs(res["loss"] - loss) < 1e-5
        errs = _grad_errors(res["grads"], ref)
        assert max(errs.values()) < 1e-5, max(errs.items(), key=lambda kv: kv[1])
        control = _grad_errors(res["control_grads"], ref)
        # every gradient that is not zero everywhere fails the bar (JAX's
        # init leaves some of this tiny model's gradients exactly zero)
        nonzero = [k for k, g in ref.items() if bool(g.abs().max() > 0)]
        assert len(nonzero) > len(ref) // 2
        assert min(control[k] for k in nonzero) > 1e-5


def test_dp_ranks_stay_bit_identical(two):
    """After 3 Adam steps both ranks hold the same parameters, bit for
    bit (the averaged gradients are the same on every rank)."""
    for k, v in two[0]["params3"].items():
        assert torch.equal(two[1]["params3"][k], v), k


def test_dp_gan_step_matches_single_process(tiny_jax, gan_state, two):
    """The GAN step on 2 ranks (batch 4): g_loss and d_loss within 1e-5
    relative of the single-process step on the whole batch; D's gradients
    the mean of what each rank's half of the batch gives in one process
    (1e-6 x their max abs; the control, their sum, fails that bar); D's
    state (spectral norm's u, v included) bit-identical across the ranks
    and within 1e-6 of the single process's.  D's gradients are not held
    to the whole batch's at 1e-5: at D's chance level (d_loss ~ ln 2) the
    real and fake halves of each bias gradient cancel to ~1e-4 of their
    size, so float32's rounding of either order shows at ~1e-4 of the
    result."""
    d_sd, batch = gan_state
    g_loss, d_loss, _, d_state = _gan_step(None, tiny_jax[2], d_sd, batch)
    halves = [_gan_step(None, tiny_jax[2], d_sd, (batch[0][i:i + 2], batch[1][i:i + 2]))[2]
              for i in (0, 2)]
    mean = {k: (halves[0][k] + halves[1][k]) / 2 for k in halves[0]}
    for res in two:
        got_g, got_d, grads, state = res["gan"]
        assert abs(got_g - g_loss) <= 1e-5 * abs(g_loss)
        assert abs(got_d - d_loss) <= 1e-5 * abs(d_loss)
        errs = _grad_errors(grads, mean)
        assert max(errs.values()) < 1e-6, max(errs.items(), key=lambda kv: kv[1])
        summed = {k: halves[0][k] + halves[1][k] for k in mean}
        assert max(_grad_errors(summed, mean).values()) > 1e-6
        for k, v in state.items():
            assert torch.equal(v, two[0]["gan"][3][k]), k
            torch.testing.assert_close(v, d_state[k], rtol=1e-6, atol=1e-6)
    assert any(k.endswith("weight_u") for k in d_state)
