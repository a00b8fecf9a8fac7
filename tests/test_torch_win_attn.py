"""The window-attention kernel (``csrc/win_attn.cu``) against its plain
version, and HAT on it, on a card.

- At HAT's published widths (C = 180, 6 heads of 30, window 16): the
  unshifted and the shifted window (shift 8, the mask) and the overlapping
  cross-attention (key window 24, zero keys past the map), on a 1088 x 1920
  map (a 1080p frame padded) and on a 192 x 192 tile, in bfloat16 and in
  float32; the overlapping call's edge windows (within 16 pixels of the
  border) and interior ones are held apart.
- The backward through ``KernelFunction`` (the plain version recomputed from
  the saved qkv and bias), eager at its first sighting, then captured and
  replayed as a CUDA graph, against autograd of the plain version.
- HAT x4 in bfloat16 on a 64 x 64 image: 42 launches a forward (36 HABs
  and 6 OCABs), and the output near the plain path's.
- At DAT's widths (C = 180, two branches of 3 heads of 30 in 8 x 32 and
  32 x 8 windows, the map zero-padded to multiples of 32 in the kernel's
  index arithmetic): unshifted and shifted by (4, 16), on a 1080 x 1920
  frame (the bottom row of windows holds 8 padded rows) and a 72 x 80 map,
  in bfloat16 and float32, the padded windows held apart; and the
  backward at a training step's shape.

Every test here needs a CUDA card and skips without one; the file imports
no JAX:

    python -m pytest --noconftest tests/test_torch_win_attn.py -m cuda -q
"""

from collections import OrderedDict

import pytest
import torch

from sisr_tpu_torch.ops.kernels import autograd as ag
from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.win_attn import win_attn

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

C, HEADS, WS = 180, 6, 16
CASES = [(0, 16), (8, 16), (0, 24)]
IDS = ["unshifted", "shifted", "overlapping"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, h, w, wk, seed=0, b=1):
    """qkv at the scale a LayerNorm'd map gives HAT's qkv Linear (logits of
    a few units), a bias table's dense bias at its init scale and above."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, h, w, 3 * C), generator=g, device=dev)
    bias = 0.5 * torch.randn((HEADS, WS * WS, wk * wk), generator=g, device=dev)
    return qkv, bias


def _errs(got, want, scale):
    return float((got.float() - want.float()).abs().max()) / scale


@pytest.mark.parametrize("size", [(1088, 1920), (192, 192)], ids=["frame", "tile"])
@pytest.mark.parametrize("shift,wk", CASES, ids=IDS)
def test_kernel_matches_plain_version(cuda_device, size, shift, wk):
    """float32: within 2e-5 of the output's scale (FMA sums of 30 in
    another order, exp2 against exp).  bfloat16: the kernel's distance
    from the float32 plain version on the same (upcast) inputs at most
    twice the plain bfloat16 version's, or 4 bf16 ulps of the scale; on
    the overlapping call, separately on the edge windows and inside."""
    from sisr_tpu_torch.utils.precision import exact_mode

    h, w = size
    qkv, bias = _inputs(cuda_device, h, w, wk)
    with exact_mode():
        got = win_attn(qkv, bias, HEADS, WS, shift, wk)
        with ag.plain_versions():
            want = win_attn(qkv, bias, HEADS, WS, shift, wk)
        scale = max(1.0, float(want.abs().max()))
        assert _errs(got, want, scale) <= 2e-5
        q16 = qkv.bfloat16()
        got16 = win_attn(q16, bias, HEADS, WS, shift, wk)
        with ag.plain_versions():
            plain16 = win_attn(q16, bias, HEADS, WS, shift, wk)
            truth = win_attn(q16.float(), bias, HEADS, WS, shift, wk)
    assert got16.dtype == torch.bfloat16 and bool(torch.isfinite(got16.float()).all())
    edge = torch.zeros((h, w), dtype=torch.bool, device=cuda_device)
    edge[:WS], edge[-WS:], edge[:, :WS], edge[:, -WS:] = True, True, True, True
    for part in ((edge, ~edge) if wk > WS else (edge | ~edge,)):
        ek = _errs(got16[0][part], truth[0][part], 1.0)
        ep = _errs(plain16[0][part], truth[0][part], 1.0)
        assert ek <= max(2.0 * ep, 4 * 2.0 ** -8 * scale), (ek, ep)


@pytest.mark.parametrize("shift,wk", CASES, ids=IDS)
def test_backward_eager_and_replayed(cuda_device, monkeypatch, shift, wk):
    """Gradients of qkv and bias at a training step's shape (batch 2,
    64 x 64, float32): the first call's eager recompute, the second's
    capture and the third's replay all give autograd's gradients of the
    plain version, within 1e-6 of their scale."""
    from sisr_tpu_torch.utils.precision import exact_mode

    monkeypatch.setattr(ag, "_signatures", OrderedDict())
    monkeypatch.setattr(ag, "_failed", set())
    qkv, bias = _inputs(cuda_device, 64, 64, wk, seed=3, b=2)
    dy = torch.randn((2, 64, 64, C), device=cuda_device)
    with exact_mode():
        leaves = [t.clone().requires_grad_(True) for t in (qkv, bias)]
        with ag.plain_versions():
            plain = win_attn(*leaves, HEADS, WS, shift, wk)
        want = torch.autograd.grad(plain, leaves, dy)
        for _ in range(3):
            leaves = [t.clone().requires_grad_(True) for t in (qkv, bias)]
            got = torch.autograd.grad(win_attn(*leaves, HEADS, WS, shift, wk), leaves, dy)
            for a, b in zip(got, want):
                assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max()))
    assert any(isinstance(v, ag._VjpGraph) for v in ag._signatures.values())


def test_hat_forward_launches_and_agrees(cuda_device):
    """HAT x4 in bfloat16 on a 64 x 64 image: every HAB and OCAB on the
    kernel (42 launches a forward), the output within 3e-2 of the plain
    path's (bfloat16 through 42 blocks; the flagship's whole-model bar)."""
    from sisr_tpu_torch.models.hat import HAT

    torch.manual_seed(0)
    model = HAT(dtype=torch.bfloat16).to(cuda_device).eval()
    x = torch.rand((1, 64, 64, 3), device=cuda_device)
    before = build.launches["win_attn"]
    with torch.inference_mode():
        got = model(x)
        assert build.launches["win_attn"] - before == 42
        with ag.plain_versions():
            want = model(x)
    assert got.shape == (1, 256, 256, 3)
    assert float((got.float() - want.float()).abs().max()) <= 3e-2


DAT_BIAS = (2 * 3, 256, 256)
DAT_CASES = [(0, 0), (4, 16)]


def _dat_inputs(dev, h, w, seed=0, b=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, h, w, 3 * C), generator=g, device=dev)
    bias = 0.5 * torch.randn(DAT_BIAS, generator=g, device=dev)
    return qkv, bias


@pytest.mark.parametrize("size", [(1080, 1920), (72, 80)], ids=["frame", "tile"])
@pytest.mark.parametrize("shift", DAT_CASES, ids=["unshifted", "shifted"])
def test_dat_branches_match_plain_version(cuda_device, size, shift):
    """DAT's call, both branches in one launch: float32 within 2e-5 of the
    output's scale; bfloat16 within twice the plain bfloat16 version's
    distance from the float32 truth, or 4 bf16 ulps of the scale, on the
    pixels whose windows hold padding (the last 32 rows and columns of
    the padded map) and on the others apart."""
    from sisr_tpu_torch.utils.precision import exact_mode

    h, w = size
    qkv, bias = _dat_inputs(cuda_device, h, w)
    args = (3, (8, 32), shift, 0, 2, 32)
    with exact_mode():
        got = win_attn(qkv, bias, *args)
        with ag.plain_versions():
            want = win_attn(qkv, bias, *args)
        scale = max(1.0, float(want.abs().max()))
        assert got.shape == (1, h, w, C)
        assert _errs(got, want, scale) <= 2e-5
        q16 = qkv.bfloat16()
        got16 = win_attn(q16, bias, *args)
        with ag.plain_versions():
            plain16 = win_attn(q16, bias, *args)
            truth = win_attn(q16.float(), bias, *args)
    edge = torch.zeros((h, w), dtype=torch.bool, device=cuda_device)
    edge[(h - 1) // 32 * 32:], edge[:, (w - 1) // 32 * 32:] = True, True
    for part in (edge, ~edge):
        ek = _errs(got16[0][part], truth[0][part], 1.0)
        ep = _errs(plain16[0][part], truth[0][part], 1.0)
        assert ek <= max(2.0 * ep, 4 * 2.0 ** -8 * scale), (ek, ep)


@pytest.mark.parametrize("shift", DAT_CASES, ids=["unshifted", "shifted"])
def test_dat_backward_eager_and_replayed(cuda_device, monkeypatch, shift):
    """DAT's call at a training step's shape (batch 2, 64 x 64, float32):
    eager, captured and replayed gradients of qkv and the bias all within
    1e-6 of the plain version's."""
    from sisr_tpu_torch.utils.precision import exact_mode

    monkeypatch.setattr(ag, "_signatures", OrderedDict())
    monkeypatch.setattr(ag, "_failed", set())
    qkv, bias = _dat_inputs(cuda_device, 64, 64, seed=3, b=2)
    dy = torch.randn((2, 64, 64, C), device=cuda_device)
    args = (3, (8, 32), shift, 0, 2, 32)
    with exact_mode():
        leaves = [t.clone().requires_grad_(True) for t in (qkv, bias)]
        with ag.plain_versions():
            plain = win_attn(*leaves, *args)
        want = torch.autograd.grad(plain, leaves, dy)
        for _ in range(3):
            leaves = [t.clone().requires_grad_(True) for t in (qkv, bias)]
            got = torch.autograd.grad(win_attn(*leaves, *args), leaves, dy)
            for a, b in zip(got, want):
                assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max()))
    assert any(isinstance(v, ag._VjpGraph) for v in ag._signatures.values())
