"""DAT's channel attention (``ops/kernels/chan_attn.py``): the plain version
of its whole-image sums and the attention built from them against
``F.normalize`` and ``@`` as DAT writes it, the apply against ``attn @ v``,
and the gradients through ``KernelFunction``, on the CPU; on a card
(``cuda``-marked, skipped without one) the kernel ``csrc/chan_attn.cu``
against the plain version in bfloat16 and float32, at a training tile, a
map whose pixel count no chunk divides and a 1080-row frame, the same bits
back to back, and DAT's forward on it:

    python -m pytest --noconftest tests/test_torch_chan_attn.py -m cuda -q
"""

import pytest
import torch
import torch.nn.functional as F

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.chan_attn import (CHAN_ATTN, apply_heads, chan_attention,
                                                  chan_attn, chan_attn_reference, split_stats)

torch.set_num_threads(1)
C, HEADS, D = 180, 6, 30


def _qkv(shape, seed=0, device="cpu", scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return scale * torch.randn(shape, generator=g, device=device)


def _dat_attention(qkv, heads, temperature):
    """DAT's ``Adaptive_Channel_Attention`` up to ``attn @ v``, as DAT
    writes it: (B, N, 3, heads, d) tokens, q and k transposed and
    ``F.normalize``d over the pixels."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    t = qkv.reshape(b, h * w, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = (x.transpose(-2, -1) for x in (t[0], t[1], t[2]))
    q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
    attn = ((q @ k.transpose(-2, -1)) * temperature).softmax(dim=-1)
    return attn, (attn @ v).permute(0, 3, 1, 2).reshape(b, h, w, c)


def test_plain_version_against_normalize_and_matmul():
    """The sums' Gram and norms give DAT's attention (F.normalize, q k^T,
    temperature, softmax) to 1e-6, and ``apply_heads`` (one matmul with the
    block-diagonal matrix, v read in place from qkv) gives ``attn @ v`` to
    1e-6 of its scale; a channel of zeros stays finite (F.normalize's
    1e-12 floor)."""
    qkv = _qkv((2, 12, 20, 3 * C), 1)
    qkv[0, ..., 5] = 0.0                     # q channel 5 of head 0, all zero
    temperature = 1.0 + 0.3 * _qkv((HEADS, 1, 1), 2)
    want_attn, want_o = _dat_attention(qkv, HEADS, temperature)
    stats = chan_attn_reference(qkv, HEADS)
    assert stats.shape == (2, HEADS, D * D + 2 * D) and stats.dtype == torch.float32
    attn = chan_attention(stats, temperature, D)
    assert bool(torch.isfinite(attn).all())
    torch.testing.assert_close(attn, want_attn, rtol=0, atol=1e-6)
    o = apply_heads(qkv[..., 2 * C:], attn)
    scale = float(want_o.abs().max())
    torch.testing.assert_close(o, want_o, rtol=0, atol=1e-6 * scale)


def test_kernel_function_gradients_are_the_plain_vjp():
    """``CHAN_ATTN`` with the plain version standing in for the kernel: its
    backward (the plain sums recomputed from the saved qkv) gives autograd's
    gradient of the plain version."""
    fn = CHAN_ATTN.with_kernel(chan_attn_reference)
    qkv = _qkv((2, 8, 12, 3 * C), 3).requires_grad_(True)
    dy = _qkv((2, HEADS, D * D + 2 * D), 4)
    got, = torch.autograd.grad(fn(qkv, HEADS), (qkv,), dy)
    want, = torch.autograd.grad(chan_attn_reference(qkv, HEADS), (qkv,), dy)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(2, 64, 64), (1, 37, 53), (1, 1080, 1920)],
                         ids=["train", "odd", "frame"])
def test_kernel_matches_plain_version(cuda_device, size):
    """The Gram and each norm against the float64 sums of the same inputs
    (bfloat16 inputs upcast: their products are exact in float32), each
    within 4 times the float32 plain version's distance from them or 1e-6
    of its own scale: a float32 sum of a slot's run of pixels rounds once
    a pixel, as the plain version's blocked sums do less often."""
    from sisr_tpu_torch.ops.kernels import autograd as ag
    from sisr_tpu_torch.utils.precision import exact_mode

    b, h, w = size
    qkv = _qkv((b, h, w, 3 * C), 5, cuda_device)
    with exact_mode():
        for x in (qkv, qkv.bfloat16()):
            got = split_stats(chan_attn(x, HEADS), D)
            with ag.plain_versions():
                plain = split_stats(chan_attn(x.float(), HEADS), D)
                truth = split_stats(chan_attn(x.double(), HEADS), D)
            for part, g, p, t in zip(("gram", "nq", "nk"), got, plain, truth):
                scale = float(t.abs().max())
                ek = float((g.double() - t).abs().max())
                ep = float((p.double() - t).abs().max())
                assert ek <= max(4.0 * ep, 1e-6 * scale), (x.dtype, size, part, ek, ep, scale)


@pytest.mark.cuda
def test_chan_attn_sums_are_the_same_bits_back_to_back(cuda_device):
    """The sums of a 1080p frame, ten launches back to back and one under
    a CUDA graph, all the same bits: each block's slot is summed in a fixed
    order, with no float atomics."""
    qkv = _qkv((1, 1080, 1920, 3 * C), 6, cuda_device).bfloat16()
    first = chan_attn(qkv, HEADS)
    outs = [chan_attn(qkv, HEADS) for _ in range(10)]
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chan_attn(qkv, HEADS)
        with torch.cuda.graph(graph, stream=stream):
            captured = chan_attn(qkv, HEADS)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    for o in outs + [captured]:
        assert torch.equal(o, first)


@pytest.mark.cuda
def test_dat_forward_launches_and_agrees(cuda_device):
    """DAT x4 in bfloat16 on a 72 x 80 image (padded to 96 x 96 for the
    windows): 18 win_attn and 18 chan_attn launches a forward, the output
    within 3e-2 of the plain path's (bfloat16 through 36 blocks)."""
    from sisr_tpu_torch.models.dat import DAT
    from sisr_tpu_torch.ops.kernels import autograd as ag

    torch.manual_seed(0)
    model = DAT(dtype=torch.bfloat16).to(cuda_device).eval()
    x = torch.rand((1, 72, 80, 3), device=cuda_device)
    before = dict(build.launches)
    with torch.inference_mode():
        got = model(x)
        assert build.launches["win_attn"] - before["win_attn"] == 18
        assert build.launches["chan_attn"] - before["chan_attn"] == 18
        with ag.plain_versions():
            want = model(x)
    assert got.shape == (1, 288, 320, 3)
    assert float((got.float() - want.float()).abs().max()) <= 3e-2
