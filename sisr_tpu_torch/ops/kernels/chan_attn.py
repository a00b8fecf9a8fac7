"""The whole-image reduction of DAT's channel attention (its Adaptive
Channel Attention: softmax attention over the channels of a head, each
channel a vector over every pixel of the image).

``chan_attn(qkv, heads)`` takes the qkv Linear's output (B, H, W, 3C),
channels [q | k | v], each (head, d), and returns float32 (B, heads,
d * d + 2d): per (image, head) the Gram q^T k (d x d, row-major, the sum
over every pixel of q[p, i] k[p, j]), then the squared norms of q's
channels, then those of k's.  ``chan_attention`` turns them into DAT's
attention: softmax_j(q_i . k_j / (max(|q_i|, 1e-12) max(|k_j|, 1e-12)) *
temperature), which is ``F.normalize`` of q and k over the pixels and
their product, a d x d matrix per head.

The plain version ``chan_attn_reference`` sums in float32 with
``einsum``.  ``chan_attn`` runs it for a CPU tensor and the kernel
``csrc/chan_attn.cu`` for a CUDA one: q and k read once, each block's
sums in a slot of its own, the slots added in order by a second launch (no
float atomics, so the bits repeat).  The apply, o = A v over every pixel,
is one batched ``torch.matmul`` of the v map (read in place from qkv)
with the block-diagonal (C, C) matrix of the heads' A, not a kernel: on an
H100 at a 1080p frame in bfloat16 it took 1.24 ms a call against 1.91 ms
for a matmul per head over v permuted by head, and 0.45 ms for v's and
o's bytes at 3.35 TB/s; 18 calls are ~1.4% of DAT's 1.6 s frame, so a
kernel of its own waits (PERF.md, kernel row 13).  The gradient is the
plain version's vjp (``autograd.KernelFunction``).
This replaces no TPU kernel: the JAX package has no softmax attention over
channels; see the source's note.
"""

from __future__ import annotations

import ctypes

import torch

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.autograd import KernelFunction

# what csrc/chan_attn.cu takes: up to 8 heads of an even size up to 32
MAX_HEADS = 8
MAX_HEAD_DIM = 32
# pixels a chunk of the bfloat16 kernel: a slot holds at least one
CHUNK = 64
# F.normalize's floor on a norm
EPS = 1e-12


def _check(qkv, heads: int):
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % heads:
        raise ValueError(f"chan_attn: {c3} channels are not 3 x heads ({heads}) x d")
    return b, h * w, c, c // heads


def chan_attn_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version: (B, H, W, 3C) -> float32 (B, heads, d * d + 2d)
    (float64 for float64 inputs)."""
    b, n, c, d = _check(qkv, heads)
    acc = torch.promote_types(qkv.dtype, torch.float32)
    q = qkv[..., :c].reshape(b, n, heads, d).to(acc)
    k = qkv[..., c:2 * c].reshape(b, n, heads, d).to(acc)
    gram = torch.einsum("bphi,bphj->bhij", q, k)
    return torch.cat([gram.flatten(-2), q.square().sum(1), k.square().sum(1)], -1)


def split_stats(stats: torch.Tensor, d: int):
    """(gram (B, heads, d, d), nq (B, heads, d), nk (B, heads, d)) of
    ``chan_attn``'s result."""
    dd = d * d
    return stats[..., :dd].unflatten(-1, (d, d)), stats[..., dd:dd + d], stats[..., dd + d:]


def chan_attention(stats: torch.Tensor, temperature: torch.Tensor, d: int) -> torch.Tensor:
    """DAT's (B, heads, d, d) float32 attention from ``chan_attn``'s sums
    and the (heads, 1, 1) temperature."""
    gram, nq, nk = split_stats(stats, d)
    den = nq.sqrt().clamp_min(EPS)[..., :, None] * nk.sqrt().clamp_min(EPS)[..., None, :]
    return torch.softmax(gram / den * temperature, dim=-1)


def apply_heads(v: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """o[p, h d + i] = sum_j attn[h, i, j] v[p, h d + j] for v (B, H, W, C),
    any strides with channels contiguous (a slice of qkv), as one batched
    matmul with the block-diagonal matrix of the heads."""
    b, h, w, c = v.shape
    heads, d = attn.shape[1], attn.shape[-1]
    eye = torch.eye(heads, dtype=attn.dtype, device=attn.device)
    blocks = torch.einsum("bhij,hg->bhigj", attn, eye).reshape(b, c, c)
    out = torch.matmul(v.reshape(b, h * w, c), blocks.transpose(1, 2).to(v.dtype))
    return out.view(b, h, w, c)


def slots(n: int, b: int, device: torch.device) -> int:
    """Slots an image's pixels are split into: two blocks a streaming
    multiprocessor over the batch, each at least one chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // CHUNK), -(-2 * sms // b)))


def _chan_attn_cuda(qkv, heads: int):
    b, n, c, d = _check(qkv, heads)
    if heads > MAX_HEADS or d > MAX_HEAD_DIM or d % 2:
        raise ValueError(f"chan_attn: the kernel takes up to {MAX_HEADS} heads of an even "
                         f"size up to {MAX_HEAD_DIM} (got {heads} of {d})")
    build.check_cuda("chan_attn", qkv.device, qkv.dtype, qkv=qkv)
    s = slots(n, b, qkv.device)
    e = d * d + 2 * d
    part = torch.empty((b, s, heads, e), dtype=torch.float32, device=qkv.device)
    out = torch.empty((b, heads, e), dtype=torch.float32, device=qkv.device)
    fn = build.entry("chan_attn", "chan_attn_launch", ctypes.c_int,
                     [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    code = build.launch(fn, qkv.device, build.DTYPE_CODES[qkv.dtype], build.ptr(qkv),
                        build.ptr(part), build.ptr(out), b, n, c, heads, s)
    build.raise_on_error("chan_attn", code)
    return out


@build.launched("chan_attn")
def _kernel(qkv, heads: int):
    """The kernel with the plain version's signature."""
    return _chan_attn_cuda(qkv, heads)


# chan_attn(qkv, heads): the channel attention's sums (module docstring)
chan_attn = CHAN_ATTN = KernelFunction("chan_attn", _kernel, chan_attn_reference,
                                       card_only=True)
