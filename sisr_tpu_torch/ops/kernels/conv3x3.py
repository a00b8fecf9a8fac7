"""3x3 same-conv + bias, optional leaky activation and residual; the same
conv over the phase-major x2 shuffle of a packed input; and the x4 head's
conv_hr + conv_last over such an input.

Ports of ``sisr_tpu/ops/pallas/conv3x3.py``:

    conv3x3                       _conv3x3_pallas                       csrc/conv3x3.cu
    conv3x3_shuffled              _conv3x3_shuffled_pallas              csrc/conv3x3.cu (shuffled gather)
    conv3x3_shuffled_tail         _conv3x3_shuffled_tail_pallas         csrc/shuffled_tail.cu
    conv3x3_shuffled_tail_packed  _conv3x3_shuffled_tail_packed_pallas  csrc/shuffled_tail.cu

each over its plain version (``*_reference``).  Activations are NHWC and
kernels HWIO, as in the JAX package.  Each gradient is the vjp of the
plain version (JAX's ``custom_vjp``s, ``conv3x3.py:241-266, :370-390,
:767-816``), through ``autograd.KernelFunction``.  A packed input ``yp`` (B, H, W, 4C)
stands for ``pixel_shuffle_phase_major(yp, 2)`` (B, 2H, 2W, C): shuffled
pixel (y, x), channel c is ``yp[b, y>>1, x>>1, ((x&1)*2 + (y&1))*C + c]``.

The packed tail's output (B, H, W/16, 16*Cout) groups 16 output pixels of a
row into one row of channels.  On the TPU that layout fills the 128 lanes
a (..., 3) array would pad, and its kernel builds it with pair-form hr
weights and grouped conv_last weights (``_pair_hr_weights``,
``_group_last_weights``).  On the card a contiguous (B, H, W/16, 16*Cout)
tensor has exactly the bytes of the NHWC (B, H, W, Cout) output, so the
tail kernel writes straight into it and none of that has a counterpart.

In bfloat16 the plain and the shuffled conv run on ``wgmma``
(``csrc/conv3x3.cu``), and so does the tail's conv_hr
(``csrc/shuffled_tail.cu``); each reads its weights K-major:
``pack_weights`` lays the HWIO kernel out as (N, Kpad) rows in the
kernel's flat-K order (tap-major, Cin inner), zero past Cout and past K =
9 Cin (the tail's conv_hr at N = 64; its conv_last reads the HWIO weights
as they are).  The pack is made outside autograd (the
backward stays the plain vjp on the HWIO kernel) and kept on the kernel
tensor while that tensor is unchanged: serving hands the kernel the same
cached weights every call, so it packs once; a training step makes its
weights anew, so it packs them anew (two small launches, a fill and a
copy, per conv).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.ops.kernels.autograd import KernelFunction
from sisr_tpu_torch.ops.pixel_shuffle import pixel_shuffle_phase_major

ACTS = {"none": 0, "leaky": 1, "leaky2": 2}
# conv_hr's channels the tail kernel keeps on chip (csrc/shuffled_tail.cu)
_TAIL_MAX_C1 = 64
# the wgmma path's N tiles (all of Cout in one) and K step (csrc/conv3x3.cu)
WGMMA_WIDTHS = (64, 128, 184, 256)
K_STEP = 64


def wgmma_width(cin: int, cout: int, shuffled: bool = False):
    """The packed N width of the bfloat16 wgmma path for (cin, cout), or
    None where its shape rule (``csrc/conv3x3.cu::wgmma_ok``) sends the conv
    to the older kernels: Cin % 4 != 0 (the shuffled conv's 16-byte gather:
    Cin % 8 != 0), an odd Cout, or Cout > 256."""
    if cin % (8 if shuffled else 4) or cout % 2 or cout > WGMMA_WIDTHS[-1]:
        return None
    return next(n for n in WGMMA_WIDTHS if n >= cout)


def tail_wgmma(cin: int, c1: int, cout: int) -> bool:
    """Whether the bfloat16 tail runs on wgmma (``csrc/shuffled_tail.cu::
    wgmma_ok``): Cin == 64 (a pixel of its input patch is one 128-byte
    row; its packed conv_hr weights, ``pack_weights(k1, 64)``, stay in
    shared memory), C1 <= 64, Cout <= 8 (conv_last on m16n8k16)."""
    return cin == 64 and c1 <= _TAIL_MAX_C1 and cout <= 8


def pack_weights(kernel: torch.Tensor, npad: int) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> (npad, Kpad): row n holds output channel
    n's weights in flat-K order, k = (3*dy + dx)*Cin + ci (tap-major, Cin
    inner), zero past Cout and past K = 9*Cin; Kpad is K rounded up to
    ``K_STEP``."""
    cin, cout = kernel.shape[2:]
    k = 9 * cin
    out = kernel.new_zeros((npad, -(-k // K_STEP) * K_STEP))
    out[:cout, :k] = kernel.reshape(k, cout).t()
    return out


def _packed(kernel: torch.Tensor, npad: int) -> torch.Tensor:
    """``pack_weights(kernel, npad)``, kept on ``kernel`` (``build.cached``)."""
    return build.cached(kernel, "_wgmma_pack", (kernel, npad),
                        lambda: pack_weights(kernel, npad))


def _act(out: torch.Tensor, act: str) -> torch.Tensor:
    if act == "leaky":
        return F.leaky_relu(out, 0.01)
    if act == "leaky2":
        return F.leaky_relu(out, 0.2)
    if act != "none":
        raise ValueError(f"unknown act {act!r}")
    return out


def conv3x3_reference(y, res, kernel, bias, act: str = "none"):
    """Same-padded 3x3 conv + bias, then act, then ``res +`` when given.

    y (B, H, W, Cin); kernel (3, 3, Cin, Cout); bias (Cout,); res
    (B, H, W, Cout) or None."""
    dt = y.dtype
    out = F.conv2d(y.permute(0, 3, 1, 2), kernel.to(dt).permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1) + bias.to(dt)
    out = _act(out, act)
    if res is not None:
        out = res + out
    return out.contiguous()


def conv3x3_shuffled_reference(yp, kernel, bias, act: str = "none"):
    """``conv3x3_reference`` of ``pixel_shuffle_phase_major(yp, 2)``."""
    return conv3x3_reference(pixel_shuffle_phase_major(yp, 2), None, kernel,
                             bias, act)


def conv3x3_shuffled_tail_reference(yp, k1, b1, act1, k2, b2):
    """conv_last(act1(conv_hr(shuffle(yp)))): hr is stored in yp's dtype
    between the two convs, as the TPU kernel keeps it."""
    return conv3x3_reference(conv3x3_shuffled_reference(yp, k1, b1, act1),
                             None, k2, b2, "none")


def _conv3x3_cuda(y, res, kernel, bias, act: str, shuffled: bool):
    """The kernel over y (B, H, W, Cin), or over the shuffle of a packed y
    (B, H/2, W/2, 4Cin) when ``shuffled``."""
    name = "conv3x3_shuffled" if shuffled else "conv3x3"
    b, h, w, cin = y.shape
    if shuffled:
        if cin % 4:
            raise ValueError(f"{name}: packed channels {cin} are not 4*Cin")
        h, w, cin = 2 * h, 2 * w, cin // 4
    cout = kernel.shape[-1]
    if tuple(kernel.shape) != (3, 3, cin, cout) or tuple(bias.shape) != (cout,):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit Cin={cin}")
    if res is not None and tuple(res.shape) != (b, h, w, cout):
        raise ValueError(f"{name}: res {tuple(res.shape)} != output shape")
    build.check_cuda(name, y.device, y.dtype, y=y, res=res, kernel=kernel, bias=bias)
    npad = None if y.dtype != torch.bfloat16 else wgmma_width(cin, cout, shuffled)
    packed = None if npad is None else _packed(kernel, npad)
    out = torch.empty((b, h, w, cout), dtype=y.dtype, device=y.device)
    fn = build.entry("conv3x3", "conv3x3_launch", ctypes.c_int,
                     [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p])
    code = build.launch(fn, y.device,
                        build.DTYPE_CODES[y.dtype], build.ptr(y), build.ptr(res),
                        build.ptr(kernel), build.ptr(packed), build.ptr(bias), build.ptr(out),
                        b, h, w, cin, cout, npad or 0, ACTS[act], int(shuffled))
    build.raise_on_error(name, code)
    return out


CONV3X3 = KernelFunction(
    "conv3x3",
    build.launched("conv3x3")(lambda y, res, kernel, bias, act: _conv3x3_cuda(
        y, res, build.as_arg(kernel, y.dtype), build.as_arg(bias, y.dtype), act,
        shuffled=False)),
    lambda *args: conv3x3_reference(*args), card_only=True)
CONV3X3_SHUFFLED = KernelFunction(
    "conv3x3_shuffled",
    build.launched("conv3x3_shuffled")(lambda yp, kernel, bias, act: _conv3x3_cuda(
        yp, None, build.as_arg(kernel, yp.dtype), build.as_arg(bias, yp.dtype), act,
        shuffled=True)),
    lambda *args: conv3x3_shuffled_reference(*args), card_only=True)


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")


def conv3x3(y, res, kernel, bias, act: str = "none"):
    """Fused 3x3 conv; ``res`` may be None.  The kernel for a CUDA tensor,
    the plain version otherwise (``autograd.KernelFunction``)."""
    _check_act(act)
    return CONV3X3(y, res, kernel, bias, act)


def conv3x3_shuffled(yp, kernel, bias, act: str = "none"):
    """conv3x3 (no residual) over ``pixel_shuffle_phase_major(yp, 2)``
    without materializing the shuffle: yp (B, H, W, 4Cin) -> (B, 2H, 2W,
    Cout).  Device rule as ``conv3x3``."""
    _check_act(act)
    return CONV3X3_SHUFFLED(yp, kernel, bias, act)


def tail_pack_group() -> int:
    """Output pixels per row of the packed tail's output (JAX
    ``conv3x3.tail_pack_group``)."""
    return 16


def conv3x3_shuffled_tail_packed_reference(yp, k1, b1, act1, k2, b2):
    """The plain tail output (B, H, W, Cout) as (B, H, W/16, 16*Cout)."""
    out = conv3x3_shuffled_tail_reference(yp, k1, b1, act1, k2, b2)
    b, h, w, cout = out.shape
    g = tail_pack_group()
    return out.reshape(b, h, w // g, g * cout)


def _shuffled_tail_cuda(yp, k1, b1, act1, k2, b2, packed: bool = False):
    b, h2, w2, c4 = yp.shape
    cin, c1, cout = c4 // 4, k1.shape[-1], k2.shape[-1]
    if c4 % 4 or tuple(k1.shape) != (3, 3, cin, c1) or tuple(b1.shape) != (c1,) \
            or tuple(k2.shape) != (3, 3, c1, cout) or tuple(b2.shape) != (cout,):
        raise ValueError(f"conv3x3_shuffled_tail: yp {tuple(yp.shape)}, k1 "
                         f"{tuple(k1.shape)}, k2 {tuple(k2.shape)} do not fit")
    if c1 > _TAIL_MAX_C1:
        raise ValueError(f"conv3x3_shuffled_tail: conv_hr width {c1} > {_TAIL_MAX_C1}")
    name = "conv3x3_shuffled_tail_packed" if packed else "conv3x3_shuffled_tail"
    g = tail_pack_group()
    build.check_cuda(name, yp.device, yp.dtype, yp=yp, k1=k1, b1=b1, k2=k2, b2=b2)
    # the packed layout is the NHWC output's bytes: the kernel writes it as is
    shape = (b, 2 * h2, 2 * w2 // g, g * cout) if packed else (b, 2 * h2, 2 * w2, cout)
    out = torch.empty(shape, dtype=yp.dtype, device=yp.device)
    w1p = (_packed(k1, _TAIL_MAX_C1)
           if yp.dtype == torch.bfloat16 and tail_wgmma(cin, c1, cout) else None)
    fn = build.entry("shuffled_tail", "shuffled_tail_launch", ctypes.c_int,
                     [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    code = build.launch(fn, yp.device,
                        build.DTYPE_CODES[yp.dtype], build.ptr(yp), build.ptr(k1),
                        build.ptr(w1p), build.ptr(b1), build.ptr(k2), build.ptr(b2),
                        build.ptr(out), b, 2 * h2, 2 * w2, cin, c1, cout, ACTS[act1])
    build.raise_on_error(name, code)
    return out


def _shuffled_tail_kernel(name: str, packed: bool, plain):
    @build.launched(name)
    def kernel(yp, k1, b1, act1, k2, b2):
        cast = lambda t: build.as_arg(t, yp.dtype)
        return _shuffled_tail_cuda(yp, cast(k1), cast(b1), act1, cast(k2), cast(b2), packed)
    return KernelFunction(name, kernel, plain, card_only=True)


SHUFFLED_TAIL = _shuffled_tail_kernel(
    "conv3x3_shuffled_tail", False, lambda *args: conv3x3_shuffled_tail_reference(*args))
SHUFFLED_TAIL_PACKED = _shuffled_tail_kernel(
    "conv3x3_shuffled_tail_packed", True,
    lambda *args: conv3x3_shuffled_tail_packed_reference(*args))


def conv3x3_shuffled_tail(yp, k1, b1, act1, k2, b2):
    """conv3x3(act1(conv3x3(pixel_shuffle_phase_major(yp, 2), k1, b1)), k2,
    b2): the x4 head's conv_hr + conv_last in one kernel that keeps hr on
    chip.  yp (B, H, W, 4Cin) -> (B, 2H, 2W, Cout).  Device rule as
    ``conv3x3``."""
    _check_act(act1)
    return SHUFFLED_TAIL(yp, k1, b1, act1, k2, b2)


def conv3x3_shuffled_tail_packed(yp, k1, b1, act1, k2, b2):
    """``conv3x3_shuffled_tail`` with its output packed 16 pixels to a row:
    yp (B, H, W, 4Cin) -> (B, 2H, 2W/16, 16*Cout), values equal to the
    unpacked output reshaped; 2W must be a multiple of 16.  Device rule as
    ``conv3x3``."""
    _check_act(act1)
    if (2 * yp.shape[2]) % tail_pack_group():
        raise ValueError(f"conv3x3_shuffled_tail_packed: output width {2 * yp.shape[2]} "
                         f"is not a multiple of {tail_pack_group()}")
    return SHUFFLED_TAIL_PACKED(yp, k1, b1, act1, k2, b2)
