"""3x3 same-conv + bias, optional leaky activation and residual.

Port of ``sisr_tpu/ops/pallas/conv3x3.py::_conv3x3_pallas``: the plain
version ``conv3x3_reference`` and the CUDA kernel ``csrc/conv3x3.cu``
behind one public function, ``conv3x3``.  Activations are NHWC and the
kernel HWIO, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sisr_tpu_torch.ops.kernels import build

ACTS = {"none": 0, "leaky": 1, "leaky2": 2}


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


def _conv3x3_cuda(y, res, kernel, bias, act: str):
    b, h, w, cin = y.shape
    cout = kernel.shape[-1]
    if tuple(kernel.shape) != (3, 3, cin, cout) or tuple(bias.shape) != (cout,):
        raise ValueError(f"conv3x3: kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit Cin={cin}")
    if res is not None and tuple(res.shape) != (b, h, w, cout):
        raise ValueError(f"conv3x3: res {tuple(res.shape)} != output shape")
    build.check_cuda("conv3x3", y.device, y.dtype, y=y, res=res,
                     kernel=kernel, bias=bias)
    out = torch.empty((b, h, w, cout), dtype=y.dtype, device=y.device)
    lib = build.library("conv3x3")
    fn = lib.conv3x3_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    code = fn(build.DTYPE_CODES[y.dtype], build.ptr(y), build.ptr(res),
              build.ptr(kernel), build.ptr(bias), build.ptr(out),
              b, h, w, cin, cout, ACTS[act], build.stream(y.device))
    build.raise_on_error("conv3x3", code)
    build.launches["conv3x3"] += 1
    return out


def conv3x3(y, res, kernel, bias, act: str = "none", reference: bool = False):
    """Fused 3x3 conv; ``res`` may be None.  A CPU tensor runs the plain
    version; a CUDA tensor runs the kernel unless ``reference=True`` asks
    for the plain version as a yardstick."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if reference or y.device.type == "cpu":
        return conv3x3_reference(y, res, kernel, bias, act)
    return _conv3x3_cuda(y, res, build.as_arg(kernel, y.dtype),
                         build.as_arg(bias, y.dtype), act)
