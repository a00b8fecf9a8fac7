"""Build the CUDA sources in ``sisr_tpu_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout (the hash
is of the source, so an edited source rebuilds).  ``build_all`` starts one
``nvcc`` per source at once; ``library`` loads the result with ctypes at
first use.  Nothing here runs when the module is imported.

``launches`` counts, per kernel, the wrapper calls that launched it (one
per call, however many launches the call issues); ``launched(name)``
decorates each wrapper, counting it and tracing it as
``sisr.kernel.<name>`` on the same boundary.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

import torch

from sisr_tpu_torch.utils.profiling import span

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# the sources in csrc/, one library each
KERNELS = ("conv3x3", "htb_tail", "scc_block", "shuffled_tail", "fusion", "htb_fused",
           "dwconv", "win_attn")

# conv3x3.cu serves conv3x3 and conv3x3_shuffled, shuffled_tail.cu
# conv3x3_shuffled_tail and conv3x3_shuffled_tail_packed, fusion.cu
# fusion_pools and fused_fusion, htb_fused.cu htb_fused, dwconv.cu
# dwconv5x5 (forward, and dx in backward), win_attn.cu win_attn (HAT's
# window attention); htb_tail_stats counts the htb_tail calls that also
# emitted the next block's stats
launches: Dict[str, int] = {name: 0 for name in (
    "conv3x3", "conv3x3_shuffled", "conv3x3_shuffled_tail",
    "conv3x3_shuffled_tail_packed", "htb_tail", "htb_tail_stats", "scc_block",
    "fusion_pools", "fused_fusion", "htb_fused", "dwconv5x5", "win_attn")}
build_logs: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], Callable] = {}
_lock = threading.Lock()

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launched(name: str):
    """Decorator of kernel ``name``'s Python wrapper: the call runs inside
    a ``sisr.kernel.<name>`` span and counts one in ``launches[name]`` once
    it returns."""
    label = "kernel." + name

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(label):
                out = fn(*args, **kwargs)
            launches[name] += 1
            return out

        return call

    return wrap


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(name: str) -> Path:
    """The library path, named by a hash of the source and the shared
    headers, so any edit rebuilds."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Compile every named kernel not built yet, one ``nvcc`` each, all
    started together.  Returns the wall seconds spent; raises with the
    compiler's output if any build fails."""
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - start


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    with _lock:
        if name not in _libs:
            build_all((name,))
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def entry(lib: str, symbol: str, restype, argtypes):
    """The C function ``symbol`` of kernel ``lib``'s library, its result and
    argument types declared once."""
    key = (lib, symbol)
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(library(lib), symbol)
        fn.restype, fn.argtypes = restype, argtypes
        _entries[key] = fn
    return fn


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)``: the C entry point ``fn`` on ``device``'s
    current stream, with ``device`` made the current device for the call.
    A launch and ``cudaFuncSetAttribute`` apply to the current device,
    which is not the tensors' when a rank's tensors lie on ``cuda:1`` while
    ``cuda:0`` is current."""
    with torch.cuda.device(device):
        return fn(*args, stream(device))


def as_arg(t, dtype: torch.dtype):
    """``t`` as a contiguous ``dtype`` tensor; no op is issued when it is one
    already (the model hands the kernels their cached weights as they are)."""
    if t is None or (t.dtype == dtype and t.is_contiguous()):
        return t
    return t.to(dtype).contiguous()


def cached(owner: torch.Tensor, name: str, deps, make):
    """``make()`` outside autograd, kept on ``owner`` under ``name`` while the
    tensors ``deps`` keep their identities and version counters and its
    other ``deps`` (a packed width) their values: the packed weights a
    kernel reads, made once per weight tensor.  An inference tensor has no
    version counter: made anew every call."""
    key = None
    if not any(isinstance(t, torch.Tensor) and t.is_inference() for t in deps):
        key = tuple((id(t), t._version) if isinstance(t, torch.Tensor) else t for t in deps)
    hit = getattr(owner, name, None)
    if key is not None and hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad(), span("derive." + name.lstrip("_")):
        value = make()
    if key is not None:
        setattr(owner, name, (key, value))
    return value


def check_cuda(name: str, device: torch.device, dtype: torch.dtype,
               **tensors) -> None:
    """Raise unless every tensor lies on ``device`` as contiguous ``dtype``."""
    if device.type != "cuda":
        raise RuntimeError(f"{name}: the kernel takes CUDA tensors, "
                           f"got a tensor on {device}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device or t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                            f"expected {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def raise_on_error(name: str, code: int) -> None:
    """The C entry points return ``cudaGetLastError()`` (or -1 for a
    shape they refuse)."""
    if code == -1:
        raise ValueError(f"{name}: the kernel refused these shapes")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")
