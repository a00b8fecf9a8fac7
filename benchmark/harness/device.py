"""The card the run measures on, and the guard that no JAX was loaded."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

# top-level module names the measured process must never hold: JAX and
# the JAX package the port was made from (compared whole, since the
# port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sisr_tpu")


class NoDevice(RuntimeError):
    pass


def require_cuda(count: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < count:
        raise NoDevice(f"the cell needs {count} CUDA devices, "
                       f"{torch.cuda.device_count()} are visible")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ''."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def describe(count: int, peak_bytes: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes), "card": power_limit()}


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})
