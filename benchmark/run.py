"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (timed as ``setup_s`` from the
process's start) builds the cell's entry from ``BENCHMARK.json``: the
configuration, the traffic mix, the program's entry point, seeded weights
and inputs made on the device, a warm-up of the mix's own shapes.  Then
it measures for ``--seconds`` (with ``--trace 1`` under torch.profiler),
reads the metrics, frees the program, holds the sampled answers or the
checked steps to the plain reference (``benchmark/reference``, float32
with TF32 off; the program runs at PyTorch's defaults) and prints
one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks`` (each
compared number with its limit, also the last lines on standard error).

Exits 3 without a result when no CUDA device (or too few) is visible, and
4 when the process holds JAX or the JAX package once the window closed.
Build and kernel caches stay in ``build/`` inside the checkout.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(build / sub)


class Context:
    """What a metric reader sees."""

    def __init__(self, cell, entry, window, setup_s, trace):
        self.cell, self.entry, self.window = cell, entry, window
        self.setup_s, self.trace = setup_s, trace


def read_metrics(ctx, metrics) -> dict:
    from benchmark.harness.spec import load_module

    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        require_device: bool = True, cell=None) -> dict:
    """One run; returns the result line's object."""
    import torch

    from benchmark.harness import device as dev
    from benchmark.harness import loops
    from benchmark.harness.check import verdict
    from benchmark.harness.spec import Cell, load_module
    from benchmark.harness.trace import Trace, profile
    from benchmark.reference.precision import exact

    cell = cell or Cell(workload)
    if require_device:
        dev.require_cuda(cell.chips)
    torch.set_num_threads(2)
    entry = load_module("entries", cell.traffic["entry"]).Entry(cell, seed, device, trace)
    entry.setup()
    setup_s = time.monotonic() - T0
    loop = loops.serve if entry.kind == "serve" else loops.train

    prof = profile() if trace else None
    if prof is not None:
        prof.__enter__()
    window = loop(entry, seconds)
    if prof is not None:
        prof.__exit__(None, None, None)
    is_cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    tr = Trace.from_profiler(prof) if prof is not None else None
    ctx = Context(cell, entry, window, setup_s, tr)
    metrics = read_metrics(ctx, cell.per_layer if trace else cell.end_to_end)
    result = {"correct": False, "attempted": window.count, "failed": 0, "metrics": metrics,
              "device": (dev.describe(cell.chips, peak) if is_cuda
                         else {"platform": "cpu", "kind": "cpu", "count": 1,
                               "memory_peak_bytes": 0})}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = window.seconds
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    del prof, tr, ctx

    entry.release()
    t_check = time.monotonic()
    with exact():
        numbers = entry.check(cell.limits)
    print(f"benchmark: setup {setup_s:.1f} s, window {window.seconds:.1f} s, "
          f"check {time.monotonic() - t_check:.1f} s", file=sys.stderr)
    result["correct"] = verdict(numbers)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()

    from benchmark.harness.device import NoDevice, forbidden_modules

    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
