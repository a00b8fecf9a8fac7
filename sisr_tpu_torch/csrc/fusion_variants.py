"""Time variants of ``csrc/fusion.cu`` on a card, in one process.

    python3 sisr_tpu_torch/csrc/fusion_variants.py '{"base": [],
        "lb3": [["__launch_bounds__\\\\(GATE_NT, 2\\\\) fusion_gate",
                 "__launch_bounds__(GATE_NT, 3) fusion_gate"]]}'

Each variant is a list of (regex, replacement) pairs applied to a copy of
the source (a pattern that matches nothing is an error).  The copies are
built at once with the flags of ``build.build_all`` into
``build/fusion_variants/``; for each the script prints the gate kernels'
registers and stack, the opcode histogram of the bf16 gate's SASS, and at a
bf16 192x192 tile and the 1080p frame (C = 180) the device ms of
``fusion_pools_launch`` and of ``fusion_maps_gate_launch`` (CUDA events, the
least of three runs) and the largest difference of its output from the
first variant's: variants that only move work must agree bit for bit.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from sisr_tpu_torch.ops.kernels import build  # noqa: E402
from sisr_tpu_torch.ops.kernels.fusion_ops import (_fusion_pools_cuda,  # noqa: E402
                                                   pack_params)

OUT = build.BUILD_DIR.parent / "fusion_variants"
SHAPES = {"tile": (192, 192, 50), "frame": (1088, 1920, 5)}


def make(name: str, subs) -> tuple:
    """Write the variant's source and start its nvcc."""
    text = (build.CSRC / "fusion.cu").read_text()
    for pattern, replacement in subs:
        new = re.sub(pattern, replacement, text)
        if new == text:
            raise ValueError(f"{name}: {pattern!r} matches nothing")
        text = new
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    cmd = [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(build.CSRC),
           "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def gate_sass(lib: Path) -> dict:
    """Opcode counts of the bf16, two-channel gate kernel's SASS."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    ops, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "fusion_gateI13__nv_bfloat16Li2E" in line
        elif inside and "*/" in line and ";" in line:
            words = line.split("*/")[1].split()
            op = words[1] if words and words[0].startswith("@") else (words or [""])[0]
            ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])


def least_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return min(runs)


def inputs(h: int, w: int, c: int = 180):
    g = torch.Generator(device="cuda").manual_seed(22)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    raws = tuple(((rn(3, 3, 2, 1) / 4, 0.01 * rn(1)), (rn(3, 3, 2, 1) / 4, 0.01 * rn(1)),
                  (rn(3, 3, 2, 1) / 4, 0.01 * rn(1)),
                  (rn(3, 3, c, c) / (9 * c) ** 0.5, 0.01 * rn(c))) for _ in range(3))
    a, b = (rn(1, h, w, c).to(torch.bfloat16) for _ in range(2))
    return a, b, pack_params(raws, c, torch.bfloat16)


def main(variants: dict) -> None:
    jobs = {name: make(name, subs) for name, subs in variants.items()}
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}")
            continue
        gate = [ln.split("Used")[1].strip() for ln in log.splitlines()
                if "registers" in ln][:4]
        print(f"{name}: gate kernels {gate}\n  bf16 gate SASS {gate_sass(lib)}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    c = 180
    for label, (h, w, n) in SHAPES.items():
        a, b, packed = inputs(h, w)
        cp3, hp3, wp3 = _fusion_pools_cuda(a, b)
        scratch = torch.empty(9 * (w * c + h * c), dtype=torch.float32, device="cuda")
        out, first = torch.empty_like(a), None
        for name, lib in libs.items():
            pools, maps_gate = lib.fusion_pools_launch, lib.fusion_maps_gate_launch
            pools.restype = maps_gate.restype = ctypes.c_int
            pools.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                              + [ctypes.c_void_p])
            maps_gate.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4
                                  + [ctypes.c_void_p])
            stream = build.stream(a.device)
            run_pools = lambda: pools(1, build.ptr(a), build.ptr(b), build.ptr(cp3),
                                      build.ptr(hp3), build.ptr(wp3), 1, h, w, c, stream)
            run_rest = lambda: maps_gate(1, build.ptr(a), build.ptr(b), build.ptr(cp3),
                                         build.ptr(hp3), build.ptr(wp3),
                                         *[build.ptr(t) for t in packed], build.ptr(scratch),
                                         build.ptr(out), 1, h, w, c, stream)
            if run_pools() or run_rest():
                print(f"{label} {name}: a launch was refused")
                continue
            torch.cuda.synchronize()
            first = out.clone() if first is None else first
            diff = float((out.float() - first.float()).abs().max())
            print(f"{label} {name}: pools {least_ms(run_pools, n):.4f} ms, maps + gate "
                  f"{least_ms(run_rest, n):.4f} ms, output vs the first variant {diff:.2e}",
                  flush=True)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]) if len(sys.argv) > 1 else {"base": []})
