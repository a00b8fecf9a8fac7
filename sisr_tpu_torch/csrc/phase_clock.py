#!/usr/bin/env python3
"""Where the time of a 64-token tile goes inside htb_fused's launch A, beside
the two kernels of the chain it replaces (htb_tail's fc1, scc_block's fused
attention), at the 1080p frame's windows 4 and 8 in bfloat16.  Needs one
NVIDIA card and nvcc; run from the root of a checkout:

    python3 sisr_tpu_torch/csrc/phase_clock.py

Copies htb_fused.cu, htb_tail.cu and scc_block.cu into build/phase_clock/
with clock64() marks at the phase boundaries listed in MARKS (thread 0 of
each block adds the cycles since its previous mark into a __device__
array; most phases end in a barrier, so its clock is the block's), builds
each copy with nvcc and swaps it in for its library, runs chip_smoke.py's
frame cases of htb_fused and of its unfused pair once after a warm-up, and
prints the cycles a tile of each phase.  The copy ``htb_fused_unrolled``
runs launch A's fc1 epilogue unrolled over the accumulators, as
htb_tail_fc1_wg runs it.  Then the SASS size of each of those kernels
(cuobjdump) and each case's time (CUDA events) on the libraries as built.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

PRELUDE = r'''
__device__ unsigned long long phase_cycles[16];
#define FWG_T0 long long fwg_t = clock64();
#define FWG_MARK(k) if (threadIdx.x == 0) { const long long fwg_now = clock64(); \
  atomicAdd(&phase_cycles[k], (unsigned long long)(fwg_now - fwg_t)); fwg_t = fwg_now; }
'''
EXPORT = r'''
extern "C" int phase_clock_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, NS::phase_cycles, sizeof(NS::phase_cycles));
}
extern "C" int phase_clock_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(NS::phase_cycles, z, sizeof(z));
}
'''
# source -> (namespace of the kernel, [(anchor, the anchor with its mark)])
MARKS = {
    "htb_fused": ("fwg", [
        ("  const int g = threadIdx.x >> 7;\n  if (t.ssum != nullptr && blockIdx.x == 0) {",
         "  const int g = threadIdx.x >> 7;\n  FWG_T0\n  if (t.ssum != nullptr && blockIdx.x == 0) {"),
        ("  wgs::attend_tile<LB>(a, D, r);\n", "  wgs::attend_tile<LB>(a, D, r);\n  FWG_MARK(0)\n"),
        ("  __syncthreads();\n  // W1's first blocks behind them",
         "  __syncthreads();\n  FWG_MARK(1)\n  // W1's first blocks behind them"),
        ("  wgs::proj_rows(a, r.Xa, wgs::saddr(r.U));\n",
         "  wgs::proj_rows(a, r.Xa, wgs::saddr(r.U));\n  FWG_MARK(2)\n"),
        ("  cp_async_wait<2>();\n  __syncthreads();\n",
         "  cp_async_wait<2>();\n  __syncthreads();\n  FWG_MARK(3)\n"),
        ("t.xbuf);\n  cp_async_wait<1>();\n  fence_proxy_async();\n  __syncthreads();\n",
         "t.xbuf);\n  cp_async_wait<1>();\n  fence_proxy_async();\n  __syncthreads();\n"
         "  FWG_MARK(4)\n"),
        ("  __syncthreads();\n  wgmma_fence();\n  wgt::fc1_product<4 * NF",
         "  __syncthreads();\n  FWG_MARK(5)\n  wgmma_fence();\n  wgt::fc1_product<4 * NF"),
        ("fence_operand(acc[i]);\n  // The epilogue", "fence_operand(acc[i]);\n  FWG_MARK(6)\n  // The epilogue"),
        ("    if (c2 >= PAIRS) c2 -= PAIRS;\n  }\n  __syncthreads();\n",
         "    if (c2 >= PAIRS) c2 -= PAIRS;\n  }\n  __syncthreads();\n  FWG_MARK(7)\n"),
        ("(hs + row * (wgt::CH * 2) + c * 8);\n  }\n}\n",
         "(hs + row * (wgt::CH * 2) + c * 8);\n  }\n  FWG_MARK(8)\n}\n"),
    ]),
    "htb_tail": ("wgt", [
        ("  const int g = threadIdx.x >> 7;\n  if (t.ssum != nullptr && t.r0 == 0",
         "  const int g = threadIdx.x >> 7;\n  FWG_T0\n  if (t.ssum != nullptr && t.r0 == 0"),
        ("  __syncthreads();\n  for (; tile < ntiles; tile += gridDim.x) {",
         "  __syncthreads();\n  FWG_MARK(0)\n  for (; tile < ntiles; tile += gridDim.x) {"),
        ("    __syncthreads();   // x is built, raw is read\n",
         "    __syncthreads();   // x is built, raw is read\n    FWG_MARK(4)\n"),
        ("fence_operand(acc[i]);\n    // h = gelu", "fence_operand(acc[i]);\n    FWG_MARK(6)\n    // h = gelu"),
        ("    fc1_gelu(acc, par + 2 * CC + CC * g);\n    __syncthreads();\n",
         "    fc1_gelu(acc, par + 2 * CC + CC * g);\n    __syncthreads();\n    FWG_MARK(7)\n"),
        ("    }\n    cp_async_wait<0>();\n    __syncthreads();   // the next tile's rows are in; x is read\n",
         "    }\n    FWG_MARK(8)\n    cp_async_wait<0>();\n"
         "    __syncthreads();   // the next tile's rows are in; x is read\n    FWG_MARK(3)\n"),
    ]),
    "scc_block": ("wgs", [
        ("  attend_tile<LB>(a, D, r);\n", "  FWG_T0\n  attend_tile<LB>(a, D, r);\n  FWG_MARK(0)\n"),
        ("  __syncthreads();\n  proj_tile(a, r.Xa, saddr(r.U), r.meta);\n}",
         "  __syncthreads();\n  FWG_MARK(1)\n  proj_tile(a, r.Xa, saddr(r.U), r.meta);\n  FWG_MARK(2)\n}"),
    ]),
}
NAMES = {
    "htb_fused": {0: "attention", 1: "projection's weights", 2: "projection", 3: "x rows",
                  4: "LN1", 5: "fc1 first K blocks", 6: "fc1 rest", 7: "gelu", 8: "h out"},
    "htb_tail": {0: "prologue", 4: "LN1", 6: "fc1", 7: "gelu", 8: "h out", 3: "next rows"},
    "scc_block": {0: "attention", 1: "projection's weights", 2: "projection + out"},
}
# launch A's fc1 epilogue as htb_tail_fc1_wg runs it: gelu unrolled over the
# accumulators, h out through Xa one warpgroup's half at a time
UNROLLED = r'''  FWG_MARK(6)
  wgt::fc1_gelu(acc, par + 2 * wgt::CC + wgt::CC * g);
  __syncthreads();
  FWG_MARK(7)
  for (int half = 0; half < 2; ++half) {
    if (g == half) {
#pragma unroll
      for (int i = 0; i < wgt::NH / 2; i += 2) {
        const int n = wgt::acc_col(i);
        if (n < wgt::CC)
          *reinterpret_cast<__nv_bfloat162*>(r.Xa + (wgt::acc_row(i) * wgt::CC + n) * 2) =
              wgt::pack_bf(acc[i], acc[i + 1]);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < wgs::TT * (wgt::CC / 4); e += wgs::NTW) {
      const int row = e / (wgt::CC / 4), c = e % (wgt::CC / 4);
      if (pix[row] >= 0)
        *reinterpret_cast<uint2*>(t.hbuf + pix[row] * wgt::CH + wgt::CC * half + c * 4) =
            *reinterpret_cast<const uint2*>(r.Xa + row * (wgt::CC * 2) + c * 8);
    }
    __syncthreads();
  }
  FWG_MARK(8)
}
'''


def instrumented(name: str, unrolled: bool = False) -> str:
    from sisr_tpu_torch.ops.kernels import build

    ns, marks = MARKS[name]
    src = (build.CSRC / f"{name}.cu").read_text()
    for anchor, marked in marks:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}.cu: the mark's anchor is not unique: {anchor[:60]!r}")
        src = src.replace(anchor, marked)
    if unrolled:
        start = src.index("  FWG_MARK(6)\n  // The epilogue")
        end = src.index("  FWG_MARK(8)\n}\n", start) + len("  FWG_MARK(8)\n}\n")
        src = src[:start] + UNROLLED + src[end:]
    src = src.replace(f"namespace {ns} {{\n", f"namespace {ns} {{\n{PRELUDE}", 1)
    return src + EXPORT.replace("NS", ns)


def sass_sizes(lib: Path, functions) -> dict:
    from sisr_tpu_torch.ops.kernels import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    sizes, cur = Counter(), None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            cur = next((f for f in functions if f in found.group(1)), None)
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            sizes[cur] += 1
    return sizes


def main() -> int:
    import torch

    import chip_smoke as smoke
    from sisr_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("phase_clock: no CUDA device", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "phase_clock"
    out_dir.mkdir(parents=True, exist_ok=True)
    copies = {"htb_fused": ("htb_fused", False), "htb_fused_unrolled": ("htb_fused", True),
              "htb_tail": ("htb_tail", False), "scc_block": ("scc_block", False)}
    jobs = {}
    for key, (name, unrolled) in copies.items():
        (out_dir / f"{key}.cu").write_text(instrumented(name, unrolled))
        jobs[key] = subprocess.Popen(
            [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(build.CSRC), "-o",
             str(out_dir / f"lib{key}.so"), str(out_dir / f"{key}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build.build_all(("htb_fused", "htb_tail", "scc_block"))
    libs = {}
    for key, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc {key}.cu failed:\n{log[-3000:]}", file=sys.stderr)
            return 1
        libs[key] = ctypes.CDLL(str(out_dir / f"lib{key}.so"))
    built = {name: build.library(name) for name in ("htb_fused", "htb_tail", "scc_block")}
    h, w = smoke.FRAME_ALIGNED
    tiles = h * w // 64
    fc1_tiles = sum(-(-(min(h, r0 + 194) - max(0, r0 - 2)) * w // 64)
                    for r0 in range(0, h, 192))     # htb_tail's 192-row bands and halos
    print(f"card: {torch.cuda.get_device_name(0)}; cycles a 64-token tile "
          f"({tiles} tiles; htb_tail's fc1 {fc1_tiles} over its bands)")

    def clocked(case, runs):
        ins = case.make(torch.bfloat16)
        case.call(ins, False)
        for key, name in runs:
            lib = libs[key]
            build._libs[name] = lib
            case.call(ins, False)
            lib.phase_clock_reset()
            case.call(ins, False)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            lib.phase_clock_read(buf)
            build._libs[name] = built[name]
            n = fc1_tiles if name == "htb_tail" else tiles
            names = NAMES[name]
            print(f"  {key:19s} {case.label}: " + ", ".join(
                f"{p} {buf[k] / n:.0f}" for k, p in names.items())
                + f" | total {sum(buf[k] for k in names) / n:.0f}", flush=True)
        times = smoke.time_ms(lambda: case.call(ins, False), min_iters=3)
        print(f"  time (CUDA events, as built) {case.label}: {times:.4f} ms", flush=True)
        del ins
        torch.cuda.empty_cache()

    for case in smoke.htb_fused_cases(h, w, ((4, False, 1), (8, True, 1)), pair=True):
        if "pair" in case.label:
            clocked(case, (("scc_block", "scc_block"), ("htb_tail", "htb_tail")))
        else:
            clocked(case, (("htb_fused", "htb_fused"), ("htb_fused_unrolled", "htb_fused")))
    for key, fns in (("htb_fused", ("htb_fused_wgILi16", "htb_fused_wgILi64")),
                     ("htb_fused_unrolled", ("htb_fused_wgILi16", "htb_fused_wgILi64")),
                     ("htb_tail", ("htb_tail_fc1_wg",)),
                     ("scc_block", ("scc_fused_wgILi16", "scc_fused_wgILi64"))):
        for fn, n in sass_sizes(out_dir / f"lib{key}.so", fns).items():
            print(f"  SASS {key:19s} {fn}: {n} instructions, {16 * n / 1024:.0f} KB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
