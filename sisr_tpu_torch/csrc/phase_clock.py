#!/usr/bin/env python3
"""Where the time of a 64-token tile goes inside htb_fused's launch A, beside
the two kernels of the chain it replaces (htb_tail's fc1, scc_block's fused
attention), at the 1080p frame's windows 4 and 8 in bfloat16, and where the
time of an 8x16 output tile goes inside htb_tail's tail launch
(htb_tail_out_wg, the body htb_tail_wg.cuh::tail_out) at a 192x192 tile and
at the 1080p frame.  Needs one NVIDIA card and nvcc; run from the root of a
checkout:

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
The tail's marks (TAIL_MARKS) sit in a copy of htb_tail_wg.cuh that the copy
``htb_tail_out`` of htb_tail.cu includes in place of the header; they sum
thread 0's cycles, so a phase that ends in a barrier is the block's.
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
        ("  const int g = threadIdx.x >> 7;\n  if (t.smax != nullptr && blockIdx.x == 0) {",
         "  const int g = threadIdx.x >> 7;\n  FWG_T0\n  if (t.smax != nullptr && blockIdx.x == 0) {"),
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
        ("  const int g = threadIdx.x >> 7;\n  if (t.smax != nullptr && t.r0 == 0",
         "  const int g = threadIdx.x >> 7;\n  FWG_T0\n  if (t.smax != nullptr && t.r0 == 0"),
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
# the tail's marks in htb_tail_wg.cuh::tail_out, with the counters' own
# array (the header comes before the .cu's namespace)
TAIL_PRELUDE = r'''
__device__ unsigned long long tail_cycles[16];
#define TAIL_T0 long long tail_t = clock64();
#define TAIL_MARK(k) if (threadIdx.x == 0) { const long long tail_now = clock64(); \
  atomicAdd(&tail_cycles[k], (unsigned long long)(tail_now - tail_t)); tail_t = tail_now; }
'''
TAIL_EXPORT = r'''
extern "C" int phase_clock_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, wgt::tail_cycles, sizeof(wgt::tail_cycles));
}
extern "C" int phase_clock_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(wgt::tail_cycles, z, sizeof(z));
}
'''
# the tail's marks: the warp-specialised tail and the 8-warp block it
# replaced (in an older checkout given by --base), with the names of their
# phases; thread 0 is consumer warpgroup 0's first thread (new) or the
# block's (old)
TAIL_MARKS = {
    "warp-specialised": ([
        ("  unsigned char* sm = align1k(smem_raw);\n  bf16* par = (bf16*)(sm + PAR_OFF);",
         "  unsigned char* sm = align1k(smem_raw);\n  TAIL_T0\n  bf16* par = (bf16*)(sm + PAR_OFF);"),
        ("  fence_proxy_async();\n  __syncthreads();\n\n  if (threadIdx.x >= 256)",
         "  fence_proxy_async();\n  __syncthreads();\n  TAIL_MARK(0)\n\n  if (threadIdx.x >= 256)"),
        ("      mbar_wait(bars + 8 * s, (it / STAGES) & 1);\n",
         "      mbar_wait(bars + 8 * s, (it / STAGES) & 1);\n      TAIL_MARK(1)\n"),
        ("      // h2 = h + gelu(conv + dwb), zero past the hidden channels\n",
         "      TAIL_MARK(2)\n      // h2 = h + gelu(conv + dwb), zero past the hidden channels\n"),
        ("      wgmma_wait<0>();            // the last chunk's product has read h2 ...\n",
         "      TAIL_MARK(3)\n      wgmma_wait<0>();            // the last chunk's product has read h2 ...\n"),
        ("        mbar_arrive(bars + 8 * (STAGES + s));\n",
         "        mbar_arrive(bars + 8 * (STAGES + s));\n      TAIL_MARK(4)\n"),
        ("      bar_sync(1 + g, 128);       // h2 is written\n",
         "      bar_sync(1 + g, 128);       // h2 is written\n      TAIL_MARK(5)\n"),
        ("      wgmma_commit();\n    }\n    wgmma_wait<0>();\n",
         "      wgmma_commit();\n      TAIL_MARK(6)\n    }\n    wgmma_wait<0>();\n    TAIL_MARK(7)\n"),
        ("    if (t.cmean == nullptr) continue;\n",
         "    TAIL_MARK(8)\n    if (t.cmean == nullptr) continue;\n"),
        ("      wsum[c] = sum;\n      wmax[c] = mx;\n    }\n",
         "      wsum[c] = sum;\n      wmax[c] = mx;\n    }\n    TAIL_MARK(9)\n"),
    ], {0: "prologue", 1: "ring wait", 2: "taps", 3: "gelu + residual", 4: "product wait",
        5: "h2 out", 6: "product issue", 7: "last product", 8: "LN2 epilogue",
        9: "statistics"}),
    "8-warp": ([
        ("  const int g = threadIdx.x >> 7;\n\n  float acc[NH / 2];",
         "  const int g = threadIdx.x >> 7;\n  TAIL_T0\n\n  float acc[NH / 2];"),
        ("  cp_async_commit();\n  for (int j = 0; j < NCH; ++j) {\n",
         "  cp_async_commit();\n  TAIL_MARK(0)\n  for (int j = 0; j < NCH; ++j) {\n"),
        ("ty0, tx0);\n    cp_async_commit();\n", "ty0, tx0);\n    cp_async_commit();\n    TAIL_MARK(0)\n"),
        ("    cp_async_wait<1>();\n    __syncthreads();     // chunk j is in for every thread\n",
         "    cp_async_wait<1>();\n    __syncthreads();     // chunk j is in for every thread\n"
         "    TAIL_MARK(1)\n"),
        ("    fence_proxy_async();\n    __syncthreads();\n    wgmma_fence();\n",
         "    TAIL_MARK(2)\n    fence_proxy_async();\n    __syncthreads();\n    TAIL_MARK(3)\n"
         "    wgmma_fence();\n"),
        ("    wgmma_wait<0>();\n    __syncthreads();     // h2 and stage j are read\n",
         "    wgmma_wait<0>();\n    TAIL_MARK(4)\n    __syncthreads();     // h2 and stage j are read\n"
         "    TAIL_MARK(5)\n"),
        ("acc_col(i)] = acc[i];\n  __syncthreads();\n",
         "acc_col(i)] = acc[i];\n  __syncthreads();\n  TAIL_MARK(6)\n"),
        ("  if (t.cmean == nullptr) return;\n", "  TAIL_MARK(7)\n  if (t.cmean == nullptr) return;\n"),
        ("    atomic_max_f(t.smax + bi * CC + c, mx);\n  }\n}\n",
         "    atomic_max_f(t.smax + bi * CC + c, mx);\n  }\n  TAIL_MARK(8)\n}\n"),
    ], {0: "issue", 1: "chunk wait", 2: "taps (thread 0)", 3: "taps barrier", 4: "product",
        5: "product barrier", 6: "y out", 7: "LN2 epilogue", 8: "statistics"}),
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


def tail_instrumented(src: str) -> tuple:
    """A htb_tail_wg.cuh with the TAIL_MARKS set whose anchors it holds,
    its counters in namespace wgt, and the names of that set's phases."""
    for marks, names in TAIL_MARKS.values():
        if all(src.count(anchor) == 1 for anchor, _ in marks):
            for anchor, marked in marks:
                src = src.replace(anchor, marked)
            return src.replace("namespace wgt {\n", "namespace wgt {\n" + TAIL_PRELUDE, 1), names
    raise RuntimeError("htb_tail_wg.cuh: no set of tail marks has unique anchors here")


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


def main(argv=None) -> int:
    import argparse

    import torch

    import chip_smoke as smoke
    from sisr_tpu_torch.ops.kernels import build, ffn

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", metavar="CHECKOUT", help="also mark the tail of this checkout's "
                   "htb_tail_wg.cuh (its htb_tail.cu's C entry as this tree's)")
    base = p.parse_args(argv).base
    if not torch.cuda.is_available():
        print("phase_clock: no CUDA device", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "phase_clock"
    out_dir.mkdir(parents=True, exist_ok=True)
    copies = {"htb_fused": ("htb_fused", False), "htb_fused_unrolled": ("htb_fused", True),
              "htb_tail": ("htb_tail", False), "scc_block": ("scc_block", False)}
    sources = {key: instrumented(name, unrolled) for key, (name, unrolled) in copies.items()}
    # the tail: htb_tail.cu as it is over the marked header, this tree's
    # and, with --base, that checkout's
    tails, include = {}, {}
    for key, csrc in (("htb_tail_out", build.CSRC),) + (
            (("htb_tail_out_base", Path(base) / "sisr_tpu_torch" / "csrc"),) if base else ()):
        include[key] = out_dir / key
        include[key].mkdir(exist_ok=True)
        header, tails[key] = tail_instrumented((csrc / "htb_tail_wg.cuh").read_text())
        (include[key] / "htb_tail_wg.cuh").write_text(header)
        for other in csrc.glob("*.cuh"):
            if other.name != "htb_tail_wg.cuh":
                (include[key] / other.name).write_text(other.read_text())
        sources[key] = (csrc / "htb_tail.cu").read_text() + TAIL_EXPORT
    jobs = {}
    for key, src in sources.items():
        (out_dir / f"{key}.cu").write_text(src)
        jobs[key] = subprocess.Popen(
            [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
            + (["-I", str(include[key])] if key in include else [])
            + ["-I", str(build.CSRC), "-o", str(out_dir / f"lib{key}.so"),
               str(out_dir / f"{key}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build.build_all(("htb_fused", "htb_tail", "scc_block"))
    libs = {}
    for key, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc {key}.cu failed:\n{log[-3000:]}", file=sys.stderr)
            return 1
        libs[key] = ctypes.CDLL(str(out_dir / f"lib{key}.so"))
        if key in tails:
            print("\n".join(f"  ptxas {line.strip()}" for line in log.splitlines()
                            if "Compiling" in line or "registers" in line), flush=True)
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

    up48 = -(-h // 48) * 48
    for case, (b, th, tw) in ((smoke.htb_cases(smoke.TILE, smoke.TILE, ((True, 1),))[0],
                               (1, smoke.TILE, smoke.TILE)),
                              (smoke.htb_cases(h, w, ((True, 0),), pad=(up48 - h, 0),
                                               scope="frame")[0], (1, h, w))):
        ins = case.make(torch.bfloat16)
        case.call(ins, False)
        n = sum(tiles for _, _, tiles, _ in ffn.tail_plan(b, th, tw, 360, 1))
        for key, names in tails.items():
            lib = libs[key]
            build._libs["htb_tail"] = lib
            case.call(ins, False)
            lib.phase_clock_reset()
            case.call(ins, False)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            lib.phase_clock_read(buf)
            build._libs["htb_tail"] = built["htb_tail"]
            print(f"  {key} {case.label}: cycles an 8x16 tile ({n} tiles): " + ", ".join(
                f"{p} {buf[k] / n:.0f}" for k, p in names.items())
                + f" | total {sum(buf[k] for k in names) / n:.0f}", flush=True)
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
                     ("htb_tail_out", ("htb_tail_out_wg",)),
                     ("htb_tail_out_base", ("htb_tail_out_wg",)),
                     ("scc_block", ("scc_fused_wgILi16", "scc_fused_wgILi64"))):
        if key not in libs:
            continue
        for fn, n in sass_sizes(out_dir / f"lib{key}.so", fns).items():
            print(f"  SASS {key:19s} {fn}: {n} instructions, {16 * n / 1024:.0f} KB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
