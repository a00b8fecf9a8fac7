"""Write ``wgmma.cuh``: one inline-PTX wrapper per ``wgmma`` tile width.

    python sisr_tpu_torch/csrc/gen_wgmma.py

A ``wgmma.mma_async`` instruction names every accumulator register of the
thread in its operand list (N/2 of them for an m64nNk16 float32 product),
and inline asm takes no parameter pack, so each width the kernels use gets
its own function, written out here.
"""

from pathlib import Path

WIDTHS = (16, 48, 64, 96, 128, 184, 256)
# widths with A read from registers (shuffled_tail.cu's conv_hr)
RS_WIDTHS = (64,)

HEAD = """\
// Generated by gen_wgmma.py; do not edit by hand.
//
// The wgmma pieces of the bfloat16 kernels (conv3x3.cu, scc_block.cu,
// htb_tail.cu, shuffled_tail.cu):
// wgmma_m64nNk16<N>(d, desc_a, desc_b): d (this thread's N/2 float32
// accumulators of a 64 x N tile) += A (64 x 16, bfloat16) x B (16 x N,
// bfloat16), both read from shared memory through their descriptors, both
// K-major (no transpose), scale-d 1.  Asynchronous: the caller brackets it
// with wgmma_fence / wgmma_commit / wgmma_wait.  sw128_desc describes a
// K-major tile of 128-byte rows (64 bfloat16) under the 128-byte swizzle:
// 16-byte chunk c of row r lies at chunk c ^ (r % 8), the tile starts on a
// 1024-byte boundary, and 8-row groups lie 1024 bytes apart; the k-th
// 16-deep slice of a 64-deep tile starts 32 * k bytes further.
// wgmma_m64nNk16_rs<N>(d, a, desc_b): the same with A (64 x 16) from this
// thread's four registers, in mma.m16n8k16's A fragment layout for the 16
// rows of its warp (what ldmatrix.x4 loads); a must stay unchanged until
// the product is waited for.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4)   // start address, 16-byte units
         | (uint64_t)1 << 16                      // leading offset (unused when swizzled)
         | (uint64_t)(1024 >> 4) << 32            // stride between 8-row groups
         | (uint64_t)1 << 62;                     // 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(N) : "memory");
}
// orders this thread's shared-memory writes (cp.async included) before
// later reads by the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across this point
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

template <int N>
__device__ __forceinline__ void wgmma_m64nNk16(float (&d)[N / 2], uint64_t desc_a,
                                               uint64_t desc_b);
template <int N>
__device__ __forceinline__ void wgmma_m64nNk16_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                                  uint64_t desc_b);
"""


def one(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ",\n        ".join(
        ", ".join(f'"+f"(d[{i}])' for i in range(j, min(j + 8, r))) for j in range(0, r, 8))
    return f"""
template <>
__device__ __forceinline__ void wgmma_m64nNk16<{n}>(float (&d)[{r}], uint64_t desc_a,
                                                  uint64_t desc_b) {{
  asm volatile(
      "{{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs}}}, "
      "%{r}, %{r + 1}, p, 1, 1, 0, 0;\\n"
      "}}\\n"
      : {outs}
      : "l"(desc_a), "l"(desc_b), "r"(1));
}}
"""


def one_rs(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ",\n        ".join(
        ", ".join(f'"+f"(d[{i}])' for i in range(j, min(j + 8, r))) for j in range(0, r, 8))
    return f"""
template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs<{n}>(float (&d)[{r}], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {{
  asm volatile(
      "{{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs}}}, "
      "{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, 0;\\n"
      "}}\\n"
      : {outs}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}}
"""


def text() -> str:
    """The header's contents."""
    return HEAD + "".join(one(n) for n in WIDTHS) + "".join(one_rs(n) for n in RS_WIDTHS)


def main() -> None:
    text_ = text()
    (Path(__file__).resolve().parent / "wgmma.cuh").write_text(text_)


if __name__ == "__main__":
    main()
