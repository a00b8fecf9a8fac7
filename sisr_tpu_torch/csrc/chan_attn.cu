// The whole-image reduction of DAT's channel attention (its Adaptive
// Channel Attention, "transposed" attention over channels): per (image,
// head), in one read of q and k from the qkv Linear's output
// (B, H, W, 3C), channels [q | k | v] each (head, d),
//   gram[i][j] = sum_p q[p, i] k[p, j],  nq[i] = sum_p q[p, i]^2,
//   nk[j] = sum_p k[p, j]^2
// over every pixel p of the image, accumulated in float32 and written as
// (B, heads, d * d + 2d): gram row-major, then nq, then nk.  The caller
// turns them into softmax_j(q_i . k_j / (|q_i| |k_j|) * temperature), a
// d x d matrix per head, and applies it to v.
//
// Launch 1, chan_attn_reduce_*: a grid of (slots, B) blocks; block s
// reduces a contiguous run of pixels of one image for every head and
// writes its sums into slot s of a float32 scratch (B, slots, heads,
// d * d + 2d).  Launch 2, chan_attn_sum: one thread per output element
// adds the slots in slot order.  No float atomics: the order of every sum
// is fixed, so the same inputs give the same bits back to back and under
// a CUDA graph.
//
// Replaces no TPU kernel: the JAX package has no softmax attention over
// channels (HiT-SR's SCC reduces inside windows); DAT brought it (PERF.md,
// kernel row 13).
//
// Bound: bytes.  A 1080p frame's q and k are 2 x 2.07 M pixels x 180
// channels (1.49 GB in bfloat16), read once; the products are 2 x 30 x 30
// multiply-adds a pixel a head (22 GFLOP a call), which the tensor cores
// do in a fraction of the 0.45 ms that 3.35 TB/s needs for the bytes.
// Design, bfloat16: 8 warps a block, warp h owns head h (DAT's 6 heads);
// chunks of 64 pixels of q and k, each head's d channels padded to 32 with
// zeros and rows 80 bytes apart (every ldmatrix free of bank conflicts),
// staged by cp.async in two buffers so that the next chunk loads while this
// one is reduced; the Gram on mma.sync m16n8k16 with the pixels as the
// reduction axis (both operands loaded with ldmatrix.trans: q^T as A, k as
// B), 2 x 4 tiles of 16 x 8 a warp; the squared norms on the FP32 pipes,
// a lane a channel pair of q (lanes 0-15) or k (16-31), a chunk's sum added
// to the slot's with Kahan's compensation (a plain float32 running sum of
// ~8,000 pixels' squares drifted 7e-6 from the float64 sum on a 1080p
// frame on an H100, 17x the plain version's einsum).  float32: chunks
// of 16 pixels, a lane an 8 x 4 tile of the 32 x 32 Gram on the FP32 pipes.
// Offsets that multiply a pixel by a channel count are 64-bit.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int DP = 32;                  // head size padded
constexpr int ROW = DP + 8;             // bfloat16 row stride in shared memory (80 bytes)
constexpr int WARPS = 8;                // the most heads a block reduces
constexpr int NT = WARPS * 32;
constexpr int PB = 64;                  // pixels a chunk (bfloat16)
constexpr int PF = 16;                  // pixels a chunk (float32)

struct Geo {
  int B, N, C, heads, d, slots, per;    // N pixels an image; per pixels a slot
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += a (16 x 16, row-major) x b (16 x 8, column-major), bfloat16 in,
// float32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s += v, the rounding error carried in c (Kahan): a slot adds thousands
// of chunks' norms, which a plain float32 sum would round once each
__device__ __forceinline__ void kahan(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// the slot's float32 sums of head h
__device__ __forceinline__ float* slot_of(float* part, const Geo& g, int b, int s, int h) {
  const int e = g.d * g.d + 2 * g.d;
  return part + (((long long)b * g.slots + s) * g.heads + h) * e;
}

// chunk c of the block's pixels into shared memory: [part (q, k)][head]
// [pixel][channel], zero past d and past the block's last pixel
template <typename T, int P, int R>
__device__ __forceinline__ void stage(T* dst, const T* qkv, const Geo& g, int b, long long p0,
                                      long long p1, int c) {
  constexpr int V = 4 / sizeof(T);       // values a 4-byte copy
  const long long base = p0 + (long long)c * P;
  const int per_row = DP / V;
  const int items = 2 * g.heads * P * per_row;
  for (int e = threadIdx.x; e < items; e += NT) {
    int r = e;
    const int ch = (r % per_row) * V;
    r /= per_row;
    const int h = r % g.heads;
    r /= g.heads;
    const int part = r % 2;
    const int p = r / 2;
    const long long px = base + p;
    const bool ok = px < p1 && ch < g.d;
    const T* src = ok ? qkv + ((long long)b * g.N + px) * 3LL * g.C + part * g.C + h * g.d + ch
                      : qkv;
    cp_async4(dst + ((part * g.heads + h) * P + p) * R + ch, src, ok);
  }
}

__global__ void __launch_bounds__(NT) chan_attn_reduce_bf16(const bf16* __restrict__ qkv,
                                                            float* __restrict__ part, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);
  const int s = blockIdx.x, b = blockIdx.y;
  const long long p0 = (long long)s * g.per;
  const long long p1 = min((long long)g.N, p0 + g.per);
  const int chunks = p1 > p0 ? (int)((p1 - p0 + PB - 1) / PB) : 0;
  const int size = 2 * g.heads * PB * ROW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[2][4][4] = {};
  float n0 = 0.0f, n1 = 0.0f, e0 = 0.0f, e1 = 0.0f;
  if (chunks) stage<bf16, PB, ROW>(buf, qkv, g, b, p0, p1, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const bf16* cur = buf + (c & 1) * size;
    if (c + 1 < chunks) stage<bf16, PB, ROW>(buf + ((c + 1) & 1) * size, qkv, g, b, p0, p1, c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (warp < g.heads) {
      const bf16* qs = cur + warp * PB * ROW;
      const bf16* ks = cur + (g.heads + warp) * PB * ROW;
      for (int k0 = 0; k0 < PB; k0 += 16) {
        uint32_t a[2][4], bb[2][4];
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4_t(a[mt], smem_u32(qs + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ROW +
                                    mt * 16 + ((lane >> 3) & 1) * 8));
        for (int np = 0; np < 2; ++np)
          ldsm_x4_t(bb[np], smem_u32(ks + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                                     np * 16 + (lane >> 4) * 8));
        for (int mt = 0; mt < 2; ++mt)
          for (int np = 0; np < 2; ++np) {
            mma16816(acc[mt][2 * np], a[mt], bb[np][0], bb[np][1]);
            mma16816(acc[mt][2 * np + 1], a[mt], bb[np][2], bb[np][3]);
          }
      }
      const bf16* src = (lane < 16 ? qs : ks) + 2 * (lane & 15);
      float c0 = 0.0f, c1 = 0.0f;
      for (int p = 0; p < PB; ++p) {
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + p * ROW));
        c0 = fmaf(v.x, v.x, c0);
        c1 = fmaf(v.y, v.y, c1);
      }
      kahan(n0, e0, c0);
      kahan(n1, e1, c1);
    }
    __syncthreads();
  }
  if (warp >= g.heads) return;
  float* dst = slot_of(part, g, b, s, warp);
  const int gr = lane >> 2, t = lane & 3;
  for (int mt = 0; mt < 2; ++mt)
    for (int nt = 0; nt < 4; ++nt)
      for (int e = 0; e < 4; ++e) {
        const int i = mt * 16 + gr + 8 * (e >> 1), j = nt * 8 + 2 * t + (e & 1);
        if (i < g.d && j < g.d) dst[i * g.d + j] = acc[mt][nt][e];
      }
  const int ch = 2 * (lane & 15);
  if (ch < g.d) {
    float* nd = dst + g.d * g.d + (lane < 16 ? 0 : g.d);
    nd[ch] = n0;
    nd[ch + 1] = n1;
  }
}

__global__ void __launch_bounds__(NT) chan_attn_reduce_f32(const float* __restrict__ qkv,
                                                           float* __restrict__ part, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  const int s = blockIdx.x, b = blockIdx.y;
  const long long p0 = (long long)s * g.per;
  const long long p1 = min((long long)g.N, p0 + g.per);
  const int chunks = p1 > p0 ? (int)((p1 - p0 + PF - 1) / PF) : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = (lane >> 3) * 8, j0 = (lane & 7) * 4;
  float acc[8][4] = {};
  float nq = 0.0f, nk = 0.0f, eq = 0.0f, ek = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    stage<float, PF, DP>(buf, qkv, g, b, p0, p1, c);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp < g.heads) {
      const float* qs = buf + warp * PF * DP;
      const float* ks = buf + (g.heads + warp) * PF * DP;
      float cq = 0.0f, ck = 0.0f;
      for (int p = 0; p < PF; ++p) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + p * DP + i0);
        const float4 qb = *reinterpret_cast<const float4*>(qs + p * DP + i0 + 4);
        const float4 kk = *reinterpret_cast<const float4*>(ks + p * DP + j0);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(qv[a], kv[e], acc[a][e]);
        const float x = qs[p * DP + lane], y = ks[p * DP + lane];
        cq = fmaf(x, x, cq);
        ck = fmaf(y, y, ck);
      }
      kahan(nq, eq, cq);
      kahan(nk, ek, ck);
    }
    __syncthreads();
  }
  if (warp >= g.heads) return;
  float* dst = slot_of(part, g, b, s, warp);
  for (int a = 0; a < 8; ++a)
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + a, j = j0 + e;
      if (i < g.d && j < g.d) dst[i * g.d + j] = acc[a][e];
    }
  if (lane < g.d) {
    dst[g.d * g.d + lane] = nq;
    dst[g.d * g.d + g.d + lane] = nk;
  }
}

// out[b][e] = sum over s, in slot order, of part[b][s][e]
__global__ void chan_attn_sum(const float* __restrict__ part, float* __restrict__ out, int B,
                              int slots, int he) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * he) return;
  const int b = idx / he, e = idx % he;
  const float* src = part + (long long)b * slots * he + e;
  float acc = 0.0f;
  for (int s = 0; s < slots; ++s) acc += src[(long long)s * he];
  out[idx] = acc;
}

}  // namespace

// qkv (B, N pixels, 3C) -> out (B, heads, d * d + 2d) float32, through the
// float32 scratch part (B, slots, heads, d * d + 2d)
extern "C" int chan_attn_launch(int dtype, const void* qkv, void* part, void* out, int B, int N,
                                int C, int heads, int slots, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || heads > WARPS || C % heads || slots <= 0) return -1;
  const int d = C / heads;
  if (d > DP || d % 2 || B > 65535) return -1;
  Geo g;
  g.B = B, g.N = N, g.C = C, g.heads = heads, g.d = d, g.slots = slots;
  g.per = (N + slots - 1) / slots;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(slots, B);
  if (dtype == 1) {
    const size_t bytes = sizeof(bf16) * 2 * (size_t)(2 * heads * PB * ROW);
    if (set_smem(chan_attn_reduce_bf16, bytes)) return -1;
    chan_attn_reduce_bf16<<<grid, NT, bytes, s>>>(static_cast<const bf16*>(qkv),
                                                  static_cast<float*>(part), g);
  } else if (dtype == 0) {
    const size_t bytes = sizeof(float) * (size_t)(2 * heads * PF * DP);
    if (set_smem(chan_attn_reduce_f32, bytes)) return -1;
    chan_attn_reduce_f32<<<grid, NT, bytes, s>>>(static_cast<const float*>(qkv),
                                                 static_cast<float*>(part), g);
  } else {
    return -1;
  }
  const int he = heads * (d * d + 2 * d);
  chan_attn_sum<<<(B * he + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                     static_cast<float*>(out), B, slots, he);
  return (int)cudaGetLastError();
}
