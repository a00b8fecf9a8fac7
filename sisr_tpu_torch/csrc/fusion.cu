// The Fusion gate between the deep and shallow streams (reference
// models/hit_sir_pro.py:104-162): three UnionAttentions on a, a + b and b,
// then out = a * sigmoid(a_att * g) + b * sigmoid(b_att * (1 - g)) with
// g = sigmoid(ua2).  NHWC, a and b (B, H, W, C) in float32 or bfloat16.
//
// Replaces sisr_tpu/ops/pallas/fusion_ops.py:
//   fusion_pools_launch   _fusion_pools_pallas (_pools_kernel): the nine
//                         mean/max pool pairs over C, H and W of a, a+b, b;
//   fusion_maps_gate_launch  _fused_fusion_pallas: its maps kernel
//                         (_maps_kernel) and gate kernel (_gate_kernel).
//
// The pools and the gate are bound by bytes on the H100: a and b are 26.5
// MB at a bf16 192^2 tile and 1.5 GB at the 1080p frame.  Both read them in
// wide vectors (four channels a thread: 8 bytes of bfloat16, 16 of
// float32) with the next loads in flight while the current ones are summed,
// and keep every sum on chip; a + b is rounded to the storage type as the
// plain version's a + b is, and the max slots take stored values (exact).
//
// Pools (pools_cw, then pools_h).  The TPU kernel reads a and b once in row
// bands and folds the H pools across its sequential band steps.  CUDA
// blocks run in parallel and float atomics would change the bits from run
// to run; a single pass over tiles then needs partial records of W or H,
// and reducing those across threads every few pixels cost more than a
// second read (measured, PERF.md).  So two passes, each summing in a fixed
// order: pools_cw takes an image row a block (C pools through a staged
// chunk and a shuffle tree, W pools in registers over the whole row) and
// pools_h a column vector a thread (H pools in registers over every
// fourth row, four row groups a block).  At a tile the second read comes
// from L2.
//
// Maps (fusion_maps).  Each UnionAttention ends in conv_last(c_att + h_att
// + w_att), and conv_last is linear, so it splits over the three broadcast
// terms: the row-constant h_att becomes a 1-D conv along W with row-summed
// kernels (hout, plus the corrections hcorr where row 0 / H-1 misses a
// kernel row to the zero padding), the column-constant w_att a 1-D conv
// along H (wout, wcorr), and c_att a 9-tap product with the channel-summed
// kernel (k1blk) left to the gate.  For each UA and side the three taps
// and three outputs are one product: the rows of h_att (w_att) with their
// +-1 neighbours, (N, 3C), times the (3C, 3C) block of khw for that side.
// A block computes 32 rows x 64 output columns of it: the 18-tap conv of
// the pools for its 34 rows of h_att (w_att) from a slab copied into shared
// memory by cp.async, then the product with khw's tap blocks copied one at
// a time; in bfloat16 on the tensor cores (wmma, h_att rounded to bfloat16
// as the product's input, as the plain bfloat16 version rounds conv_last's
// input; rows padded against bank conflicts), in float32 on 2x4 FP32
// register tiles.  2 * 27 * (H + W) * C^2 operations: 0.67 GFLOP a tile,
// 5.3 at the frame.
//
// Gate (fusion_gate).  A block takes 16 (or 8) rows x 16 pixels and a
// thread two consecutive channels (the 27 taps of k1blk in registers) of
// every plg-th pixel, in items of a pixel's 8 rows (4 in float32), the
// next item's a and b in flight.  It first copies the tile's rows of wout
// and pixels of hout by cp.async, computes the tile's c_att with a 1-pixel
// halo (the 3x3 conv1 of the C pools, as the TPU maps kernel does, rounded
// to the compute type as the TPU kernel rounds p27) and lays out each
// pixel's 27 taps in shared memory.  base = p27 @ k1blk on the FP32 pipes,
// the maps and (in blocks on the image border only) their corrections,
// then the sigmoids and the gate in float32 (tanh.approx in bfloat16,
// whose output is rounded to bfloat16 anyway), stored in a's type.  At two
// blocks an SM (168 registers) it is bound by instruction latency, not by
// bytes (PERF.md); at three it spills.
#include "common.cuh"

#include <mma.h>

#include <algorithm>
#include <type_traits>

namespace {

// ---- vectors of V channels --------------------------------------------------

template <typename T, int V>
__device__ __forceinline__ void ldv(T (&d)[V], const T* p) {
  constexpr int bytes = V * (int)sizeof(T);
  if constexpr (bytes == 16) {
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (bytes == 8) {
    *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (bytes == 4) {
    *reinterpret_cast<unsigned*>(d) = *reinterpret_cast<const unsigned*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] = p[i];
  }
}

template <typename T, int V>
__device__ __forceinline__ void stv(T* p, const T (&d)[V]) {
  constexpr int bytes = V * (int)sizeof(T);
  if constexpr (bytes == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(d);
  } else if constexpr (bytes == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(d);
  } else if constexpr (bytes == 4) {
    *reinterpret_cast<unsigned*>(p) = *reinterpret_cast<const unsigned*>(d);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = d[i];
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack(float (&f)[V], const T (&x)[V]) {
  if constexpr (std::is_same<T, bf16>::value && V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 v = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(x)[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f<T>(x[i]);
  }
}

// ts = a + b rounded to T (one rounding, as the plain version's a + b), fs
// its value as float
template <typename T, int V>
__device__ __forceinline__ void add_round(T (&ts)[V], float (&fs)[V], const float (&fa)[V],
                                          const float (&fb)[V]) {
  if constexpr (std::is_same<T, bf16>::value && V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const __nv_bfloat162 r =
          __floats2bfloat162_rn(fa[2 * i] + fb[2 * i], fa[2 * i + 1] + fb[2 * i + 1]);
      reinterpret_cast<__nv_bfloat162*>(ts)[i] = r;
      const float2 v = __bfloat1622float2(r);
      fs[2 * i] = v.x;
      fs[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ts[i] = from_f<T>(fa[i] + fb[i]);
      fs[i] = to_f<T>(ts[i]);
    }
  }
}

// m = max(m, x) per channel, on stored values (exact)
template <int V>
__device__ __forceinline__ void vmax(float (&m)[V], const float (&x)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = fmaxf(m[i], x[i]);
}
template <int V>
__device__ __forceinline__ void vmax(bf16 (&m)[V], const bf16 (&x)[V]) {
  if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      reinterpret_cast<__nv_bfloat162*>(m)[i] =
          __hmax2(reinterpret_cast<const __nv_bfloat162*>(m)[i],
                  reinterpret_cast<const __nv_bfloat162*>(x)[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = __hmax(m[i], x[i]);
  }
}

// ---- pools ------------------------------------------------------------------

constexpr int CW_NT = 384;     // pools_cw: loading threads a block at most (G <= 384)
constexpr int CW_PARTS = 8;    // pools_cw: lanes that share a pixel's C pools
constexpr int H_NT = 256;      // pools_h: threads a block
constexpr int H_ROWG = 4;      // pools_h: row groups a block

// pools_cw's layout; fusion_ops.py::pools_layout mirrors it.  v channels a
// thread (4 where C and the pointers allow), s pixels a thread a chunk,
// pl pixel lanes: nt = pl * C / v loading threads (the block rounded up to
// whole warps), chunks of p = s * pl pixels.
struct CwLayout {
  int v, s, pl, nt, p;
};

CwLayout cw_layout(int W, int C, int es, bool aligned) {
  CwLayout q{};
  q.v = (C % 4 == 0 && aligned) ? 4 : 1;
  q.s = es == 2 ? 4 : 2;
  const int g = C / q.v;
  q.pl = std::max(1, std::min(std::min(CW_NT / g, 32), (W + q.s - 1) / q.s));
  q.nt = q.pl * g;
  q.p = q.s * q.pl;
  return q;
}

// the C and W pools of one image row (blockIdx.x, blockIdx.y): cp (B, 6,
// H, W) and wp (B, 6, H, C) in T.  The row goes by in chunks of P pixels;
// a thread (pl, g) loads channels g*V.. of pixels pl + i*pl_n of a chunk
// (the next chunk's loads in flight while it stores this one), adds them
// to its W sums and maxes, and stores a, a + b and b in the chunk's
// shared-memory stage [3][P][C]; then CW_PARTS lanes a pixel sum its C
// pools from the stage, each over its share of the channel groups, and
// combine by a xor-shuffle tree.  At the row's end the pl_n lanes' W sums
// go through shared memory [6][pl_n][C] and are summed in lane order.
template <typename T, int V, int S>
__global__ void __launch_bounds__(CW_NT + 32)
pools_cw(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ cp,
         T* __restrict__ wp, int H, int W, int C, int pl_n) {
  extern __shared__ __align__(16) unsigned char cw_smem[];
  const int h = blockIdx.x, bi = blockIdx.y;
  const int G = C / V, P = S * pl_n, nthr = blockDim.x;
  const int t = threadIdx.x, pl = t / G, g = t % G;
  const bool loader = pl < pl_n;
  T* stage = reinterpret_cast<T*>(cw_smem);   // [2][3][P][C]
  const T neg = from_f<T>(-CUDART_INF_F);
  const long long row = ((long long)bi * H + h) * W;

  float ws[3][V];
  T wm[3][V];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ws[k][i] = 0.0f;
      wm[k][i] = neg;
    }
  alignas(16) T ca[S][V], cb[S][V], na[S][V], nb[S][V];
  auto load_chunk = [&](int w0, T (&xa)[S][V], T (&xb)[S][V]) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int w = w0 + pl + s * pl_n;
      if (!loader || w >= W) continue;
      const long long off = (row + w) * C + g * V;
      ldv<T, V>(xa[s], a + off);
      ldv<T, V>(xb[s], b + off);
    }
  };
  // the C pools' lanes: CW_PARTS a pixel, each over channel groups [g0, g1)
  const int part = t % CW_PARTS;
  const int per = (G + CW_PARTS - 1) / CW_PARTS;
  const int g0 = min(G, part * per), g1 = min(G, g0 + per);

  load_chunk(0, ca, cb);
  int buf = 0;
  for (int w0 = 0; w0 < W; w0 += P, buf ^= 1) {
    if (w0 + P < W) load_chunk(w0 + P, na, nb);
    T* st = stage + (long long)buf * 3 * P * C;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int p = pl + s * pl_n;
      if (!loader || w0 + p >= W) continue;
      float fa[V], fs[V], fb[V];
      alignas(16) T ts[V];
      unpack<T, V>(fa, ca[s]);
      unpack<T, V>(fb, cb[s]);
      add_round<T, V>(ts, fs, fa, fb);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ws[0][i] += fa[i];
        ws[1][i] += fs[i];
        ws[2][i] += fb[i];
      }
      vmax<V>(wm[0], ca[s]);
      vmax<V>(wm[1], ts);
      vmax<V>(wm[2], cb[s]);
      stv<T, V>(st + (0 * P + p) * C + g * V, ca[s]);
      stv<T, V>(st + (1 * P + p) * C + g * V, ts);
      stv<T, V>(st + (2 * P + p) * C + g * V, cb[s]);
    }
    __syncthreads();
    // C pools of the chunk's pixels (the block is whole warps, and every
    // lane takes part in the shuffles; lanes past the chunk add nothing)
    for (int e0 = 0; e0 < P * CW_PARTS; e0 += nthr) {
      const int cpx = (e0 + t) / CW_PARTS;
      float cs[3] = {0.0f, 0.0f, 0.0f}, cm[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
      const bool live = cpx < P && w0 + cpx < W;
      for (int j = g0; live && j < g1; ++j) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          alignas(16) T x[V];
          ldv<T, V>(x, st + (k * P + cpx) * C + j * V);
          float f[V];
          unpack<T, V>(f, x);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            cs[k] += f[i];
            cm[k] = fmaxf(cm[k], f[i]);
          }
        }
      }
#pragma unroll
      for (int o = CW_PARTS / 2; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], o);
          cm[k] = fmaxf(cm[k], __shfl_xor_sync(0xffffffffu, cm[k], o));
        }
      if (part == 0 && live) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          cp[(((long long)bi * 6 + 2 * k) * H + h) * W + w0 + cpx] = from_f<T>(cs[k] / (float)C);
          cp[(((long long)bi * 6 + 2 * k + 1) * H + h) * W + w0 + cpx] = from_f<T>(cm[k]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ca[s][i] = na[s][i];
        cb[s][i] = nb[s][i];
      }
  }
  // the W pools: the pl_n lanes' sums in lane order (the stage is free
  // once every lane has passed the last chunk's C pools)
  __syncthreads();
  float* wbuf = reinterpret_cast<float*>(cw_smem);   // [6][pl_n][C]
  if (loader) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        wbuf[((2 * k) * pl_n + pl) * C + g * V + i] = ws[k][i];
        wbuf[((2 * k + 1) * pl_n + pl) * C + g * V + i] = to_f<T>(wm[k][i]);
      }
  }
  __syncthreads();
  for (int e = t; e < 6 * C; e += nthr) {
    const int slot = e / C, c = e % C;
    const float* q = wbuf + slot * pl_n * C + c;
    float acc = q[0];
    for (int j = 1; j < pl_n; ++j) acc = slot % 2 == 0 ? acc + q[j * C] : fmaxf(acc, q[j * C]);
    wp[(((long long)bi * 6 + slot) * H + h) * C + c] = from_f<T>(slot % 2 == 0 ? acc / (float)W : acc);
  }
}

// the H pools: hp (B, 6, W, C) float32.  A block of H_NT threads takes
// H_NT / H_ROWG column vectors (channels g*V.. of a pixel w) in H_ROWG row
// groups; a thread sums every H_ROWG-th row of its column, four rows'
// loads in flight, and the groups are combined in order.
template <typename T, int V>
__global__ void __launch_bounds__(H_NT)
pools_h(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ hp, int H, int W,
        int C) {
  __shared__ float part[H_NT][6][V];
  constexpr int rowg = H_ROWG, cols = H_NT / H_ROWG;
  const int G = C / V, bi = blockIdx.y;
  const int col = threadIdx.x % cols, rg = threadIdx.x / cols;
  const long long cv = (long long)blockIdx.x * cols + col;
  const bool live = cv < (long long)W * G;
  const long long WC = (long long)W * C;
  float s[3][V], m[3][V];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[k][i] = 0.0f;
      m[k][i] = -CUDART_INF_F;
    }
  auto take = [&](const T (&xa)[V], const T (&xb)[V]) {
    float fa[V], fs[V], fb[V];
    alignas(16) T ts[V];
    unpack<T, V>(fa, xa);
    unpack<T, V>(fb, xb);
    add_round<T, V>(ts, fs, fa, fb);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[0][i] += fa[i];
      s[1][i] += fs[i];
      s[2][i] += fb[i];
      m[0][i] = fmaxf(m[0][i], fa[i]);
      m[1][i] = fmaxf(m[1][i], fs[i]);
      m[2][i] = fmaxf(m[2][i], fb[i]);
    }
  };
  if (live) {
    const long long off = (long long)bi * H * WC + cv * V;   // (w, g) -> w*C + g*V
    int y = rg;
    for (; y + 3 * rowg < H; y += 4 * rowg) {
      alignas(16) T xa[4][V], xb[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ldv<T, V>(xa[u], a + off + (y + u * rowg) * WC);
        ldv<T, V>(xb[u], b + off + (y + u * rowg) * WC);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) take(xa[u], xb[u]);
    }
    for (; y < H; y += rowg) {
      alignas(16) T xa[V], xb[V];
      ldv<T, V>(xa, a + off + y * WC);
      ldv<T, V>(xb, b + off + y * WC);
      take(xa, xb);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[threadIdx.x][2 * k][i] = s[k][i];
      part[threadIdx.x][2 * k + 1][i] = m[k][i];
    }
  __syncthreads();
  if (rg != 0 || !live) return;
  const long long w = cv / G, c0 = (cv % G) * V;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float ts = part[col][2 * k][i], tm = part[col][2 * k + 1][i];
      for (int q = 1; q < rowg; ++q) {
        ts += part[q * cols + col][2 * k][i];
        tm = fmaxf(tm, part[q * cols + col][2 * k + 1][i]);
      }
      hp[(((long long)bi * 6 + 2 * k) * W + w) * C + c0 + i] = ts / (float)H;
      hp[(((long long)bi * 6 + 2 * k + 1) * W + w) * C + c0 + i] = tm;
    }
}

// ---- maps -------------------------------------------------------------------

constexpr int MAP_NT = 256;
constexpr int MAP_M = 32;   // rows of h_att (w_att) a block
constexpr int MAP_O = 64;   // output columns (of 3C) a block

struct Maps {
  // pools and packed weights (fusion_ops.py::pack_params)
  const void *wp;                             // the compute type
  const float* hp;
  const float *c2w, *c3w, *cb, *clb;          // (3, 18), (3, 18), (9,), (3, C)
  const void* khw;                            // (3, 18, C, C), the compute type
  // outputs, float32
  float *hout, *wout, *hcorr, *wcorr;         // (B,3,W,C) (B,3,H,C) (B,2,3,W,C) (B,2,3,H,C)
  int H, W, C, cp16;                          // cp16: C rounded up to 16
};

// The folded block's shared memory: h_att (w_att) rows [MAP_M + 2][ld] in
// Q (bfloat16 for the tensor cores, else float), then one region for the
// pool slab [2][MAP_M + 4][C] as stored (float for hp, T for wp), a tap
// block of khw [cp16][TAP_LD] in T, and the output tile [MAP_M][MAP_O + 4]
// float in turn.
template <typename T>
struct MapLayout {
  using Q = T;
  // h_att rows: in bfloat16 32 bytes past a multiple of 128 (rows stay
  // 32-byte aligned for wmma, and 8 rows meet at most 2 to a bank)
  __host__ __device__ static int ld(int cp16) {
    return std::is_same<T, bf16>::value ? cp16 + (80 - cp16 % 64) % 64 : cp16 + 4;
  }
  // the tap block's rows, likewise
  static constexpr int TAP_LD = std::is_same<T, bf16>::value ? MAP_O + 16 : MAP_O;
  __host__ __device__ static size_t src_bytes(int cp16) {
    return (((size_t)(MAP_M + 2) * ld(cp16) * sizeof(Q)) + 127) / 128 * 128;
  }
  static size_t bytes(int C, int cp16) {
    const size_t slab = sizeof(float) * 2 * (MAP_M + 4) * C;
    const size_t tap = sizeof(T) * (size_t)cp16 * TAP_LD;
    const size_t tile = sizeof(float) * MAP_M * (MAP_O + 4);
    return src_bytes(cp16) + std::max(slab, std::max(tap, tile));
  }
};

// rows r0-2 .. r0+MAP_M+1 of the two pools (mean, max) of one side into
// slab [2][MAP_M + 4][C] as stored, zero outside [0, N): cp.async copies
// of 16, 8 or 4 bytes as C allows, all in flight at once
template <typename P>
__device__ void stage_slab(P* slab, const P* pool2, int N, int C, int r0) {
  constexpr int SR = MAP_M + 4;
  const int rowb = C * (int)sizeof(P);
  const int vb = rowb % 16 == 0 ? 16 : rowb % 8 == 0 ? 8 : rowb % 4 == 0 ? 4 : 0;
  if (vb == 0) {
    for (int e = threadIdx.x; e < 2 * SR * C; e += MAP_NT) {
      const int ch = e / (SR * C), i = (e / C) % SR, c = e % C, n = r0 - 2 + i;
      slab[e] = (n >= 0 && n < N) ? pool2[((long long)ch * N + n) * C + c] : from_f<P>(0.0f);
    }
    return;
  }
  const int per_row = rowb / vb;
  for (int e = threadIdx.x; e < 2 * SR * per_row; e += MAP_NT) {
    const int row = e / per_row, j = e % per_row, ch = row / SR, i = row % SR, n = r0 - 2 + i;
    const bool in = n >= 0 && n < N;
    const char* src = reinterpret_cast<const char*>(pool2 + ((long long)ch * N + (in ? n : 0)) * C) + j * vb;
    char* dst = reinterpret_cast<char*>(slab + (long long)row * C) + j * vb;
    if (vb == 16) cp_async16(dst, src, in);
    else if (vb == 8) cp_async8(dst, src, in);
    else cp_async4(dst, src, in);
  }
  cp_async_commit();
}

// src rows r0-1 .. r0+MAP_M of the (N, C) map att (h_att: N = W from hp
// with conv2; w_att: N = H from wp with conv3), zero outside [0, N) and in
// columns C..cp16-1.  The conv runs over the grid (C, N): out[n][c] =
// bias + sum pool[ch][n + bb - 1][c + a - 1] * w[ch*9 + a*3 + bb]
template <typename Q, typename P>
__device__ void side_src(Q* src, int ld, P* slab, const P* pool2, const float* w, float bias,
                         int N, int C, int cp16, int r0) {
  constexpr int SR = MAP_M + 4;
  stage_slab<P>(slab, pool2, N, C, r0);
  cp_async_wait<0>();
  __syncthreads();
  for (int c = threadIdx.x; c < cp16; c += MAP_NT) {
    float wt[18];
#pragma unroll
    for (int i = 0; i < 18; ++i) wt[i] = w[i];
    for (int rr = 0; rr < MAP_M + 2; ++rr) {
      const int n = r0 - 1 + rr;
      float acc = 0.0f;
      if (c < C && n >= 0 && n < N) {
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          const P* m = slab + ch * SR * C;
#pragma unroll
          for (int bb = 0; bb < 3; ++bb)
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const int cc = c + a - 1;
              if (cc >= 0 && cc < C)
                acc = fmaf(to_f<P>(m[(rr + bb) * C + cc]), wt[ch * 9 + a * 3 + bb], acc);
            }
        }
        acc += bias;
      }
      src[rr * ld + c] = from_f<Q>(acc);
    }
  }
  __syncthreads();
}

// khw's tap j of the block's columns into tap [cp16][TAP_LD]: column o0 + oo
// is output q = o / C, channel n = o % C, from khw[k][base + 3q + j][c][n];
// four columns a thread by cp.async (8 or 16 bytes) where C % 4 == 0
template <typename T>
__device__ void stage_tap(T* tap, const Maps& p, int k, int base, int j, int o0) {
  const T* khw = (const T*)p.khw;
  const int C = p.C;
  const long long CC = (long long)C * C;
  const int V = C % 4 == 0 ? 4 : 1;
  const int oo = (threadIdx.x * V) % MAP_O, rstep = MAP_NT * V / MAP_O;
  const int o = o0 + oo, q = o / C, n = o % C;
  const bool live = o < 3 * C;
  const T* col = khw + ((long long)k * 18 + base + 3 * (live ? q : 0) + j) * CC + (live ? n : 0);
  for (int c = threadIdx.x * V / MAP_O; c < p.cp16; c += rstep) {
    T* dst = tap + c * MapLayout<T>::TAP_LD + oo;
    const bool in = live && c < C;
    const T* from = col + (long long)(in ? c : 0) * C;
    if (V == 4) {
      if (sizeof(T) == 2) cp_async8(dst, from, in);
      else cp_async16(dst, from, in);
    } else {
      dst[0] = in ? *from : from_f<T>(0.0f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// one block of the folded product: rows r0 .. r0+MAP_M-1 of side `side`
// (0: hout, hcorr along W; 1: wout, wcorr along H) of UA k, output
// columns o0 .. o0+MAP_O-1 of [main | corr0 | corr1]
template <typename T>
__device__ void folded(const Maps& p, char* sm, int bi, int k, int side, int r0, int o0) {
  using L = MapLayout<T>;
  using Q = typename L::Q;
  const int C = p.C, cp16 = p.cp16, ld = L::ld(cp16), N = side ? p.H : p.W;
  const int base = side ? 9 : 0;
  Q* src = (Q*)sm;
  char* region = sm + L::src_bytes(cp16);
  if (side == 0) {
    side_src<Q, float>(src, ld, (float*)region, p.hp + ((long long)bi * 6 + 2 * k) * p.W * C,
                       p.c2w + k * 18, p.cb[3 * k + 1], N, C, cp16, r0);
  } else {
    side_src<Q, T>(src, ld, (T*)region, (const T*)p.wp + ((long long)bi * 6 + 2 * k) * p.H * C,
                   p.c3w + k * 18, p.cb[3 * k + 2], N, C, cp16, r0);
  }
  T* tap = (T*)region;
  float* tile = (float*)region;
  constexpr int TLD = MAP_O + 4;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    // 8 warps, each a 16 x 16 piece of the 32 x 64 tile
    const int warp = threadIdx.x / 32, wm = (warp % 2) * 16, wn = (warp / 2) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int j = 0; j < 3; ++j) {
      stage_tap<T>(tap, p, k, base, j, o0);
      __syncthreads();
      for (int c0 = 0; c0 < cp16; c0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, src + (wm + j) * ld + c0, ld);
        wmma::load_matrix_sync(fb, tap + c0 * L::TAP_LD + wn, L::TAP_LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      __syncthreads();
    }
    wmma::store_matrix_sync(tile + wm * TLD + wn, acc, TLD, wmma::mem_row_major);
  } else {
    // 2 x 4 outputs a thread
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
    for (int j = 0; j < 3; ++j) {
      stage_tap<T>(tap, p, k, base, j, o0);
      __syncthreads();
      const float* as = src + (ty * 2 + j) * ld;
      const float* bs = (const float*)tap + tx * 4;
      for (int c = 0; c < C; ++c) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + c * MAP_O);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float av = as[i * ld + c];
          acc[i][0] = fmaf(av, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av, bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) tile[(ty * 2 + i) * TLD + tx * 4 + jj] = acc[i][jj];
  }
  __syncthreads();
  const long long NC = (long long)N * C;
  float* main = side ? p.wout + ((long long)bi * 3 + k) * NC : p.hout + ((long long)bi * 3 + k) * NC;
  float* corr = side ? p.wcorr : p.hcorr;
  for (int e = threadIdx.x; e < MAP_M * MAP_O; e += MAP_NT) {
    const int m = e / MAP_O, o = o0 + e % MAP_O, row = r0 + m;
    if (row >= N || o >= 3 * C) continue;
    const int q = o / C, n = o % C;
    const float v = tile[m * TLD + e % MAP_O];
    if (q == 0) {
      main[(long long)row * C + n] = side ? v : v + p.clb[k * C + n];
    } else {
      corr[(((long long)bi * 2 + q - 1) * 3 + k) * NC + (long long)row * C + n] = v;
    }
  }
}

// B * 3 * (ceil(W / MAP_M) + ceil(H / MAP_M)) * ceil(3C / MAP_O) blocks, in
// the order image, UA, side 0's row tiles then side 1's, output columns
template <typename T>
__global__ void __launch_bounds__(MAP_NT) fusion_maps(Maps p) {
  extern __shared__ __align__(128) char msm[];
  const int tw = (p.W + MAP_M - 1) / MAP_M, th = (p.H + MAP_M - 1) / MAP_M;
  const int no = (3 * p.C + MAP_O - 1) / MAP_O;
  const int per = (tw + th) * no;
  const int blk = blockIdx.x, bk = blk / per, t = blk % per, mt = t / no, ot = t % no;
  const int side = mt < tw ? 0 : 1;
  folded<T>(p, msm, bk / 3, bk % 3, side, (side ? mt - tw : mt) * MAP_M, ot * MAP_O);
}

// ---- gate -------------------------------------------------------------------

constexpr int GATE_R = 16;    // rows of a gate block at most (Gate::rows: 16 or 8)
constexpr int GATE_P = 16;    // pixels of a gate block
constexpr int GATE_NT = 192;  // threads a gate block at most


// sigmoid in float32; in bfloat16 (whose result is rounded to bfloat16)
// through tanh.approx, one MUFU operation
template <typename T>
__device__ __forceinline__ float sigmoid_t(float x) {
  if constexpr (std::is_same<T, bf16>::value) {
    float y;
    asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(0.5f * x));
    return fmaf(0.5f, y, 0.5f);
  } else {
    return __fdividef(1.0f, 1.0f + __expf(-x));
  }
}

struct Gate {
  const void *a, *b, *k1blk, *cp;             // the compute type
  const float *c1w, *cb;                      // (3, 18), (9,)
  const float *hout, *wout, *hcorr, *wcorr;
  void* out;
  int H, W, C, plg, rows;
};

// att minus the corrections that the border rows and columns take, in the
// order rows 0, H-1, then columns 0, W-1
template <int V>
__device__ __forceinline__ void border(float (&att)[3][V], const Gate& p, int bi, int h, int x,
                                    int c0) {
  const int H = p.H, W = p.W, C = p.C;
  const long long WC = (long long)W * C, HC = (long long)H * C;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = c0 + v;
      float sv = att[k][v];
      if (h == 0) sv -= p.hcorr[((long long)bi * 6 + k) * WC + (long long)x * C + c];
      if (h == H - 1) sv -= p.hcorr[((long long)bi * 6 + 3 + k) * WC + (long long)x * C + c];
      if (x == 0) sv -= p.wcorr[((long long)bi * 6 + k) * HC + (long long)h * C + c];
      if (x == W - 1) sv -= p.wcorr[((long long)bi * 6 + 3 + k) * HC + (long long)h * C + c];
      att[k][v] = sv;
    }
}

// the thread's items, (pixel, group of U rows), in one sequence: the next
// item's a and b in flight while this one is computed.  EDGE: the block
// holds an image border row or column, whose corrections it subtracts.
template <typename T, int V, int U, bool EDGE>
__device__ __forceinline__ void gate_items(const Gate& p, const float (&kt)[27][V],
                                           const float* p27, const float* wos, const float* hos,
                                           int bi, int x0, int y0, int nr, int npx, int pl,
                                           int c0) {
  const int H = p.H, W = p.W, C = p.C, WC = W * C;
  const int ng = (nr + U - 1) / U, nmine = (npx - pl + p.plg - 1) / p.plg;
  const int n_items = max(0, nmine) * ng;
  const T* a = (const T*)p.a;
  const T* b = (const T*)p.b;
  T* out = (T*)p.out;
  // element offset of (y0, x0, c0) in the image; an item adds its pixel and
  // rows, a row within it u * WC
  const long long corner = (((long long)bi * H + y0) * W + x0) * C + c0;
  alignas(8) T va[U][V], vb[U][V], na[U][V], nb[U][V];
  auto load_item = [&](int it, T (&xa)[U][V], T (&xb)[U][V]) {
    const int px = pl + (it / ng) * p.plg, r0 = (it % ng) * U;
    const T* pa = a + corner + (long long)r0 * WC + (long long)px * C;
    const T* pb = b + corner + (long long)r0 * WC + (long long)px * C;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (EDGE && r0 + u >= nr) break;
      ldv<T, V>(xa[u], pa + u * WC);
      ldv<T, V>(xb[u], pb + u * WC);
    }
  };
  if (n_items > 0) load_item(0, va, vb);
#pragma unroll 1
  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) load_item(it + 1, na, nb);
    const int px = pl + (it / ng) * p.plg, r0 = (it % ng) * U;
    T* po = out + corner + (long long)r0 * WC + (long long)px * C;
    float ho[3][V];
#pragma unroll
    for (int k = 0; k < 3; ++k) ldv<float, V>(ho[k], hos + (px * 3 + k) * C + c0);
    const float* tap = p27 + (r0 * GATE_P + px) * 28;
    const float* wrow = wos + r0 * 3 * C + c0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (EDGE && r0 + u >= nr) break;
      float tp[28];
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        const float4 t4 = *reinterpret_cast<const float4*>(tap + u * GATE_P * 28 + 4 * q);
        tp[4 * q] = t4.x;
        tp[4 * q + 1] = t4.y;
        tp[4 * q + 2] = t4.z;
        tp[4 * q + 3] = t4.w;
      }
      float att[3][V];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float wo[V];
        ldv<float, V>(wo, wrow + (u * 3 + k) * C);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float base = 0.0f;
#pragma unroll
          for (int q = 0; q < 9; ++q) base = fmaf(tp[9 * k + q], kt[9 * k + q][v], base);
          att[k][v] = base + ho[k][v] + wo[v];
        }
      }
      if (EDGE) {
        const int h = y0 + r0 + u, x = x0 + px;
        if (h == 0 || h == H - 1 || x == 0 || x == W - 1) border<V>(att, p, bi, h, x, c0);
      }
      float fa[V], fb[V];
      unpack<T, V>(fa, va[u]);
      unpack<T, V>(fb, vb[u]);
      alignas(8) T ov[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float gt = sigmoid_t<T>(att[1][v]);
        ov[v] = from_f<T>(fa[v] * sigmoid_t<T>(att[0][v] * gt) +
                          fb[v] * sigmoid_t<T>(att[2][v] * (1.0f - gt)));
      }
      stv<T, V>(po + u * WC, ov);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        va[u][v] = na[u][v];
        vb[u][v] = nb[u][v];
      }
  }
}

// shared memory: cps [6][GATE_R + 4][GATE_P + 4] (the C pools around the
// tile), cs [3][GATE_R + 2][GATE_P + 2] (c_att, rounded), p27
// [GATE_R][GATE_P][28] (each pixel's 27 taps); dynamic: wos [GATE_R][3][C]
// and hos [GATE_P][3][C] (the tile's rows of wout and pixels of hout,
// copied by cp.async, every copy in flight at once)
template <typename T, int V>
__global__ void __launch_bounds__(GATE_NT, 2) fusion_gate(Gate p) {
  // rows of a and b a thread loads at once: a pixel's eight rows in
  // bfloat16 (64 bytes in flight a thread), four in float32
  constexpr int GATE_U = sizeof(T) == 2 ? 8 : 4;
  constexpr int HR = GATE_R + 4, HP = GATE_P + 4, CR = GATE_R + 2, CPX = GATE_P + 2;
  __shared__ float cps[6][HR][HP];
  __shared__ float cs[3][CR][CPX];
  __shared__ __align__(16) float p27[GATE_R][GATE_P][28];
  extern __shared__ __align__(16) float wos[];
  const int rows = p.rows;
  const int x0 = blockIdx.x * GATE_P, y0 = blockIdx.y * rows, bi = blockIdx.z;
  const int H = p.H, W = p.W, C = p.C;
  const T* cp = (const T*)p.cp;
  float* hos = wos + GATE_R * 3 * C;
  {
    // segment sg: wout row (k, y0 + r) for sg < 3 GATE_R, else hout pixel
    // (k, x0 + px); a whole warp a segment, its lanes along C (a block of
    // fewer than 32 threads: each thread every segment)
    const bool warps = blockDim.x >= 32;
    const int lane = warps ? threadIdx.x % 32 : threadIdx.x;
    const int lanes = warps ? 32 : blockDim.x, nw = warps ? blockDim.x / 32 : 1;
    for (int sg = warps ? threadIdx.x / 32 : 0; sg < 3 * (rows + GATE_P); sg += nw) {
      const bool wrow = sg < 3 * rows;
      const int i = wrow ? sg / 3 : (sg - 3 * rows) / 3, k = sg % 3;
      const int n = wrow ? y0 + i : x0 + i, N = wrow ? H : W;
      const bool in = n < N;
      const float* from = wrow ? p.wout + (((long long)bi * 3 + k) * H + (in ? n : 0)) * C
                               : p.hout + (((long long)bi * 3 + k) * W + (in ? n : 0)) * C;
      float* dst = (wrow ? wos : hos) + (i * 3 + k) * C;
      if (C % 4 == 0) {
        for (int j = lane; j < C / 4; j += lanes) cp_async16(dst + 4 * j, from + 4 * j, in);
      } else {
        for (int j = lane; j < C; j += lanes) dst[j] = in ? from[j] : 0.0f;
      }
    }
    cp_async_commit();
  }
  // the C pools around the tile (2-pixel halo), zero outside the image
#pragma unroll 4
  for (int e = threadIdx.x; e < 6 * HR * HP; e += blockDim.x) {
    const int m = e / (HR * HP), i = (e / HP) % HR, j = e % HP;
    if (i >= rows + 4) continue;
    const int yy = y0 + i - 2, xx = x0 + j - 2;
    cps[m][i][j] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                       ? to_f<T>(cp[(((long long)bi * 6 + m) * H + yy) * W + xx])
                       : 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();
  // c_att[k] = conv1 of (cp[2k], cp[2k+1]) over (H, W), zero padded, with
  // a 1-pixel halo, rounded to the compute type (the plain version's p27)
  for (int e = threadIdx.x; e < 3 * CR * CPX; e += blockDim.x) {
    const int k = e / (CR * CPX), i = (e / CPX) % CR, j = e % CPX;
    if (i >= rows + 2) continue;
    const int yy = y0 + i - 1, xx = x0 + j - 1;
    float v = 0.0f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float* w = p.c1w + k * 18;
      float acc = 0.0f;
      for (int ch = 0; ch < 2; ++ch)
        for (int ii = 0; ii < 3; ++ii)
          for (int jj = 0; jj < 3; ++jj)
            acc = fmaf(cps[2 * k + ch][i + ii][j + jj], w[ch * 9 + ii * 3 + jj], acc);
      v = to_f<T>(from_f<T>(acc + p.cb[3 * k]));
    }
    cs[k][i][j] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < GATE_R * GATE_P * 28; e += blockDim.x) {
    const int r = e / (GATE_P * 28), px = (e / 28) % GATE_P, tap = e % 28;
    if (r >= rows) continue;
    const int k = tap / 9, i = (tap % 9) / 3, j = tap % 3;
    p27[r][px][tap] = tap < 27 ? cs[k][r + i][px + j] : 0.0f;
  }
  __syncthreads();

  const int G = C / V, t = threadIdx.x;
  if (t >= p.plg * G) return;
  const int pl = t / G, c0 = (t % G) * V;
  const T* a = (const T*)p.a;
  const T* b = (const T*)p.b;
  T* out = (T*)p.out;
  const T* k1 = (const T*)p.k1blk;
  float kt[27][V];
#pragma unroll
  for (int tap = 0; tap < 27; ++tap)
#pragma unroll
    for (int v = 0; v < V; ++v) kt[tap][v] = to_f<T>(k1[(long long)tap * 3 * C + (tap / 9) * C + c0 + v]);
  const int nr = min(rows, H - y0), npx = min(GATE_P, W - x0);
  // interior blocks run the rows with no border code and no bounds checks:
  // whole items of GATE_U rows
  const bool edge =
      y0 == 0 || y0 + rows >= H || x0 == 0 || x0 + GATE_P >= W || rows % GATE_U != 0;
  if (edge) {
    gate_items<T, V, GATE_U, true>(p, kt, &p27[0][0][0], wos, hos, bi, x0, y0, nr, npx, pl, c0);
  } else {
    gate_items<T, V, GATE_U, false>(p, kt, &p27[0][0][0], wos, hos, bi, x0, y0, nr, npx, pl, c0);
  }
}

// ---- launches ---------------------------------------------------------------

bool aligned_to(const void* ptr, int bytes) { return ((unsigned long long)ptr % bytes) == 0; }

template <typename T, int V>
int pools_v(const void* a, const void* b, void* cp, float* hp, void* wp, const CwLayout& q,
            int B, int H, int W, int C, cudaStream_t s) {
  constexpr int S = sizeof(T) == 2 ? 4 : 2;
  const size_t smem = std::max(sizeof(T) * 2 * 3 * q.p * C, sizeof(float) * 6 * q.pl * C);
  if (set_smem(pools_cw<T, V, S>, smem)) return -1;
  pools_cw<T, V, S><<<dim3(H, B), (q.nt + 31) / 32 * 32, smem, s>>>(
      (const T*)a, (const T*)b, (T*)cp, (T*)wp, H, W, C, q.pl);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long cols = (long long)W * (C / V), per = H_NT / H_ROWG;
  pools_h<T, V><<<dim3((unsigned)((cols + per - 1) / per), B), H_NT, 0, s>>>(
      (const T*)a, (const T*)b, hp, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int gate_v(const Gate& g, int B, cudaStream_t s) {
  // wos and hos, with the static arrays (42.2 KB) past the 48 KB a block
  // has without asking
  const size_t smem = sizeof(float) * (GATE_R + GATE_P) * 3 * g.C;
  if (smem + 43 * 1024 > (size_t)kMaxSmem) return -1;
  cudaFuncSetAttribute(fusion_gate<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  fusion_gate<T, V><<<dim3((g.W + GATE_P - 1) / GATE_P, (g.H + g.rows - 1) / g.rows, B),
                      g.plg * (g.C / V), smem, s>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  a, b (B, H, W, C); cp (B, 6, H, W) and wp
// (B, 6, H, C) in a's type, hp (B, 6, W, C) float32.  Two launches:
// pools_cw (C and W pools, a block a row), then pools_h (H pools, a thread
// a column).  Returns cudaGetLastError() after them, or -1 for refused
// arguments (more than 384 channel groups a pixel, more than 65,535
// images, a chunk's stage past shared memory).
extern "C" int fusion_pools_launch(int dtype, const void* a, const void* b, void* cp, void* hp,
                                   void* wp, int B, int H, int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || B > 65535 || (dtype != 0 && dtype != 1)) return -1;
  const int es = dtype == 0 ? 4 : 2;
  const CwLayout q = cw_layout(W, C, es, aligned_to(a, 4 * es) && aligned_to(b, 4 * es));
  if (C / q.v > CW_NT) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return q.v == 4 ? pools_v<float, 4>(a, b, cp, (float*)hp, wp, q, B, H, W, C, s)
                    : pools_v<float, 1>(a, b, cp, (float*)hp, wp, q, B, H, W, C, s);
  return q.v == 4 ? pools_v<bf16, 4>(a, b, cp, (float*)hp, wp, q, B, H, W, C, s)
                  : pools_v<bf16, 1>(a, b, cp, (float*)hp, wp, q, B, H, W, C, s);
}

// The maps and gate launches, after fusion_pools_launch: the pools cp, hp,
// wp; the packed weights c1w, c2w, c3w (3, 18), cb (9,), clb (3, C) float32
// and khw (3, 18, C, C), k1blk (27, 3C) in a's type; scratch holds
// B * (9WC + 9HC) floats (hout, wout, hcorr, wcorr); out (B, H, W, C) in
// a's type.  Returns cudaGetLastError(), or -1 for refused arguments (a
// folded block's shared memory past the card's: float32 C > 250 or so,
// bfloat16 C > 370).
extern "C" int fusion_maps_gate_launch(int dtype, const void* a, const void* b, const void* cp,
                                       const void* hp, const void* wp, const void* c1w,
                                       const void* c2w, const void* c3w, const void* cb,
                                       const void* khw, const void* clb, const void* k1blk,
                                       void* scratch, void* out, int B, int H, int W, int C,
                                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || B > 65535 || (dtype != 0 && dtype != 1)) return -1;
  float* f = (float*)scratch;
  const long long WC = (long long)W * C, HC = (long long)H * C;
  Maps p;
  p.wp = wp;
  p.hp = (const float*)hp;
  p.c2w = (const float*)c2w;
  p.c3w = (const float*)c3w;
  p.cb = (const float*)cb;
  p.clb = (const float*)clb;
  p.khw = khw;
  p.hout = f;
  p.wout = p.hout + B * 3 * WC;
  p.hcorr = p.wout + B * 3 * HC;
  p.wcorr = p.hcorr + B * 6 * WC;
  p.H = H;
  p.W = W;
  p.C = C;
  p.cp16 = (C + 15) / 16 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = B * 3 * ((W + MAP_M - 1) / MAP_M + (H + MAP_M - 1) / MAP_M) *
                   ((3 * C + MAP_O - 1) / MAP_O);
  Gate g;
  g.a = a;
  g.b = b;
  g.k1blk = k1blk;
  g.cp = cp;
  g.c1w = (const float*)c1w;
  g.cb = (const float*)cb;
  g.hout = p.hout;
  g.wout = p.wout;
  g.hcorr = p.hcorr;
  g.wcorr = p.wcorr;
  g.out = out;
  g.H = H;
  g.W = W;
  g.C = C;
  const int es = dtype == 0 ? 4 : 2;
  const bool vec2 = C % 2 == 0 && aligned_to(a, 2 * es) && aligned_to(b, 2 * es) &&
                    aligned_to(out, 2 * es);
  const int G = vec2 ? C / 2 : C;
  if (G > GATE_NT) return -1;
  g.plg = std::max(1, std::min(GATE_NT / G, GATE_P));
  // 16-row blocks where they make two blocks an SM (the 1080p frame), else
  // 8 (a 192^2 tile: 288 blocks)
  const long long blocks16 = (long long)B * ((W + GATE_P - 1) / GATE_P) * ((H + 15) / 16);
  g.rows = blocks16 >= 2 * 132 ? 16 : 8;
  int err;
  if (dtype == 0) {
    const size_t smem = MapLayout<float>::bytes(C, p.cp16);
    if (set_smem(fusion_maps<float>, smem)) return -1;
    fusion_maps<float><<<nblk, MAP_NT, smem, s>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
    return vec2 ? gate_v<float, 2>(g, B, s) : gate_v<float, 1>(g, B, s);
  }
  const size_t smem = MapLayout<bf16>::bytes(C, p.cp16);
  if (set_smem(fusion_maps<bf16>, smem)) return -1;
  fusion_maps<bf16><<<nblk, MAP_NT, smem, s>>>(p);
  if ((err = (int)cudaGetLastError())) return err;
  return vec2 ? gate_v<bf16, 2>(g, B, s) : gate_v<bf16, 1>(g, B, s);
}
