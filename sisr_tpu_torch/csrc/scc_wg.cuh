// The bfloat16 wgmma phases of scc_block's degenerate windows, shared by
// scc_block.cu (scc_fused_wg, and the split path's reduce and apply blocks)
// and htb_fused.cu (htb_fused_wg, which runs the same attention and then
// LN1 and fc1 on the same tile).  See scc_block.cu for the design: C =
// 180, 6 heads (d = 15), windows of L = 16 (l_base 16), L = 64 (l_base 64)
// or any L that is a multiple of 256 (l_base 64).  A half of the channels
// lies in 96 head-padded slots: channel c at 16 (c / 15) + c % 15, slot 16
// h + 15 zero, so that every head is one 16-deep wgmma slice.  Every
// operand is a K-major tile under the 128-byte swizzle (wgmma.cuh): SW(R,
// K) holds K / 64 blocks of R rows of 128 bytes.
#pragma once

#include "common.cuh"

#include "wgmma.cuh"

#include <cstdint>

namespace {

// the arguments of scc_block_launch, and the window geometry
namespace scc {

constexpr int TOK_A = 128;  // tokens per phase-A1 block
constexpr int NPAT = 18;    // SCA patch taps per token (9 of the mean map, 9 of the max)

struct Args {
  const void* x;
  const void* patches;  // NULL: no SCA
  const void* w9a;
  const void* b9a;
  const void* w9m;
  const void* b9m;
  const void* s1;
  const void* s2;
  const void* wkv;
  const void* bb;
  const void* pmat;
  const float* pb;
  const void* bias;
  const void* proj;
  const void* projb;
  const void* wkvp;   // the wgmma path's packed [w1; w2] and projection, or NULL
  const void* projp;
  void* out;
  int B, Hp, Wp, C, heads, wh, ww, lb;
};

struct Dims {
  int half, L, d, nwh, nww, nwin, nsplit;
  long long part_floats;  // per (window, split)
};

inline Dims dims_of(int B, int Hp, int Wp, int C, int heads, int wh, int ww, int lb) {
  Dims D;
  D.half = C / 2;
  D.L = wh * ww;
  D.d = heads > 0 ? D.half / heads : 0;
  D.nwh = Hp / wh;
  D.nww = Wp / ww;
  D.nwin = B * D.nwh * D.nww;
  D.nsplit = (D.L + TOK_A - 1) / TOK_A;
  D.part_floats = (long long)D.half * D.half + 2LL * lb * D.half;
  return D;
}

// element offset of token l of window `win` in the (B, Hp, Wp, *) maps
__device__ __forceinline__ long long pixel_of(const Args& a, const Dims& D, int win, int l) {
  const int wx = win % D.nww;
  const int wy = (win / D.nww) % D.nwh;
  const int bi = win / (D.nww * D.nwh);
  const int gy = wy * a.wh + l / a.ww, gx = wx * a.ww + l % a.ww;
  return ((long long)bi * a.Hp + gy) * a.Wp + gx;
}

}  // namespace scc

namespace wgs {

using scc::Args;
using scc::Dims;
using scc::NPAT;
using scc::pixel_of;

constexpr int NTW = 256;        // two warpgroups
constexpr int P = 96;           // head-padded slots of a half
constexpr int KX = 2 * P;       // [q | v] slots of the qkv tile, [out_s | out_c] of the out tile
constexpr int TT = 64;          // tokens of a tile (the wgmma M)
constexpr int NPROJ = 192;      // rows of the packed projection (C padded)
constexpr int SPLIT = 256;      // tokens of a reduce block (windows of L >= 256)
constexpr int HEADS = 6, DH = 15, CC = 180, HALF = 90;

constexpr int XA_B = TT * KX * 2;        // qkv tile SW(64, 192); later the out tile
constexpr int QT_B = P * TT * 2;         // q^T SW(96, 64) (rows: slots, K: tokens)
constexpr int VT_B = P * TT * 2;         // v^T
constexpr int KT_B = P * TT * 2;         // k^T
constexpr int PM_B = TT * TT * 2;        // pooling tile SW(64, 64)
constexpr int WKV_B = P * KX * 2;        // packed [w1; w2] SW(96, 192)
constexpr int PROJ_B = NPROJ * KX * 2;   // packed projection SW(192, 192)
constexpr int G_B = P * 128 * 2;         // gram image SW(96, 128)
constexpr int KPVP_B = 2 * TT * P * 4;   // KP and VP in float32, 64 x 96 each
constexpr int SCA_B = 24 * CC * 2;       // w9a, w9m, b9a, b9m, s1 and s2 of two images
constexpr int XS_B = TT * CC * 2 + TT * NPAT * 2 + 256;   // the tile's x and patch rows as loaded
constexpr int META_B = 1024;             // the tile's pixels and images
__host__ __device__ constexpr int ball_k(int lb) { return (2 * (16 + lb) + 63) / 64 * 64; }
__host__ __device__ constexpr int ball_b(int lb) { return P * ball_k(lb) * 2; }
__host__ __device__ constexpr int bias_k(int lb) { return (HEADS * lb + 63) / 64 * 64; }
__host__ __device__ constexpr int bias_b(int lb) { return TT * bias_k(lb) * 2; }
constexpr int OPS_B = G_B + ball_b(64);               // a window's operands (split path)
constexpr int PART_F = P * P + 2 * TT * P;            // a split's G, KP, VP partials

// byte offset of element (r, k) of SW(R, K)
__device__ __forceinline__ int sw(int R, int r, int k) {
  return (k >> 6) * R * 128 + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) + (k & 7) * 2;
}
__device__ __forceinline__ void put(unsigned char* t, int R, int r, int k, float v) {
  *reinterpret_cast<bf16*>(t + sw(R, r, k)) = __float2bfloat16(v);
}
// descriptor of rows [r0, r0 + 64) (A) or [r0, r0 + N) (B), 16-deep slice s
__device__ __forceinline__ uint64_t desc(uint32_t base, int R, int r0, int s) {
  return sw128_desc(base + (s >> 2) * R * 128 + r0 * 128 + (s & 3) * 32);
}
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ int slot(int c) { return 16 * (c / DH) + c % DH; }
// the channel of a half at slot s, or -1 for a pad slot
__device__ __forceinline__ int chan(int s) { return (s & 15) < DH ? DH * (s >> 4) + (s & 15) : -1; }
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ void zero(unsigned char* p, int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += NTW)
    reinterpret_cast<uint4*>(p)[e] = make_uint4(0, 0, 0, 0);
}
// a packed (N, K) row-major bfloat16 matrix into SW(N, K), 16-byte copies
__device__ __forceinline__ void stage_packed(unsigned char* dst, const void* src, int N, int K) {
  const int cpr = K / 8;
  const bf16* s = (const bf16*)src;
  for (int e = threadIdx.x; e < N * cpr; e += NTW) {
    const int n = e / cpr, c = e % cpr;
    cp_async16(dst + (c >> 3) * N * 128 + n * 128 + (((c & 7) ^ (n & 7)) << 4),
               s + (long long)n * K + c * 8, true);
  }
}
__device__ __forceinline__ void copy_flat(unsigned char* dst, const unsigned char* src, int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += NTW) cp_async16(dst + 16 * e, src + 16 * e, true);
}
// rows [l0, l0 + 64) of the position bias (L, 6 lb) into SW(64, bias_k) (rows
// past L: row % L, the windows of a 16-token tile repeat it)
__device__ __forceinline__ void stage_bias(unsigned char* dst, const bf16* bias, int L, int lb,
                                           int l0) {
  const int cpr = HEADS * lb / 8;
  for (int e = threadIdx.x; e < TT * cpr; e += NTW) {
    const int t = e / cpr, c = e % cpr;
    cp_async16(dst + (c >> 3) * TT * 128 + t * 128 + (((c & 7) ^ (t & 7)) << 4),
               bias + (long long)((l0 + t) % L) * (HEADS * lb) + c * 8, true);
  }
}
// The tile's tokens: pix(t), the pixel of token t or -1 past the map, once
// per tile into meta (64 pixels, then 64 images), by the first 64 threads
struct Meta {
  long long pix[TT];
  int img[TT];
};
template <typename Pix>
__device__ __forceinline__ void tile_meta(const Args& a, Pix pix, Meta* meta) {
  if (threadIdx.x < TT) {
    const long long p = pix(threadIdx.x);
    meta->pix[threadIdx.x] = p;
    meta->img[threadIdx.x] = p < 0 ? 0 : (int)(p / ((long long)a.Hp * a.Wp));
  }
}
// x and patch rows of the tile's tokens into xs by 8- and 4-byte cp.async
// (zero past the map): every load in flight at once, none on a thread's
// critical path; issue_rows the x rows alone
__device__ __forceinline__ void issue_rows(const Args& a, const Meta* meta, unsigned char* xs) {
  const bf16* x = (const bf16*)a.x;
  for (int e = threadIdx.x; e < TT * (CC / 4); e += NTW) {
    const int t = e / (CC / 4), c = e % (CC / 4);
    const long long p = meta->pix[t];
    cp_async8(xs + t * (CC * 2) + c * 8, p < 0 ? x : x + p * CC + c * 4, p >= 0);
  }
}
__device__ __forceinline__ void issue_x(const Args& a, const Meta* meta, unsigned char* xs) {
  issue_rows(a, meta, xs);
  if (a.patches == nullptr) return;
  const bf16* pat = (const bf16*)a.patches;
  unsigned char* ps = xs + TT * CC * 2;
  for (int e = threadIdx.x; e < TT * (NPAT / 2); e += NTW) {
    const int t = e / (NPAT / 2), c = e % (NPAT / 2);
    const long long p = meta->pix[t];
    cp_async4(ps + t * (NPAT * 2) + c * 4, p < 0 ? pat : pat + p * NPAT + c * 2, p >= 0);
  }
}
// the SCA weights by 8-byte cp.async: rows of C, w9a (9), w9m (9), b9a,
// b9m, then s1 and s2 of the tile's first and of its last image
__device__ __forceinline__ void issue_sca(const Args& a, const Meta* meta, unsigned char* sca) {
  if (a.patches == nullptr) return;
  const int i0 = meta->img[0], i1 = meta->img[TT - 1];
  for (int e = threadIdx.x; e < 24 * (CC / 4); e += NTW) {
    const int r = e / (CC / 4), c = e % (CC / 4);
    const bf16* src = r < 9 ? (const bf16*)a.w9a + r * CC
                      : r < 18 ? (const bf16*)a.w9m + (r - 9) * CC
                      : r == 18 ? (const bf16*)a.b9a
                      : r == 19 ? (const bf16*)a.b9m
                      : (const bf16*)(r % 2 ? a.s2 : a.s1) + (long long)(r < 22 ? i0 : i1) * CC;
    cp_async8(sca + r * (CC * 2) + c * 8, src + c * 4, true);
  }
}
// the pooling tile: rows m of window w (16 w + m for 16-token windows, four
// to a tile), columns the tile's tokens: pmat[m][l0 + t] where token t is
// in the row's window, else 0.  Windows of 64 tokens and more: rows of
// pmat by 16-byte cp.async (zero past l_base).  16-token windows: after
// zero_pool and a barrier, the diagonal blocks.
__device__ __forceinline__ void zero_pool(unsigned char* pm, int L) {
  if (L < TT) zero(pm, PM_B);
}
__device__ __forceinline__ void stage_pool(unsigned char* pm, const bf16* pmat, int L, int lb,
                                           int l0) {
  if (L < TT) {
    if (threadIdx.x < L * L) {
      const bf16 v = pmat[threadIdx.x];
      const int m = threadIdx.x / L, l = threadIdx.x % L;
      for (int w = 0; w < TT / L; ++w)
        *reinterpret_cast<bf16*>(pm + sw(TT, w * L + m, w * L + l)) = v;
    }
    return;
  }
  for (int e = threadIdx.x; e < TT * 8; e += NTW) {
    const int r = e >> 3, c = e & 7;
    cp_async16(pm + sw(TT, r, 8 * c), r < lb ? pmat + (long long)r * L + l0 + 8 * c : pmat,
               r < lb);
  }
}

// qkv = x + SCA(x), rounded to bfloat16 as both references round it, for
// the tile's 64 tokens from xs (issue_x's rows, landed) and sca
// (issue_sca's rows, landed): into Xa ([q | v] slots of each token) and,
// unless null, Qt and Vt (slot rows, token columns).  180 threads, a
// channel pair and 32 tokens each, the pair's SCA weights in registers.
// Tokens past the map stay zero.  Ends with a barrier.
__device__ void qkv_tile(const Args& a, const unsigned char* sca, const Meta* meta,
                         const unsigned char* xs, unsigned char* Xa, unsigned char* Qt,
                         unsigned char* Vt) {
  zero(Xa, XA_B);
  if (Qt != nullptr) {
    zero(Qt, QT_B);
    zero(Vt, VT_B);
  }
  __syncthreads();
  if (threadIdx.x < CC) {
    const int cp = threadIdx.x % (CC / 2), t0 = threadIdx.x / (CC / 2) * (TT / 2), c = 2 * cp;
    const bool on = a.patches != nullptr;
    const auto w2 = [&](int r) {
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sca + (r * CC + c) * 2));
    };
    float2 wa[9], wm[9], ba, bm, g1[2], g2[2];
    if (on) {
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        wa[i] = w2(i);
        wm[i] = w2(9 + i);
      }
      ba = w2(18);
      bm = w2(19);
      g1[0] = w2(20);
      g2[0] = w2(21);
      g1[1] = w2(22);
      g2[1] = w2(23);
    }
    const bool isv = c >= HALF;
    const int s0 = slot(c - (isv ? HALF : 0)), s1 = slot(c + 1 - (isv ? HALF : 0));
    const int k0 = (isv ? P : 0) + s0, k1 = (isv ? P : 0) + s1;
    unsigned char* T = isv ? Vt : Qt;
    const int i0 = meta->img[0];
    // four tokens at a time, so that their loads and products overlap
    for (int t = t0; t < t0 + TT / 2; t += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tt = t + u;
        float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + (tt * CC + c) * 2));
        if (on) {
          const __nv_bfloat162* pt =
              reinterpret_cast<const __nv_bfloat162*>(xs + TT * CC * 2 + tt * NPAT * 2);
          float pv[NPAT];
#pragma unroll
          for (int j = 0; j < NPAT / 2; ++j) {
            const float2 f = __bfloat1622float2(pt[j]);
            pv[2 * j] = f.x;
            pv[2 * j + 1] = f.y;
          }
          float2 sa = ba, sm2 = bm;
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            sa.x = fmaf(pv[i], wa[i].x, sa.x);
            sa.y = fmaf(pv[i], wa[i].y, sa.y);
            sm2.x = fmaf(pv[9 + i], wm[i].x, sm2.x);
            sm2.y = fmaf(pv[9 + i], wm[i].y, sm2.y);
          }
          const int im = meta->img[tt] == i0 ? 0 : 1;
          v.x += (leaky_f(sa.x, 0.2f) * g1[im].x + leaky_f(sm2.x, 0.2f) * g2[im].x) * 0.5f;
          v.y += (leaky_f(sa.y, 0.2f) * g1[im].y + leaky_f(sm2.y, 0.2f) * g2[im].y) * 0.5f;
        }
        if (meta->pix[tt] < 0) continue;   // past the map: the rows stay zero
        const bf16 qx = __float2bfloat16(v.x), qy = __float2bfloat16(v.y);
        *reinterpret_cast<bf16*>(Xa + sw(TT, tt, k0)) = qx;
        *reinterpret_cast<bf16*>(Xa + sw(TT, tt, k1)) = qy;
        if (Qt != nullptr) {
          *reinterpret_cast<bf16*>(T + sw(P, s0, tt)) = qx;
          *reinterpret_cast<bf16*>(T + sw(P, s1, tt)) = qy;
        }
      }
    }
  }
  fence_proxy_async();
  __syncthreads();
}

// accumulator i of a thread in its warpgroup's 64 x N tile: row
// 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
__device__ __forceinline__ int acc_row(int i) {
  const int lt = threadIdx.x & 127;
  return 16 * (lt >> 5) + ((lt & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1); }

template <int N>
__device__ __forceinline__ void settle(float (&acc)[N]) {
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(acc[i]);
}

// k = qkv @ [w1; w2] + bb, rounded to bfloat16, into Kt (slot rows, token
// columns; zero in the pad slots): warpgroup g the slots [48 g, 48 g + 48)
__device__ void k_tile(const Args& a, uint32_t xa, uint32_t wkv, unsigned char* Kt) {
  const int g = threadIdx.x >> 7;
  float acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KX / 16; ++s)
    wgmma_m64nNk16<48>(acc, desc(xa, TT, 0, s), desc(wkv, P, 48 * g, s));
  settle(acc);
  const bf16* bb = (const bf16*)a.bb;
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int n = 48 * g + acc_col(i), d = chan(n);
    put(Kt, P, n, acc_row(i), d < 0 ? 0.0f : acc[i] + __bfloat162float(bb[d]));
  }
}

// pool @ k (warpgroup 0) or pool @ v (warpgroup 1) over the tile's tokens,
// added into acc
__device__ __forceinline__ void pool_tile(float (&acc)[48], uint32_t pm, uint32_t kt,
                                          uint32_t vt) {
  const int g = threadIdx.x >> 7;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < TT / 16; ++s)
    wgmma_m64nNk16<96>(acc, desc(pm, TT, 0, s), desc(g ? vt : kt, P, 0, s));
  settle(acc);
}
// the gram q^T k over the token slices [s0, s0 + ns) of the tile, added
// into acc: warpgroup 0 rows (q slots) 0..63, warpgroup 1 rows 32..95
__device__ __forceinline__ void gram_tile(float (&acc)[48], uint32_t qt, uint32_t kt, int s0,
                                          int ns) {
  const int g = threadIdx.x >> 7;
  wgmma_fence();
  for (int s = s0; s < s0 + ns; ++s)
    wgmma_m64nNk16<96>(acc, desc(qt, P, 32 * g, s), desc(kt, P, 0, s));
  settle(acc);
}
// the gram as out_c's operand: rows q slots c, K k slots d, G / L rounded
// as the plain version rounds it (the product in bfloat16, then / L)
__device__ __forceinline__ void put_gram(const float (&acc)[48], unsigned char* gimg, int L) {
  const int g = threadIdx.x >> 7;
  const float invl = 1.0f / (float)L;
#pragma unroll
  for (int i = 0; i < 48; ++i) {
    const int r = 32 * g + acc_row(i);
    if (g == 0 ? r < 64 : r >= 64) put(gimg, P, r, acc_col(i), rbf(acc[i]) * invl);
  }
}
// KP (warpgroup 0) or VP (warpgroup 1): rounded to bfloat16 as the plain
// einsum's result, then + pb in float32, into kpvp (rows m, 96 slots)
__device__ __forceinline__ void put_pool(const float (&acc)[48], float* kpvp, float pb) {
  float* dst = kpvp + (threadIdx.x >> 7) * TT * P;
#pragma unroll
  for (int i = 0; i < 48; ++i) dst[acc_row(i) * P + acc_col(i)] = rbf(acc[i]) + pb;
}

// The spatial operand of one window, SW(96, ball_k): row 16 h + i (head h,
// slot i), K [M hi (16) | VP hi (lb) | M lo (16) | VP lo (lb)], with M =
// samehead(KP^T VP) / d; each float32 value v as hi = bf16(v) and lo =
// bf16(v - hi), so that two products into float32 accumulators keep ~16
// bits of it (the plain version holds M and VP in float32).
template <int LB>
__device__ void build_ball(const float* KP, const float* VP, unsigned char* ball) {
  constexpr int nk = 16 + LB;
  // M: row n = 16 h + i, column k, both slots of head h
  for (int e = threadIdx.x; e < P * 16; e += NTW) {
    const int n = e >> 4, k = e & 15, h = n >> 4, i = n & 15;
    float v = 0.0f;
    if (i < DH && k < DH) {
      const float* kp = KP + 16 * h + k;
      const float* vp = VP + n;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < LB; ++m) s[m & 3] = fmaf(kp[m * P], vp[m * P], s[m & 3]);
      v = ((s[0] + s[1]) + (s[2] + s[3])) * (1.0f / (float)DH);
    }
    const float hi = rbf(v);
    put(ball, P, n, k, hi);
    put(ball, P, n, nk + k, v - hi);
  }
  // VP_big: row n, column 16 + m
  for (int e = threadIdx.x; e < P * LB; e += NTW) {
    const int m = e / P, n = e % P;
    const float v = (n & 15) < DH ? VP[m * P + n] : 0.0f;
    const float hi = rbf(v);
    put(ball, P, n, 16 + m, hi);
    put(ball, P, n, nk + 16 + m, v - hi);
  }
}

// out_c = v @ G^T and out_s = q @ M + bias @ VP_big, added into acc:
// warpgroup g takes out_c's slots [48 g, 48 g + 48) (accumulators 0..23)
// and out_s's heads 3 g .. 3 g + 2 (24 + 8 h ..), one 16-slot product a
// head, hi then lo; both warpgroups issue the same sequence, so that no
// wgmma sits on a divergent path
template <int LB>
__device__ __forceinline__ void apply(float (&acc)[48], uint32_t xa, uint32_t gimg, uint32_t ball,
                                      uint32_t bias) {
  constexpr int NB = LB / 16;
  const int g = threadIdx.x >> 7;
  float ac[24], ah[3][8];
#pragma unroll
  for (int i = 0; i < 24; ++i) ac[i] = acc[i];
#pragma unroll
  for (int h = 0; h < 3; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) ah[h][i] = acc[24 + 8 * h + i];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < P / 16; ++s)
    wgmma_m64nNk16<48>(ac, desc(xa, TT, 0, P / 16 + s), desc(gimg, P, 48 * g, s));
#pragma unroll
  for (int hh = 0; hh < 3; ++hh) {
    const int h = 3 * g + hh;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int b0 = part * (NB + 1);
      wgmma_m64nNk16<16>(ah[hh], desc(xa, TT, 0, h), desc(ball, P, 16 * h, b0));
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_m64nNk16<16>(ah[hh], desc(bias, TT, 0, h * NB + j),
                           desc(ball, P, 16 * h, b0 + 1 + j));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    fence_operand(ac[i]);
    acc[i] = ac[i];
  }
#pragma unroll
  for (int h = 0; h < 3; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fence_operand(ah[h][i]);
      acc[24 + 8 * h + i] = ah[h][i];
    }
}
// [out_s | out_c] rounded to bfloat16 into the out tile (token rows; out_s
// at slots 0..95, out_c at 96..191), from apply's accumulators
__device__ __forceinline__ void put_out(const float (&acc)[48], unsigned char* ot) {
  const int g = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < 24; ++i) put(ot, TT, acc_row(i), P + 48 * g + acc_col(i), acc[i]);
#pragma unroll
  for (int h = 0; h < 3; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      put(ot, TT, acc_row(i), 16 * (3 * g + h) + acc_col(i), acc[24 + 8 * h + i]);
}
// out = [out_s | out_c] @ proj + proj_b: warpgroup g the output channels
// [96 g, 96 g + 96) (rows past 180 of the pack are zero); the rows go back
// over the out tile (proj_rows, 180 bfloat16 a token; ends with a barrier)
// and leave from there, 8 bytes a thread (store_rows)
__device__ __forceinline__ void proj_rows(const Args& a, unsigned char* ot_ptr, uint32_t proj) {
  const uint32_t ot = saddr(ot_ptr);
  const int n0 = 96 * (threadIdx.x >> 7);
  float acc[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KX / 16; ++s)
    wgmma_m64nNk16<96>(acc, desc(ot, TT, 0, s), desc(proj, NPROJ, n0, s));
  settle(acc);
  __syncthreads();   // both warpgroups' products have read the out tile: rows over it
  const bf16* pbv = (const bf16*)a.projb;
  unsigned char* rows = ot_ptr;
#pragma unroll
  for (int i = 0; i < 48; i += 2) {
    const int n = n0 + acc_col(i);
    if (n >= CC) continue;
    *reinterpret_cast<__nv_bfloat162*>(rows + (acc_row(i) * CC + n) * 2) = __floats2bfloat162_rn(
        acc[i] + __bfloat162float(pbv[n]), acc[i + 1] + __bfloat162float(pbv[n + 1]));
  }
  __syncthreads();
}
__device__ __forceinline__ void store_rows(const Args& a, const unsigned char* rows,
                                           const Meta* meta) {
  // to out, 8 bytes a thread, consecutive threads on a token's consecutive bytes
  bf16* out = (bf16*)a.out;
  for (int e = threadIdx.x; e < TT * (CC / 4); e += NTW) {
    const int t = e / (CC / 4), c = e % (CC / 4);
    const long long p = meta->pix[t];
    if (p >= 0)
      *reinterpret_cast<uint2*>(out + p * CC + c * 4) =
          *reinterpret_cast<const uint2*>(rows + t * (CC * 2) + c * 8);
  }
}
__device__ __forceinline__ void proj_tile(const Args& a, unsigned char* ot_ptr, uint32_t proj,
                                          const Meta* meta) {
  proj_rows(a, ot_ptr, proj);
  store_rows(a, ot_ptr, meta);
}

__host__ __device__ constexpr int xs_ball_b(int lb) { return ball_b(lb) > XS_B ? ball_b(lb) : XS_B; }
__host__ __device__ constexpr int smem_fused(int lb) {
  return XA_B + bias_b(lb) + PM_B + G_B + xs_ball_b(lb) + KPVP_B + QT_B + VT_B + KT_B + META_B +
         1024;
}
static_assert(smem_fused(64) <= 232448, "the 64-token window's block");
static_assert(WKV_B <= KPVP_B && PROJ_B <= KPVP_B + QT_B + VT_B + KT_B && SCA_B <= G_B &&
                  sizeof(Meta) <= META_B,
              "aliased regions");

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  const uint32_t raw = saddr(p);
  return p + (((raw + 1023u) & ~1023u) - raw);
}

// The regions of a 64-token tile's attention in shared memory, each
// 1024-byte aligned (meta 8-byte): Xa the qkv tile, then the out tile; Bs
// the bias rows; Pm the pooling tile; Gi the SCA weights, then the gram
// image; Ba the x and patch rows, then Ball; U [w1; w2], then KP and VP;
// Qt, Vt, Kt q^T, v^T, k^T; meta the tile's tokens.  The caller stages
// the projection over U, Qt and Vt after the attention: they lie in a row.
struct Tile {
  unsigned char *Xa, *Bs, *Pm, *Gi, *Ba, *U, *Qt, *Vt, *Kt;
  Meta* meta;
};

// The attention of the 64-token tile blockIdx.x (four 4x4 windows or one
// 8x8) on chip: qkv, k, the gram, KP, VP, M, the spatial and channel
// outputs, up to [out_s | out_c] in the out tile over Xa.  Ends after
// put_out, without a barrier; the projection is the caller's.
template <int LB>
__device__ __forceinline__ void attend_tile(const Args& a, const Dims& D, const Tile& r) {
  float* kpvp = (float*)r.U;
  constexpr int L = LB;                 // the window's tokens (l_base = L)
  constexpr int NW = TT / L;            // windows of a tile
  const long long unit = blockIdx.x;

  zero_pool(r.Pm, L);
  tile_meta(a, [&](int t) -> long long {
    const long long win = unit * NW + t / L;
    return win < D.nwin ? pixel_of(a, D, (int)win, t % L) : -1;
  }, r.meta);
  __syncthreads();
  issue_x(a, r.meta, r.Ba);
  issue_sca(a, r.meta, r.Gi);
  cp_async_commit();
  stage_bias(r.Bs, (const bf16*)a.bias, L, LB, 0);
  stage_packed(r.U, a.wkvp, P, KX);
  stage_pool(r.Pm, (const bf16*)a.pmat, L, LB, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  qkv_tile(a, r.Gi, r.meta, r.Ba, r.Xa, r.Qt, r.Vt);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  k_tile(a, saddr(r.Xa), saddr(r.U), r.Kt);
  fence_proxy_async();
  __syncthreads();
  {
    float acc[48];
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[i] = 0.0f;
    pool_tile(acc, saddr(r.Pm), saddr(r.Kt), saddr(r.Vt));
    __syncthreads();   // [w1; w2] is read: KP and VP go over it
    put_pool(acc, kpvp, *a.pb);
  }
  float acc[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = 0.0f;
  for (int w = 0; w < NW; ++w) {
    {
      float gacc[48];
#pragma unroll
      for (int i = 0; i < 48; ++i) gacc[i] = 0.0f;
      gram_tile(gacc, saddr(r.Qt), saddr(r.Kt), w * L / 16, L / 16);
      put_gram(gacc, r.Gi, L);
    }
    __syncthreads();   // KP and VP are written
    build_ball<LB>(kpvp + w * L * P, kpvp + TT * P + w * L * P, r.Ba);
    fence_proxy_async();
    __syncthreads();
    if (NW == 1) {
      apply<LB>(acc, saddr(r.Xa), saddr(r.Gi), saddr(r.Ba), saddr(r.Bs));
    } else {
      // the rows of window w are warp w's: keep its rows of this product
      float tmp[48];
#pragma unroll
      for (int i = 0; i < 48; ++i) tmp[i] = 0.0f;
      apply<LB>(tmp, saddr(r.Xa), saddr(r.Gi), saddr(r.Ba), saddr(r.Bs));
      if (((threadIdx.x & 127) >> 5) == w) {
#pragma unroll
        for (int i = 0; i < 48; ++i) acc[i] = tmp[i];
      }
    }
    __syncthreads();   // the window's operands are read
  }
  put_out(acc, r.Xa);
}

}  // namespace wgs

}  // namespace
