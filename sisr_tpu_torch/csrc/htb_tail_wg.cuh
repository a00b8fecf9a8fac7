// The bfloat16 wgmma pieces of the HTB tail at the model's widths (C = 180,
// Ch = 360), shared by htb_tail.cu (htb_tail_fc1_wg, htb_tail_out_wg) and
// htb_fused.cu (htb_fused_wg's LN1 and fc1, htb_fused_tail_wg): x = s +
// LN1(a), fc1's product and its gelu epilogue, and the tail's body (the
// depthwise conv, fc2, LN2 and the statistics).  See htb_tail.cu for the
// design.  Operands are K-major tiles under the 128-byte swizzle
// (wgmma.cuh): SW(R, K) holds K / 64 blocks of R rows of 128 bytes.  W1
// and W2 arrive packed (ops/kernels/ffn.py::pack_w1, pack_w2).  Every
// value is rounded to bfloat16 where the plain version rounds it: x = s +
// LN1(a), fc1's product, + b1, gelu; the depthwise conv (+ dwb), gelu, h2;
// fc2's product, + b2, LN2, out.
#pragma once

#include "common.cuh"

#include "wgmma.cuh"

#include <cstdint>

namespace {

namespace wgt {

constexpr int NTW = 256;            // two warpgroups
constexpr int CC = 180, CH = 360;   // the model's widths
constexpr int KC = 192;             // C padded to the K step
constexpr int NH = 184;             // a half of the hidden channels (180) or C, padded
constexpr int TM = 64;              // fc1: pixels a tile (the wgmma M)
constexpr int W1_B = 2 * NH * KC * 2;   // packed W1 SW(368, 192): 141,312 bytes
constexpr int X_B = TM * KC * 2;        // an x tile SW(64, 192)
constexpr int PAR1_B = (2 * CC + CH) * 2;   // ln1 scale and bias, b1
// tail: an 8 x 16 output tile, h over its 12 x 20 halo, hidden channels in
// chunks of 64 (one K block of fc2) through two stages
constexpr int TH = 8, TW = 16, PH = TH + 4, PW = TW + 4, NPIX = PH * PW, NCEN = TH * TW;
constexpr int HC = 64, NCH = (CH + HC - 1) / HC, STAGES = 2;
constexpr int W2C_B = NH * HC * 2;      // a W2 chunk SW(184, 64): 23,552 bytes
constexpr int HALO_B = NPIX * HC * 2;   // h on the halo, 128 bytes a pixel
constexpr int TAP_B = 26 * HC * 2;      // the chunk's 25 taps and dwb
constexpr int STAGE_B = (W2C_B + HALO_B + TAP_B + 1023) / 1024 * 1024;
constexpr int H2_B = NCEN * HC * 2;     // h2 SW(128, 64), fc2's A
constexpr int XC_B = NCEN * CC * 2;     // the residual x of the tile's pixels
constexpr int PAR_B = 3 * CC * 2 + 32;  // b2, ln2 scale and bias
constexpr int SMEM2 = STAGES * STAGE_B + H2_B + XC_B + PAR_B + 1024;
static_assert(SMEM2 <= 232448, "shared memory");
static_assert(NCEN * NH * 4 + 16 * CC * 4 <= STAGES * STAGE_B,
              "y and the statistics partials alias the stages");

__device__ __forceinline__ int sw(int R, int r, int k) {
  return (k >> 6) * R * 128 + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) + (k & 7) * 2;
}
__device__ __forceinline__ uint64_t desc(uint32_t base, int R, int r0, int s) {
  return sw128_desc(base + (s >> 2) * R * 128 + r0 * 128 + (s & 3) * 32);
}
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }
// a pair rounded to bfloat16 by one paired conversion (twice the rate of two)
__device__ __forceinline__ float2 rbf2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}
// two values that are bfloat16 already (rbf) as a pair: their high halves
__device__ __forceinline__ __nv_bfloat162 pack_bf(float lo, float hi) {
  const unsigned u = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  const uint32_t raw = saddr(p);
  return p + (((raw + 1023u) & ~1023u) - raw);
}
__device__ __forceinline__ int acc_row(int i) {
  const int lt = threadIdx.x & 127;
  return 16 * (lt >> 5) + ((lt & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1); }
// float max through the integer orders: non-negative values grow as ints,
// negative ones shrink as unsigned ints
__device__ __forceinline__ void atomic_max_f(float* p, float v) {
  if (v >= 0.0f)
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

// One band of rows [r0, r1) of every image: fc1 covers its h rows [hr0,
// hr1) (the band and the depthwise conv's 2-row halo, inside the map),
// which hbuf holds band-relative; xbuf holds x of the band's rows.
struct Tail {
  const bf16 *attn, *sc, *ln1s, *ln1b, *w1p, *b1, *dw, *dwb, *w2p, *b2, *ln2s, *ln2b;
  bf16 *out, *hbuf, *xbuf;
  float *cmean, *cmax, *ssum, *smax;
  long long a_bs, a_rs;
  int B, H, W, r0, r1, hr0, hr1;
};

// x = s + LN1(a) of 64 pixels: their a and s rows (180 bfloat16 each) at
// ar0 and sr0, live(p) whether pixel p is one (x = 0 for the others),
// xoff(p) where its x goes in xbuf (-1: nowhere), par LN1's scale and
// bias.  One warp a pixel, four pixels at a time, into the tile SW(64,
// 192) (zero in channels 180..191) and to xbuf: the tail's residual.
template <typename Live, typename XOff>
__device__ __forceinline__ void build_x(const bf16* ar0, const bf16* sr0, Live live, XOff xoff,
                                        const bf16* par, unsigned char* xt, bf16* xbuf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int CPL = KC / 32, G = 4;   // 6 channels a lane, pixels at once
  for (int p0 = warp; p0 < TM; p0 += G * (NTW / 32)) {
    float av[G][CPL], sv[G][CPL], s1[G], s2[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = p0 + u * (NTW / 32);
      const bool ok = live(p);
      s1[u] = s2[u] = 0.0f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        const bool in = ok && c < CC;
        av[u][i] = in ? __bfloat162float(ar0[p * CC + c]) : 0.0f;
        sv[u][i] = in ? __bfloat162float(sr0[p * CC + c]) : 0.0f;
        s1[u] += av[u][i];
        s2[u] += av[u][i] * av[u][i];
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      s1[u] = warp_sum(s1[u]);
      s2[u] = warp_sum(s2[u]);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = p0 + u * (NTW / 32);
      const long long xo = xoff(p);
      const float mean = s1[u] / (float)CC;
      const float rstd = rsqrtf(fmaxf(s2[u] / (float)CC - mean * mean, 0.0f) + 1e-5f);
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        float x = 0.0f;
        if (live(p) && c < CC) {
          const float ln = rbf((av[u][i] - mean) * rstd * __bfloat162float(par[c]) +
                               __bfloat162float(par[CC + c]));
          x = rbf(sv[u][i] + ln);
          if (xo >= 0) xbuf[xo + c] = __float2bfloat16(x);
        }
        *reinterpret_cast<bf16*>(xt + sw(TM, p, c)) = __float2bfloat16(x);
      }
    }
  }
}

// K blocks [k0, k1) of the packed W1 (368 x 192) into dst as SW(368, 64)
// blocks in a row (SW(368, 192) for all three), 16-byte cp.async
__device__ __forceinline__ void stage_w1(unsigned char* dst, const bf16* w1p, int k0, int k1) {
  const int cpr = 8 * (k1 - k0);
  for (int e = threadIdx.x; e < 2 * NH * cpr; e += NTW) {
    const int n = e / cpr, c = e % cpr;
    cp_async16(dst + (c >> 3) * 2 * NH * 128 + n * 128 + (((c & 7) ^ (n & 7)) << 4),
               w1p + (long long)n * KC + 64 * k0 + c * 8, true);
  }
}
// LN1's scale and bias and b1 into par (PAR1_B), 8-byte cp.async
__device__ __forceinline__ void issue_par1(const Tail& t, bf16* par) {
  for (int e = threadIdx.x; e < (2 * CC + CH) / 4; e += NTW) {
    const int r = e < CC / 4 ? 0 : e < CC / 2 ? 1 : 2;
    const int c = e - r * (CC / 4);
    cp_async8(par + 4 * e, (r == 0 ? t.ln1s : r == 1 ? t.ln1b : t.b1) + 4 * c, true);
  }
}
// fc1's product over the K slices [S0, S1): acc (warpgroup g's 64 x 184,
// hidden channels [180 g, 180 g + 180)) += x W1, x the tile SW(64, 192) at
// xs, W1's 64-deep K block k at w1[k] (SW(368, 64)).  Inside the caller's
// wgmma_fence / commit / wait.
template <int S0, int S1>
__device__ __forceinline__ void fc1_product(float (&acc)[NH / 2], uint32_t xs,
                                            const uint32_t (&w1)[KC / 64]) {
  const int g = threadIdx.x >> 7;
#pragma unroll
  for (int s = S0; s < S1; ++s)
    wgmma_m64nNk16<NH>(acc, desc(xs, TM, 0, s), desc(w1[s >> 2], 2 * NH, NH * g, s & 3));
}
// h = gelu(u + b1) of a channel pair, rounded where the plain version
// rounds (u, fc1's product, already rounded): + b1, gelu
__device__ __forceinline__ float2 gelu_h(float2 u, float2 b) {
  const float2 v = rbf2(u.x + b.x, u.y + b.y);
  return rbf2(gelu_f(v.x), gelu_f(v.y));
}
// h = gelu(. + b1) in the accumulators (both warpgroups at once): the
// product rounded, then gelu_h; b1h the half's 180 biases
__device__ __forceinline__ void fc1_gelu(float (&acc)[NH / 2], const bf16* b1h) {
#pragma unroll
  for (int i = 0; i < NH / 2; i += 2) {
    const int n = acc_col(i);
    if (n >= CC) continue;
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1h + n));
    const float2 h = gelu_h(rbf2(acc[i], acc[i + 1]), b);
    acc[i] = h.x;
    acc[i + 1] = h.y;
  }
}
// the copies of hidden chunk j into stage st: W2's rows [64 j, 64 j + 64)
// as SW(184, 64), h on the halo (zero outside the map, the conv's zero
// padding, and past the band's h rows), the chunk's 25 taps and dwb
__device__ __forceinline__ void issue_chunk(const Tail& t, unsigned char* st, int j, int bi,
                                            int ty0, int tx0) {
  unsigned char* w2s = st;
  unsigned char* hh = st + W2C_B;
  unsigned char* taps = hh + HALO_B;
  const int ch0 = j * HC;
  for (int e = threadIdx.x; e < NH * 8; e += NTW) {
    const int n = e >> 3, c = e & 7;
    cp_async16(w2s + n * 128 + ((c ^ (n & 7)) << 4), t.w2p + (long long)n * (NCH * HC) + ch0 + c * 8,
               true);
  }
  const bf16* himg = t.hbuf + (long long)bi * (t.hr1 - t.hr0) * t.W * CH;
  for (int e = threadIdx.x; e < NPIX * 8; e += NTW) {
    const int p = e >> 3, c = e & 7;
    const int py = ty0 - 2 + p / PW, px = tx0 - 2 + p % PW;
    const bool ok = py >= t.hr0 && py < t.hr1 && px >= 0 && px < t.W && ch0 + 8 * c < CH;
    cp_async16(hh + p * 128 + c * 16,
               ok ? himg + ((long long)(py - t.hr0) * t.W + px) * CH + ch0 + 8 * c : t.hbuf, ok);
  }
  for (int e = threadIdx.x; e < 26 * 8; e += NTW) {
    const int tap = e >> 3, c = e & 7;
    const bool ok = ch0 + 8 * c < CH;
    const bf16* src = tap < 25 ? t.dw + tap * CH : t.dwb;
    cp_async16(taps + tap * 128 + c * 16, ok ? src + ch0 + 8 * c : t.dw, ok);
  }
}

// The tail of an 8 x 16 tile of the band (grid: x, y tiles, z images): per
// hidden chunk, the 25 taps + gelu + residual on the CUDA cores into h2,
// then y += h2 @ W2 chunk on wgmma (warpgroup g the tile's rows 4g .. 4g +
// 3, all of C in n184); the next chunk's copies run behind them.  Then y through
// shared memory, one warp a row: b2, LN2, the residual, out, and the
// statistics (per-pixel channel mean and max, the image's per-channel sum
// and max by atomics).  The kernels (htb_tail.cu's htb_tail_out_wg,
// htb_fused.cu's htb_fused_tail_wg) hand it their dynamic shared memory.
__device__ __forceinline__ void tail_out(const Tail& t, unsigned char* smem_raw) {
  unsigned char* stages = align1k(smem_raw);
  unsigned char* h2 = stages + STAGES * STAGE_B;
  unsigned char* xc = h2 + H2_B;
  bf16* par = (bf16*)(xc + XC_B);
  const int bi = blockIdx.z, ty0 = t.r0 + blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int g = threadIdx.x >> 7;

  float acc[NH / 2];
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) acc[i] = 0.0f;
  issue_chunk(t, stages, 0, bi, ty0, tx0);
  // the epilogue's residual rows and parameters, behind chunk 0
  for (int e = threadIdx.x; e < NCEN * (CC / 4); e += NTW) {
    const int p = e / (CC / 4), c = e % (CC / 4);
    const int py = ty0 + p / TW, px = tx0 + p % TW;
    const bool ok = py < t.r1 && px < t.W;
    cp_async8(xc + p * (CC * 2) + c * 8,
              ok ? t.xbuf + (((long long)bi * (t.r1 - t.r0) + py - t.r0) * t.W + px) * CC + c * 4
                 : t.xbuf,
              ok);
  }
  for (int e = threadIdx.x; e < 3 * (CC / 4); e += NTW) {
    const int r = e / (CC / 4), c = e % (CC / 4);
    cp_async8(par + r * CC + c * 4, (r == 0 ? t.b2 : r == 1 ? t.ln2s : t.ln2b) + c * 4, true);
  }
  cp_async_commit();
  for (int j = 0; j < NCH; ++j) {
    if (j + 1 < NCH) issue_chunk(t, stages + ((j + 1) % STAGES) * STAGE_B, j + 1, bi, ty0, tx0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();     // chunk j is in for every thread
    const unsigned char* st = stages + (j % STAGES) * STAGE_B;
    const bf16* hh = (const bf16*)(st + W2C_B);
    const bf16* taps = (const bf16*)(st + W2C_B + HALO_B);
    // two hidden channels of one column a thread: each halo row's 5 pairs
    // feed up to 5 of the column's 8 outputs
    const __nv_bfloat162* hh2 = reinterpret_cast<const __nv_bfloat162*>(hh);
    const __nv_bfloat162* tp2 = reinterpret_cast<const __nv_bfloat162*>(taps);
    for (int item = threadIdx.x; item < (HC / 2) * TW; item += NTW) {
      const int cp = item % (HC / 2), cx = item / (HC / 2), ch = j * HC + 2 * cp;
      float2 wt[25], s[TH];
#pragma unroll
      for (int k = 0; k < 25; ++k) wt[k] = __bfloat1622float2(tp2[k * (HC / 2) + cp]);
      const float2 bias = __bfloat1622float2(tp2[25 * (HC / 2) + cp]);
#pragma unroll
      for (int cy = 0; cy < TH; ++cy) s[cy] = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int r = 0; r < PH; ++r) {
        float2 v[5];
#pragma unroll
        for (int jx = 0; jx < 5; ++jx)
          v[jx] = __bfloat1622float2(hh2[(r * PW + cx + jx) * (HC / 2) + cp]);
#pragma unroll
        for (int cy = 0; cy < TH; ++cy) {
          if (r - cy < 0 || r - cy >= 5) continue;
#pragma unroll
          for (int jx = 0; jx < 5; ++jx) {
            s[cy].x = fmaf(v[jx].x, wt[(r - cy) * 5 + jx].x, s[cy].x);
            s[cy].y = fmaf(v[jx].y, wt[(r - cy) * 5 + jx].y, s[cy].y);
          }
        }
      }
      const bool live = ch < CH;   // CH is even: a pair is live or not as a whole
#pragma unroll
      for (int cy = 0; cy < TH; ++cy) {
        const float2 hc = __bfloat1622float2(hh2[((cy + 2) * PW + cx + 2) * (HC / 2) + cp]);
        const float2 c = rbf2(s[cy].x + bias.x, s[cy].y + bias.y);
        const float2 gl = rbf2(gelu_f(c.x), gelu_f(c.y));
        *reinterpret_cast<__nv_bfloat162*>(h2 + sw(NCEN, cy * TW + cx, 2 * cp)) =
            live ? __floats2bfloat162_rn(hc.x + gl.x, hc.y + gl.y) : __floats2bfloat162_rn(0.0f, 0.0f);
      }
    }
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < HC / 16; ++s)
      wgmma_m64nNk16<NH>(acc, desc(saddr(h2), NCEN, 64 * g, s), desc(saddr(st), NH, 0, s));
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();     // h2 and stage j are read
  }
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) fence_operand(acc[i]);

  // y = h2 W2 over the chunk buffers, then one warp a row: y + b2 (rounded
  // as the plain version's), LN2, out = x + LN2(y), lanes over channel
  // pairs, the loads and stores of a row contiguous
  float* ys = (float*)stages;                 // 128 rows of 184
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) ys[(64 * g + acc_row(i)) * NH + acc_col(i)] = acc[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int PPL = (CC / 2 + 31) / 32;     // channel pairs a lane: 3
  float2 psum[PPL], pmax[PPL];                // this warp's rows' sum and max of out
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    psum[k] = make_float2(0.0f, 0.0f);
    pmax[k] = make_float2(-CUDART_INF_F, -CUDART_INF_F);
  }
  for (int p = warp; p < NCEN; p += NTW / 32) {
    const int py = ty0 + p / TW, px = tx0 + p % TW;
    const bool inside = py < t.r1 && px < t.W;
    const long long q = ((long long)bi * t.H + py) * t.W + px;
    const bf16* xr = (const bf16*)(xc + p * (CC * 2));
    float2 y[PPL], xv[PPL];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int n = 2 * (lane + 32 * k);
      y[k] = xv[k] = make_float2(0.0f, 0.0f);
      if (n < CC) {
        xv[k] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + n));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(par + n));
        const float2 u = rbf2(ys[p * NH + n], ys[p * NH + n + 1]);
        y[k] = rbf2(u.x + b.x, u.y + b.y);
      }
      s1 += y[k].x + y[k].y;
      s2 += y[k].x * y[k].x + y[k].y * y[k].y;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mean = s1 / (float)CC;
    const float rstd = rsqrtf(fmaxf(s2 / (float)CC - mean * mean, 0.0f) + 1e-5f);
    float rs = 0.0f, rm = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int n = 2 * (lane + 32 * k);
      if (n >= CC) continue;
      const float2 sc2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(par + CC + n));
      const float2 bs2 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(par + 2 * CC + n));
      const float2 ln = rbf2((y[k].x - mean) * rstd * sc2.x + bs2.x,
                             (y[k].y - mean) * rstd * sc2.y + bs2.y);
      const float2 o = rbf2(xv[k].x + ln.x, xv[k].y + ln.y);
      const float o0 = o.x, o1 = o.y;
      rs += o0 + o1;
      rm = fmaxf(rm, fmaxf(o0, o1));
      if (inside) {
        *reinterpret_cast<__nv_bfloat162*>(t.out + q * CC + n) = pack_bf(o0, o1);
        psum[k].x += o0;
        psum[k].y += o1;
        pmax[k].x = fmaxf(pmax[k].x, o0);
        pmax[k].y = fmaxf(pmax[k].y, o1);
      }
    }
    if (t.cmean != nullptr) {
      rs = warp_sum(rs);
      rm = warp_max(rm);
      if (inside && lane == 0) {
        t.cmean[q] = rs / (float)CC;
        t.cmax[q] = rm;
      }
    }
  }
  if (t.cmean == nullptr) return;
  // the tile's per-channel sum and max: the 8 warps' partials in order, then
  // one atomic each into the image's totals
  float* ws = ys + NCEN * NH;                 // 8 warps x 180 sums, then maxima
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const int n = 2 * (lane + 32 * k);
    if (n >= CC) continue;
    ws[warp * CC + n] = psum[k].x;
    ws[warp * CC + n + 1] = psum[k].y;
    ws[(8 + warp) * CC + n] = pmax[k].x;
    ws[(8 + warp) * CC + n + 1] = pmax[k].y;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < CC; c += NTW) {
    float sum = 0.0f, mx = -CUDART_INF_F;
    for (int w = 0; w < 8; ++w) {
      sum += ws[w * CC + c];
      mx = fmaxf(mx, ws[(8 + w) * CC + c]);
    }
    atomicAdd(t.ssum + bi * CC + c, sum);
    atomic_max_f(t.smax + bi * CC + c, mx);
  }
}

}  // namespace wgt

}  // namespace
