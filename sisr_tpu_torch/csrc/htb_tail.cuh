// The HTB tail's second stage, shared by htb_tail.cu and htb_fused.cu:
// for an 8x8 output tile, h2 = h + gelu(dw5x5(h) + dwb) on the tile,
// y = h2 @ W2 + b2, out = x + LN2(y), and optionally the next block's SCA
// statistics of out.  h comes from device memory (the first stage wrote
// it); the residual x is either rebuilt as s + LN1(attn) (htb_tail) or read
// as stored (htb_fused, x2).  See htb_tail.cu for the design.
#pragma once

#include "common.cuh"

#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int TH = 8, TW = 8;                // output tile
constexpr int DK = 5;                        // depthwise conv size
constexpr int PH = TH + 4, PW = TW + 4;      // haloed tile (5x5 conv)
constexpr int NP = PH * PW, NC = TH * TW;    // 144 haloed, 64 centre pixels
constexpr int NT = 256, NWARP = NT / 32;
constexpr int MAX_C = 192;                   // C <= 192 (6 channels per lane)

// (mean, 1/sqrt(var + eps)) of a C-wide row, one warp; the clamped fast
// variance of the plain layer_norm
template <typename V>
__device__ __forceinline__ float2 ln_stats(const V* row, int C, int lane) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f<V>(row[c]);
    s1 += v;
    s2 += v * v;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 / (float)C;
  return make_float2(mean, rsqrtf(fmaxf(s2 / (float)C - mean * mean, 0.0f) + 1e-5f));
}

// x = s + LN1(a) for pixels first, first + NWARP, .. < npix: one warp a
// pixel, the rows of four pixels loaded before any of them is reduced (one
// round trip to memory for four pixels, not three for one).
// rows(p, a, s) points a and s at pixel p's attn and shortcut rows, or
// returns false (x = 0 there); put(p, c, x) stores x for every c < kpad
// (x = 0 for C <= c).  Needs kpad <= MAX_C.
template <typename T, typename Rows, typename Put>
__device__ __forceinline__ void build_x(int first, int npix, int C, int kpad,
                                        const T* __restrict__ ln1s,
                                        const T* __restrict__ ln1b, Rows rows, Put put) {
  constexpr int G = 4, CPL = MAX_C / 32;  // pixels at once, channels a lane
  const int lane = threadIdx.x & 31;
  for (int p0 = first; p0 < npix; p0 += G * NWARP) {
    float av[G][CPL], sv[G][CPL], s1[G], s2[G];
    bool ok[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const T *ar = nullptr, *sr = nullptr;
      const int p = p0 + g * NWARP;
      ok[g] = p < npix && rows(p, ar, sr);
      s1[g] = s2[g] = 0.0f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        const bool in = ok[g] && c < C;
        av[g][i] = in ? to_f<T>(ar[c]) : 0.0f;
        sv[g][i] = in ? to_f<T>(sr[c]) : 0.0f;
        s1[g] += av[g][i];
        s2[g] += av[g][i] * av[g][i];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s1[g] = warp_sum(s1[g]);
      s2[g] = warp_sum(s2[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int p = p0 + g * NWARP;
      if (p >= npix) continue;
      const float mean = s1[g] / (float)C;
      const float rstd = rsqrtf(fmaxf(s2[g] / (float)C - mean * mean, 0.0f) + 1e-5f);
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c >= kpad) continue;
        put(p, c, ok[g] && c < C ? sv[g][i] + ((av[g][i] - mean) * rstd * to_f<T>(ln1s[c]) +
                                               to_f<T>(ln1b[c]))
                                 : 0.0f);
      }
    }
  }
}

// The residual x of the tile's centre into xc (NC x MAX_C floats, 0 past C
// and outside the image): s + LN1(attn) rebuilt when x2 is NULL, else x2
// as stored.  attn is read through its own batch and row strides.
template <typename T>
__device__ __forceinline__ void centre_x(float* xc, const T* __restrict__ attn, long long a_bs,
                                         long long a_rs, const T* __restrict__ sc,
                                         const T* __restrict__ ln1s, const T* __restrict__ ln1b,
                                         const T* __restrict__ x2, int bi, int ty0, int tx0,
                                         int H, int W, int C) {
  if (x2 != nullptr) {
    for (int e = threadIdx.x; e < NC * MAX_C; e += NT) {
      const int p = e / MAX_C, c = e % MAX_C;
      const int py = ty0 + p / TW, px = tx0 + p % TW;
      xc[e] = c < C && py < H && px < W
                  ? to_f<T>(x2[(((long long)bi * H + py) * W + px) * C + c]) : 0.0f;
    }
    return;
  }
  build_x<T>(
      threadIdx.x >> 5, NC, C, MAX_C, ln1s, ln1b,
      [&](int p, const T*& ar, const T*& sr) {
        const int py = ty0 + p / TW, px = tx0 + p % TW;
        if (py >= H || px >= W) return false;
        ar = attn + (long long)bi * a_bs + (long long)py * a_rs + (long long)px * C;
        sr = sc + (((long long)bi * H + py) * W + px) * C;
        return true;
      },
      [&](int p, int c, float x) { xc[p * MAX_C + c] = x; });
}

// 5./6. of both kernels: out = x + LN2(y + b2) for the tile's centre, the
// per-pixel channel stats and the per-block spatial partials.  ys holds
// y (without b2) with row stride ldy; the x row of centre pixel p is
// xc + ((p / TW) * xsy + p % TW) * ldx.
template <typename T>
__device__ void finish_tile(float* ys, int ldy, const float* xc, int xsy, int ldx,
                            const T* __restrict__ b2, const T* __restrict__ ln2s,
                            const T* __restrict__ ln2b, T* __restrict__ out,
                            float* __restrict__ cmean, float* __restrict__ cmax,
                            float* __restrict__ psum, float* __restrict__ pmax, int bi,
                            int ty0, int tx0, int H, int W, int C) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int p = warp; p < NC; p += NWARP) {
    const int cy = p / TW, cx = p % TW;
    const int py = ty0 + cy, px = tx0 + cx;
    const bool inside = py < H && px < W;
    float* yr = ys + p * ldy;
    for (int c = lane; c < C; c += 32) yr[c] += to_f<T>(b2[c]);
    const float2 st = ln_stats(yr, C, lane);
    const float* xr = xc + (cy * xsy + cx) * ldx;
    T* orow = out + (((long long)bi * H + py) * W + px) * C;
    float osum = 0.0f, omax = -CUDART_INF_F;
    for (int c = lane; c < C; c += 32) {
      const float ln = (yr[c] - st.x) * st.y * to_f<T>(ln2s[c]) + to_f<T>(ln2b[c]);
      // the stored value: the statistics describe out as the next block reads it
      const float o = to_f<T>(from_f<T>(xr[c] + ln));
      yr[c] = o;
      if (inside) orow[c] = from_f<T>(o);
      osum += o;
      omax = fmaxf(omax, o);
    }
    if (cmean != nullptr && inside) {
      osum = warp_sum(osum);
      omax = warp_max(omax);
      if (lane == 0) {
        const long long q = ((long long)bi * H + py) * W + px;
        cmean[q] = osum / (float)C;
        cmax[q] = omax;
      }
    }
  }
  if (cmean != nullptr) {
    __syncthreads();
    const int nblk = gridDim.x * gridDim.y;
    const long long row = (long long)bi * nblk + blockIdx.y * gridDim.x + blockIdx.x;
    for (int c = tid; c < C; c += NT) {
      float s = 0.0f, m = -CUDART_INF_F;
      for (int p = 0; p < NC; ++p) {
        if (ty0 + p / TW >= H || tx0 + p % TW >= W) continue;
        const float v = ys[p * ldy + c];
        s += v;
        m = fmaxf(m, v);
      }
      psum[row * C + c] = s;
      pmax[row * C + c] = m;
    }
  }
}

// ---- float32: products on the FP32 pipes ----------------------------------
// Every product a register tile of float32 FMAs over channel-major operands
// in shared memory, read as float4s.  Needs C % 4 == 0, Ch % 4 == 0 and
// 16-byte aligned h and W2.

namespace f32k {

constexpr int HC = 64;           // hidden channels per chunk
constexpr int BM1 = 64;          // fc1: pixels a block
constexpr int LDP = BM1 + 4;     // pixel stride of the channel-major tiles
constexpr int KP = MAX_C;        // C padded to whole 12-column groups of fc2
constexpr int LDY = KP + 4;

// tail: the haloed h chunk (NP x HC), a W2 chunk (HC x KP), h2 channel-major
// (HC x LDP) and the chunk's taps; 107 KB, two blocks per SM
constexpr size_t HH_F = (size_t)NP * HC, W2_F = (size_t)HC * KP, H2_F = (size_t)HC * LDP;
constexpr size_t SMEM2 = sizeof(float) * (HH_F + W2_F + H2_F + DK * DK * HC);
static_assert(sizeof(float) * ((size_t)NC * LDY + (size_t)NC * KP) <= SMEM2,
              "y and x alias the chunk buffers");

// The tail of one 8x8 tile (grid: x, y tiles, z images), SMEM2 bytes of
// shared memory at sm.
__device__ __forceinline__ void tail_out(float* sm, const float* __restrict__ attn,
                                         long long a_bs, long long a_rs,
                                         const float* __restrict__ sc,
                                         const float* __restrict__ ln1s,
                                         const float* __restrict__ ln1b,
                                         const float* __restrict__ x2,
                                         const float* __restrict__ hbuf,
                                         const float* __restrict__ dw,
                                         const float* __restrict__ dwb,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         const float* __restrict__ ln2s,
                                         const float* __restrict__ ln2b, float* __restrict__ out,
                                         float* __restrict__ cmean, float* __restrict__ cmax,
                                         float* __restrict__ psum, float* __restrict__ pmax,
                                         int H, int W, int C, int Ch) {
  float* hh = sm;                 // NP x HC
  float* w2s = hh + HH_F;         // HC x KP
  float* h2t = w2s + W2_F;        // HC x LDP
  float* dws = h2t + H2_F;        // DK*DK x HC
  float* ys = sm;                 // NC x LDY, after the chunk loop
  float* xc = sm + NC * LDY;      // NC x KP

  const int tid = threadIdx.x;
  const int bi = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const float* h_img = hbuf + (long long)bi * H * W * Ch;

  // fc2 outputs of this thread: pixels 4 pg .. 4 pg + 3, channels 12 cg .. 12 cg + 11
  const int pg = tid / (KP / 12), cg = tid % (KP / 12);
  float acc[4][12] = {};
  for (int ch0 = 0; ch0 < Ch; ch0 += HC) {
    __syncthreads();  // the previous chunk's readers are done
    // h over the haloed tile (zero outside the image: the conv's zero
    // padding) and the chunk's W2 rows (zero past C and Ch)
    for (int e = tid; e < NP * (HC / 4); e += NT) {
      const int p = e / (HC / 4), j = (e % (HC / 4)) * 4;
      const int py = ty0 - 2 + p / PW, px = tx0 - 2 + p % PW;
      const bool ok = py >= 0 && py < H && px >= 0 && px < W && ch0 + j < Ch;
      cp_async16(hh + p * HC + j, ok ? h_img + ((long long)py * W + px) * Ch + ch0 + j : hbuf,
                 ok);
    }
    for (int e = tid; e < HC * (KP / 4); e += NT) {
      const int r = e / (KP / 4), c = (e % (KP / 4)) * 4;
      const bool ok = ch0 + r < Ch && c < C;
      cp_async16(w2s + r * KP + c, ok ? w2 + (long long)(ch0 + r) * C + c : w2, ok);
    }
    cp_async_commit();
    for (int e = tid; e < DK * DK * HC; e += NT) {
      const int t = e / HC, c = e % HC;
      dws[e] = ch0 + c < Ch ? dw[t * Ch + ch0 + c] : 0.0f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // 25 taps + gelu + residual: one channel of one column of the tile a
    // thread, as in the bfloat16 tail
    for (int item = tid; item < HC * TW; item += NT) {
      const int c = item % HC, cx = item / HC;
      float wt[DK * DK], s[TH];
#pragma unroll
      for (int t = 0; t < DK * DK; ++t) wt[t] = dws[t * HC + c];
#pragma unroll
      for (int cy = 0; cy < TH; ++cy) s[cy] = 0.0f;
#pragma unroll
      for (int r = 0; r < PH; ++r) {
        float v[DK];
#pragma unroll
        for (int jx = 0; jx < DK; ++jx) v[jx] = hh[(r * PW + cx + jx) * HC + c];
#pragma unroll
        for (int cy = 0; cy < TH; ++cy) {
          if (r - cy < 0 || r - cy >= DK) continue;
#pragma unroll
          for (int jx = 0; jx < DK; ++jx) s[cy] = fmaf(v[jx], wt[(r - cy) * DK + jx], s[cy]);
        }
      }
      const bool live = ch0 + c < Ch;
      const float bias = live ? dwb[ch0 + c] : 0.0f;
#pragma unroll
      for (int cy = 0; cy < TH; ++cy) {
        const float hc = hh[((cy + 2) * PW + cx + 2) * HC + c];
        h2t[c * LDP + cy * TW + cx] = live ? hc + gelu_f(s[cy] + bias) : 0.0f;
      }
    }
    __syncthreads();

    // this chunk's share of fc2
    for (int j = 0; j < HC; ++j) {
      const float4 hv = *reinterpret_cast<const float4*>(h2t + j * LDP + 4 * pg);
      const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 wv = *reinterpret_cast<const float4*>(w2s + j * KP + 12 * cg + 4 * q);
        const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i][4 * q + u] = fmaf(hs[i], ws[u], acc[i][4 * q + u]);
      }
    }
  }
  __syncthreads();  // every read of the chunk buffers is done before ys and xc overwrite them
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 12; ++u) ys[(4 * pg + i) * LDY + 12 * cg + u] = acc[i][u];
  centre_x<float>(xc, attn, a_bs, a_rs, sc, ln1s, ln1b, x2, bi, ty0, tx0, H, W, C);
  __syncthreads();
  finish_tile<float>(ys, LDY, xc, TW, KP, b2, ln2s, ln2b, out, cmean, cmax, psum, pmax, bi, ty0,
                     tx0, H, W, C);
}

}  // namespace f32k

// ---- bfloat16: products on the tensor cores -------------------------------
// Chunks of W1, W2 and the haloed h arrive by cp.async a chunk ahead of
// their products.  Needs C % 4 == 0, Ch % 4 == 0 and 8-byte aligned h and
// W2 (8-byte copies).

namespace tck {

constexpr int KP = MAX_C;        // C padded to the MMA depth
constexpr int HC = 64;           // hidden channels per chunk
constexpr int VEC = 4;           // bf16 per 8-byte copy
// row strides, padded so that the rows of a 16x16 fragment start on
// different shared-memory banks
constexpr int LDX = KP + 8;      // bf16 x
constexpr int LDW1 = HC + 8;     // bf16 W1 chunk
constexpr int LDF = HC + 4;      // float fc1 out
constexpr int LDHH = HC + 8;     // bf16 haloed h chunk
constexpr int LDH2 = HC + 8;     // bf16 h2
constexpr int LDW2 = KP + 8;     // bf16 W2 chunk
constexpr int LDY = KP + 4;      // float y
constexpr int MT2 = NC / 16, NT2 = KP / 16;   // fc2: 4 x 12 output fragments
constexpr int FR2 = MT2 * NT2 / NWARP;        // fc2 fragments a warp keeps: 6
static_assert(NC % 16 == 0 && (MT2 * NT2) % NWARP == 0 && NWARP % MT2 == 0, "tile shape");

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// tail: an 8x8 output tile, shared memory in order (multiples of 128 bytes)
constexpr size_t HH_B = sizeof(bf16) * NP * LDHH;      // one haloed h chunk (two buffers)
constexpr size_t W2_B = sizeof(bf16) * HC * LDW2;      // one W2 chunk (two buffers)
constexpr size_t DW_B = sizeof(float) * DK * DK * HC;    // the chunk's 25 taps
constexpr size_t H2_B = sizeof(bf16) * NC * LDH2;      // h2, fc2's A
constexpr size_t SMEM2 = 2 * HH_B + 2 * W2_B + DW_B + H2_B;   // 106 KB: two blocks per SM
// after the chunk loop: y and the centre's x (float32) over the buffers
constexpr size_t YS_B = sizeof(float) * NC * LDY;
constexpr size_t XC_B = sizeof(float) * NC * KP;
static_assert(YS_B + XC_B <= SMEM2, "y and x alias the chunk buffers");

// The tail of one 8x8 tile (grid: x, y tiles, z images), SMEM2 bytes of
// 128-byte aligned shared memory at smem.
__device__ __forceinline__ void tail_out(unsigned char* smem, const bf16* __restrict__ attn,
                                         long long a_bs, long long a_rs,
                                         const bf16* __restrict__ sc,
                                         const bf16* __restrict__ ln1s,
                                         const bf16* __restrict__ ln1b,
                                         const bf16* __restrict__ x2,
                                         const bf16* __restrict__ hbuf,
                                         const bf16* __restrict__ dw,
                                         const bf16* __restrict__ dwb,
                                         const bf16* __restrict__ w2,
                                         const bf16* __restrict__ b2,
                                         const bf16* __restrict__ ln2s,
                                         const bf16* __restrict__ ln2b, bf16* __restrict__ out,
                                         float* __restrict__ cmean, float* __restrict__ cmax,
                                         float* __restrict__ psum, float* __restrict__ pmax,
                                         int H, int W, int C, int Ch) {
  bf16* hh = (bf16*)smem;
  bf16* w2s = (bf16*)(smem + 2 * HH_B);
  float* dws = (float*)(smem + 2 * HH_B + 2 * W2_B);
  bf16* h2a = (bf16*)(smem + 2 * HH_B + 2 * W2_B + DW_B);
  float* ys = (float*)smem;
  float* xc = (float*)(smem + YS_B);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bi = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int nch = (Ch + HC - 1) / HC;
  const bf16* h_img = hbuf + (long long)bi * H * W * Ch;

  // h over the haloed tile (zero outside the image: the conv's zero
  // padding) and the W2 rows of the chunk at ch0 into buffer buf
  auto issue = [&](int buf, int ch0) {
    bf16* hd = hh + buf * (NP * LDHH);
    for (int e = tid; e < NP * (HC / VEC); e += NT) {
      const int p = e / (HC / VEC), v = e % (HC / VEC), j = ch0 + v * VEC;
      const int py = ty0 - 2 + p / PW, px = tx0 - 2 + p % PW;
      const bool ok = py >= 0 && py < H && px >= 0 && px < W && j < Ch;
      cp_async8(hd + p * LDHH + v * VEC, ok ? h_img + ((long long)py * W + px) * Ch + j : hbuf,
                ok);
    }
    bf16* wd = w2s + buf * (HC * LDW2);
    for (int e = tid; e < HC * (KP / VEC); e += NT) {
      const int r = e / (KP / VEC), c = (e % (KP / VEC)) * VEC;
      const bool ok = ch0 + r < Ch && c < C;
      cp_async8(wd + r * LDW2 + c, ok ? w2 + (long long)(ch0 + r) * C + c : w2, ok);
    }
  };

  // fc2 accumulators of this warp: row tile m2, column tiles n2 .. n2+FR2-1
  const int m2 = warp % MT2, n2 = (warp / MT2) * FR2;
  FragC acc[FR2];
#pragma unroll
  for (int i = 0; i < FR2; ++i) wmma::fill_fragment(acc[i], 0.0f);

  issue(0, 0);
  cp_async_commit();
  for (int j = 0; j < nch; ++j) {
    const int ch0 = j * HC;
    if (j + 1 < nch) issue((j + 1) % 2, ch0 + HC);
    cp_async_commit();
    for (int e = tid; e < DK * DK * HC; e += NT) {
      const int t = e / HC, c = e % HC;
      dws[e] = ch0 + c < Ch ? to_f<bf16>(dw[t * Ch + ch0 + c]) : 0.0f;
    }
    cp_async_wait<1>();   // chunk j has landed
    __syncthreads();      // ... for every thread

    // 25 taps + gelu + residual on the centre -> h2, fc2's A.  A thread
    // takes one channel of one column of the tile, its taps in registers:
    // each haloed row's 5 values feed up to 5 of the column's 8 outputs
    const bf16* hb = hh + (j % 2) * (NP * LDHH);
    for (int item = tid; item < HC * TW; item += NT) {
      const int c = item % HC, cx = item / HC;
      float wt[DK * DK], s[TH];
#pragma unroll
      for (int t = 0; t < DK * DK; ++t) wt[t] = dws[t * HC + c];
#pragma unroll
      for (int cy = 0; cy < TH; ++cy) s[cy] = 0.0f;
#pragma unroll
      for (int r = 0; r < PH; ++r) {
        float v[DK];
#pragma unroll
        for (int jx = 0; jx < DK; ++jx) v[jx] = to_f<bf16>(hb[(r * PW + cx + jx) * LDHH + c]);
#pragma unroll
        for (int cy = 0; cy < TH; ++cy) {
          if (r - cy < 0 || r - cy >= DK) continue;
#pragma unroll
          for (int jx = 0; jx < DK; ++jx) s[cy] = fmaf(v[jx], wt[(r - cy) * DK + jx], s[cy]);
        }
      }
      const bool live = ch0 + c < Ch;
      const float bias = live ? to_f<bf16>(dwb[ch0 + c]) : 0.0f;
#pragma unroll
      for (int cy = 0; cy < TH; ++cy) {
        const float hc = to_f<bf16>(hb[((cy + 2) * PW + cx + 2) * LDHH + c]);
        h2a[(cy * TW + cx) * LDH2 + c] = __float2bfloat16(live ? hc + gelu_f(s[cy] + bias) : 0.0f);
      }
    }
    __syncthreads();

    // this chunk's share of fc2: acc += h2a @ W2 chunk
    const bf16* wb = w2s + (j % 2) * (HC * LDW2);
#pragma unroll
    for (int k = 0; k < HC; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, h2a + m2 * 16 * LDH2 + k, LDH2);
#pragma unroll
      for (int i = 0; i < FR2; ++i) {
        FragB b;
        wmma::load_matrix_sync(b, wb + k * LDW2 + (n2 + i) * 16, LDW2);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    __syncthreads();      // every read of the chunk's buffers is done
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < FR2; ++i)
    wmma::store_matrix_sync(ys + m2 * 16 * LDY + (n2 + i) * 16, acc[i], LDY,
                            wmma::mem_row_major);
  // the residual x of the centre, in float32
  centre_x<bf16>(xc, attn, a_bs, a_rs, sc, ln1s, ln1b, x2, bi, ty0, tx0, H, W, C);
  __syncthreads();
  finish_tile<bf16>(ys, LDY, xc, TW, KP, b2, ln2s, ln2b, out, cmean, cmax, psum, pmax, bi,
                    ty0, tx0, H, W, C);
}

}  // namespace tck

}  // namespace
