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

#include <cuda.h>   // CUtensorMap and its enums (the encoder comes through the runtime)

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
// tail: 8 x 16 output tiles, h over their 12 x 20 halo, hidden channels in
// chunks of 64 (one K block of fc2); a block is two consumer warpgroups
// (warpgroup g the tile's rows 4g .. 4g + 3) and a producer warpgroup.  Shared
// memory from its 1024-byte-aligned start: all of W2, each consumer's h2,
// the ring of halo stages (h, the chunk's 25 taps and dwb, by TMA), b2 and
// LN2's parameters, each consumer's per-channel sum and max of out, the
// ring's barriers
constexpr int TH = 8, TW = 16, PH = TH + 4, PW = TW + 4, NPIX = PH * PW;
constexpr int HC = 64, NCH = (CH + HC - 1) / HC, STAGES = 2;
constexpr int NTT = 3 * 128;             // two consumer warpgroups, a producer warpgroup
constexpr int W2C_B = NH * HC * 2;        // a W2 chunk SW(184, 64): 23,552 bytes
constexpr int H2C_B = 64 * HC * 2;        // a consumer's h2 SW(64, 64), fc2's A
constexpr int HALO_B = NPIX * HC * 2;     // h on the halo, 128 bytes a pixel
constexpr int TAP_B = 25 * HC * 2;        // the chunk's 25 taps, then dwb
constexpr int STAGE_B = HALO_B + TAP_B + HC * 2;
constexpr int H2_OFF = NCH * W2C_B;       // after W2 (141,312 bytes)
constexpr int RING_OFF = H2_OFF + 2 * H2C_B;
constexpr int PAR_OFF = RING_OFF + STAGES * STAGE_B;
constexpr int STAT_OFF = PAR_OFF + (3 * CC * 2 + 15) / 16 * 16;
constexpr int BAR_OFF = STAT_OFF + 2 * 2 * CC * 4;
constexpr int SMEM2 = BAR_OFF + 2 * STAGES * 8 + 1024;   // + the alignment's slack
static_assert(SMEM2 <= 232448, "shared memory");
static_assert(W2C_B % 1024 == 0 && H2_OFF % 1024 == 0 && RING_OFF % 128 == 0 &&
                  STAGE_B % 128 == 0 && BAR_OFF % 8 == 0,
              "wgmma operands on 1024 bytes, TMA boxes on 128");

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
  // ssum: the per-channel sums' slots, (2 x grid, B, CC), one a consumer
  // warpgroup of each block, zeroed by the caller, who adds them up in a
  // fixed order; smax: the (B, CC) maxima
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
// ---- the tail: barriers, TMA, the pipeline ---------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of this parity has completed; a wait of ~30 s is a fault:
// trap (the launch fails) rather than hold the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 36)) __trap();
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// a named barrier of n threads (ids 1.. : 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// TMA box loads into shared memory, completing on bar's transaction count;
// coordinates in elements, innermost first, out of bounds zero-filled
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst), "l"(map), "r"(bar), "r"(c0)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst), "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst), "l"(map), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// a bfloat16 pair as floats by its bits (two integer ops, where
// __bfloat1622float2 takes three), and a pair rounded to bfloat16 (rbf2)
// the same way: the tail's loops are bound by the instructions they issue
__device__ __forceinline__ float2 bf2f(__nv_bfloat162 v) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 rnd2(float a, float b) {
  return bf2f(__floats2bfloat162_rn(a, b));
}

// The tail's TMA maps: h of the band (channels, columns, h rows [hr0, hr1),
// images), the taps (channels, 25) and dwb (channels)
struct TailMaps {
  CUtensorMap h, dw, dwb;
};

// The tail over the band's 8 x 16 tiles, persistent: block b takes tiles b,
// b + gridDim.x, ... (image, tile row, tile column in order).  One thread of
// the producer warpgroup (40 registers a thread, the rest to the consumers'
// 232) keeps each tile's six hidden chunks coming through a
// ring of two stages (a stage: h on the 12 x 20 halo, the chunk's taps and
// dwb, by TMA; full and empty mbarriers).  Each consumer warpgroup takes its
// half of the tile, 64 pixels, one tile row a warp: per chunk, a thread's
// channel pair along the row's 16 outputs (25 taps, + dwb, gelu, + h) on the
// CUDA cores into its h2, then y += h2 @ W2's chunk (all of C, n184) on
// wgmma against the resident W2, left running while the next chunk's taps
// are computed.  Inside the chunk loop a warpgroup waits only on the ring's
// barriers and on its own named barrier, and gives each stage back as soon
// as all its warps have read it.  After the sixth chunk the
// epilogue runs on the accumulators (a row's 184 columns over the four
// lanes of a quad): b2, LN2, the residual, out, and the statistics
// (per-pixel channel mean and max; the per-channel sum and max gathered in
// shared memory and added into the block's slot of the image's sums, and
// into its maxima by atomics, once the block leaves the image).  The
// residual x of a tile's pixels is loaded into registers as its first
// chunk starts.
__device__ __forceinline__ void tail_out(const Tail& t, const TailMaps& m,
                                         unsigned char* smem_raw) {
  unsigned char* sm = align1k(smem_raw);
  bf16* par = (bf16*)(sm + PAR_OFF);            // b2, ln2 scale, ln2 bias
  float* stat = (float*)(sm + STAT_OFF);        // per consumer: CC sums, CC maxima
  const uint32_t bars = saddr(sm + BAR_OFF);    // full[s] at 8 s, empty[s] at 8 (STAGES + s)
  const int ntx = (t.W + TW - 1) / TW, nty = (t.r1 - t.r0 + TH - 1) / TH;
  const int per_img = ntx * nty, ntiles = t.B * per_img;

  // W2 (packed, all six K blocks), the parameters, the partials, the barriers
  for (int e = threadIdx.x; e < NCH * NH * 8; e += NTT) {
    const int j = e / (NH * 8), n = (e >> 3) % NH, c = e & 7;
    cp_async16(sm + j * W2C_B + n * 128 + ((c ^ (n & 7)) << 4),
               t.w2p + (long long)n * (NCH * HC) + j * HC + c * 8, true);
  }
  for (int e = threadIdx.x; e < 3 * (CC / 4); e += NTT) {
    const int r = e / (CC / 4), c = e % (CC / 4);
    cp_async8(par + r * CC + c * 4, (r == 0 ? t.b2 : r == 1 ? t.ln2s : t.ln2b) + c * 4, true);
  }
  cp_async_commit();
  for (int e = threadIdx.x; e < 4 * CC; e += NTT) stat[e] = (e / CC) & 1 ? -CUDART_INF_F : 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(bars + 8 * (STAGES + s), 2);       // one arrival a consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  if (threadIdx.x >= 256) {   // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int bi = tile / per_img, q = tile % per_img;
        const int ty0 = t.r0 + (q / ntx) * TH, tx0 = (q % ntx) * TW;
        for (int j = 0; j < NCH; ++j, ++it) {
          const int s = it % STAGES;
          mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
          const uint32_t dst = saddr(sm + RING_OFF + s * STAGE_B), full = bars + 8 * s;
          mbar_expect(full, STAGE_B);
          tma_load(dst, &m.h, full, j * HC, tx0 - 2, ty0 - 2 - t.hr0, bi);
          tma_load(dst + HALO_B, &m.dw, full, j * HC, 0);
          tma_load(dst + HALO_B + TAP_B, &m.dwb, full, j * HC);
        }
      }
    }
    return;
  }

  // the consumers take the registers the producer gives up (168 each at
  // launch: 65,536 over 384 threads)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  unsigned char* h2 = sm + H2_OFF + g * H2C_B;
  float* wsum = stat + g * 2 * CC;
  float* wmax = wsum + CC;
  float acc[NH / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int bi = tile / per_img, q = tile % per_img;
    const int ty0 = t.r0 + (q / ntx) * TH, tx0 = (q % ntx) * TW;
    // this thread's pixels in the epilogue (the accumulators' rows): the
    // tile's row 4 g + w at columns lane / 4 and lane / 4 + 8 (hb 0, 1); their
    // residual x, at the accumulators' columns 8 k + 2 (lane % 4) + {0, 1},
    // loaded now so that the chunks hide the loads
    const int py = ty0 + 4 * g + w;
    bool in[2];
    long long qo[2];
    uint32_t xpre[NH / 4];
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      const int px = tx0 + (lane >> 2) + 8 * hb;
      in[hb] = py < t.r1 && px < t.W;
      qo[hb] = ((long long)bi * t.H + py) * t.W + px;
      const bf16* xr = t.xbuf + (((long long)bi * (t.r1 - t.r0) + py - t.r0) * t.W + px) * CC;
#pragma unroll
      for (int k = 0; k < NH / 8; ++k) {
        const int n = 8 * k + 2 * (lane & 3);
        xpre[2 * k + hb] = in[hb] && n < CC ? *reinterpret_cast<const uint32_t*>(xr + n) : 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) acc[i] = 0.0f;
    for (int j = 0; j < NCH; ++j, ++it) {
      const int s = it % STAGES;
      mbar_wait(bars + 8 * s, (it / STAGES) & 1);
      const unsigned char* st = sm + RING_OFF + s * STAGE_B;
      // this thread: channel pair `lane` of the chunk along the tile's row
      // 4 g + w, its 16 outputs from halo rows 4 g + w .. + 4; per output
      // the taps in the plain order (row, then column)
      const __nv_bfloat162* hh2 = reinterpret_cast<const __nv_bfloat162*>(st) + lane;
      const __nv_bfloat162* tp2 = reinterpret_cast<const __nv_bfloat162*>(st + HALO_B) + lane;
      float2 sum[TW];
#pragma unroll
      for (int cx = 0; cx < TW; ++cx) sum[cx] = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int ky = 0; ky < 5; ++ky) {
        float2 wk[5];
#pragma unroll
        for (int kx = 0; kx < 5; ++kx) wk[kx] = bf2f(tp2[(ky * 5 + kx) * (HC / 2)]);
        const __nv_bfloat162* row = hh2 + (4 * g + w + ky) * PW * (HC / 2);
#pragma unroll
        for (int x = 0; x < PW; ++x) {
          const float2 v = bf2f(row[x * (HC / 2)]);
#pragma unroll
          for (int kx = 0; kx < 5; ++kx) {
            const int cx = x - kx;
            if (cx < 0 || cx >= TW) continue;
            sum[cx].x = fmaf(v.x, wk[kx].x, sum[cx].x);
            sum[cx].y = fmaf(v.y, wk[kx].y, sum[cx].y);
          }
        }
      }
      // h2 = h + gelu(conv + dwb), zero past the hidden channels
      const float2 bias = bf2f(tp2[25 * (HC / 2)]);
      const bool live = j * HC + 2 * lane < CH;
      const __nv_bfloat162* ctr = hh2 + ((4 * g + w + 2) * PW + 2) * (HC / 2);
      uint32_t res[TW];
#pragma unroll
      for (int cx = 0; cx < TW; ++cx) {
        const float2 hc = bf2f(ctr[cx * (HC / 2)]);
        const float2 c = rnd2(sum[cx].x + bias.x, sum[cx].y + bias.y);
        const float2 gl = rnd2(gelu_f(c.x), gelu_f(c.y));
        const __nv_bfloat162 o = live ? __floats2bfloat162_rn(hc.x + gl.x, hc.y + gl.y)
                                      : __floats2bfloat162_rn(0.0f, 0.0f);
        res[cx] = *reinterpret_cast<const uint32_t*>(&o);
      }
      wgmma_wait<0>();            // the last chunk's product has read h2 ...
      bar_sync(1 + g, 128);       // ... in every warp of the warpgroup, whose
      if ((threadIdx.x & 127) == 0)   // reads of the stage are done: refill it
        mbar_arrive(bars + 8 * (STAGES + s));
#pragma unroll
      for (int cx = 0; cx < TW; ++cx)
        *reinterpret_cast<uint32_t*>(h2 + sw(64, 16 * w + cx, 2 * lane)) = res[cx];
      fence_proxy_async();
      bar_sync(1 + g, 128);       // h2 is written
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HC / 16; ++k)
        wgmma_m64nNk16<NH>(acc, desc(saddr(h2), 64, 0, k), desc(saddr(sm + j * W2C_B), NH, 0, k));
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) fence_operand(acc[i]);

    // the epilogue on the accumulators (columns 8 k + 2 (lane % 4) + {0,
    // 1}): y + b2 (rounded as the plain version's), LN2 with each row's sums
    // over its quad, out = x + LN2(y)
    float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < NH / 2; i += 2) {
      const int n = acc_col(i), hb = (i >> 1) & 1;
      float2 y = make_float2(0.0f, 0.0f);
      if (n < CC) {
        const float2 b = bf2f(*reinterpret_cast<const __nv_bfloat162*>(par + n));
        const float2 u = rnd2(acc[i], acc[i + 1]);
        y = rnd2(u.x + b.x, u.y + b.y);
      }
      acc[i] = y.x;
      acc[i + 1] = y.y;
      s1[hb] += y.x + y.y;
      s2[hb] += y.x * y.x + y.y * y.y;
    }
    float mean[2], rstd[2], rs[2] = {0.0f, 0.0f}, rm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1[hb] += __shfl_xor_sync(0xffffffffu, s1[hb], o);
        s2[hb] += __shfl_xor_sync(0xffffffffu, s2[hb], o);
      }
      mean[hb] = s1[hb] / (float)CC;
      rstd[hb] = rsqrtf(fmaxf(s2[hb] / (float)CC - mean[hb] * mean[hb], 0.0f) + 1e-5f);
    }
    // out in three rounds of 64 channels through the warp's quarter of h2
    // (free once every warp's last product is done), swizzled by 16 bytes,
    // then 8 bytes a lane to the 16 pixels' rows (contiguous runs of 128
    // bytes, not the accumulators' 4-byte pieces)
    unsigned char* stage = h2 + w * 2048;
    bar_sync(1 + g, 128);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int k = 8 * c; k < 8 * c + 8 && k < NH / 8; ++k) {
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int i = 4 * k + 2 * hb, n = 8 * k + 2 * (lane & 3), p = (lane >> 2) + 8 * hb;
          if (n >= CC) continue;
          const float2 xv = bf2f(*reinterpret_cast<const __nv_bfloat162*>(&xpre[i >> 1]));
          const float2 sc2 = bf2f(*reinterpret_cast<const __nv_bfloat162*>(par + CC + n));
          const float2 bs2 = bf2f(*reinterpret_cast<const __nv_bfloat162*>(par + 2 * CC + n));
          const float2 ln = rnd2((acc[i] - mean[hb]) * rstd[hb] * sc2.x + bs2.x,
                                 (acc[i + 1] - mean[hb]) * rstd[hb] * sc2.y + bs2.y);
          const float2 o = rnd2(xv.x + ln.x, xv.y + ln.y);
          unsigned char* at = stage + p * 128 + (((k - 8 * c) ^ (p & 7)) << 4) + 4 * (lane & 3);
          *reinterpret_cast<__nv_bfloat162*>(at) = pack_bf(o.x, o.y);
          rs[hb] += o.x + o.y;
          rm[hb] = fmaxf(rm[hb], fmaxf(o.x, o.y));
          acc[i] = o.x;
          acc[i + 1] = o.y;
        }
      }
      __syncwarp();
      constexpr int PIECES[3] = {16, 16, (CC - 128) / 4};   // 8-byte pieces a pixel
      const int pp = PIECES[c];
#pragma unroll
      for (int e = lane; e < 16 * PIECES[c]; e += 32) {
        const int p = e / pp, m = e % pp;
        if (py < t.r1 && tx0 + p < t.W) {
          const long long qp = ((long long)bi * t.H + py) * t.W + tx0 + p;
          *reinterpret_cast<uint2*>(reinterpret_cast<unsigned char*>(t.out + qp * CC) + 128 * c +
                                    8 * m) =
              *reinterpret_cast<const uint2*>(stage + p * 128 + (((m >> 1) ^ (p & 7)) << 4) +
                                              8 * (m & 1));
        }
      }
      __syncwarp();
    }
    if (t.cmean == nullptr) continue;
    // the per-pixel channel mean and max over the quad
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        rs[hb] += __shfl_xor_sync(0xffffffffu, rs[hb], o);
        rm[hb] = fmaxf(rm[hb], __shfl_xor_sync(0xffffffffu, rm[hb], o));
      }
      if (in[hb] && (lane & 3) == 0) {
        t.cmean[qo[hb]] = rs[hb] / (float)CC;
        t.cmax[qo[hb]] = rm[hb];
      }
    }
    // the per-channel sum and max of the warp's 16 pixels: the two rows of a
    // thread, then over the lanes of a column (lane bits 2-4; bit 4 splits
    // each pair), each warp's into h2 (free once every warp's last product
    // is done), then the four warps' in order into the warpgroup's partials,
    // channel c always by its thread c % 128
    float* part = reinterpret_cast<float*>(h2);   // [warp][sum, max][NH]
    const bool odd = lane & 16;
    bar_sync(1 + g, 128);
#pragma unroll
    for (int k = 0; k < NH / 8; ++k) {
      const float2 a = make_float2(acc[4 * k], acc[4 * k + 1]);
      const float2 b = make_float2(acc[4 * k + 2], acc[4 * k + 3]);
      const float NINF = -CUDART_INF_F;
      const float2 vs = make_float2((in[0] ? a.x : 0.0f) + (in[1] ? b.x : 0.0f),
                                    (in[0] ? a.y : 0.0f) + (in[1] ? b.y : 0.0f));
      const float2 vm = make_float2(fmaxf(in[0] ? a.x : NINF, in[1] ? b.x : NINF),
                                    fmaxf(in[0] ? a.y : NINF, in[1] ? b.y : NINF));
      float ks = (odd ? vs.y : vs.x) + __shfl_xor_sync(0xffffffffu, odd ? vs.x : vs.y, 16);
      float km = fmaxf(odd ? vm.y : vm.x, __shfl_xor_sync(0xffffffffu, odd ? vm.x : vm.y, 16));
#pragma unroll
      for (int o = 8; o >= 4; o >>= 1) {
        ks += __shfl_xor_sync(0xffffffffu, ks, o);
        km = fmaxf(km, __shfl_xor_sync(0xffffffffu, km, o));
      }
      if ((lane & 12) == 0) {
        const int n = 8 * k + 2 * (lane & 3) + (odd ? 1 : 0);
        part[2 * w * NH + n] = ks;
        part[(2 * w + 1) * NH + n] = km;
      }
    }
    bar_sync(1 + g, 128);
    // leaving the image: the partials into its totals, and cleared
    const int next = tile + gridDim.x;
    const bool leaving = next >= ntiles || next / per_img != bi;
    for (int c = threadIdx.x & 127; c < CC; c += 128) {
      float sum = wsum[c], mx = wmax[c];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        sum += part[2 * v * NH + c];
        mx = fmaxf(mx, part[(2 * v + 1) * NH + c]);
      }
      if (leaving) {
        // the sum into this thread's own slot (no other thread writes it,
        // and bands run in turn), so the totals add up in one order on
        // every run; a maximum is the same in any order
        t.ssum[((2 * blockIdx.x + g) * t.B + bi) * CC + c] += sum;
        atomic_max_f(t.smax + bi * CC + c, mx);
        sum = 0.0f;
        mx = -CUDART_INF_F;
      }
      wsum[c] = sum;
      wmax[c] = mx;
    }
  }
}

// ---- the tail's launch (host) ----------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no -lcuda)
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the maps of one band (t.hbuf holds its h rows [hr0, hr1) of each image)
inline int tail_maps(const Tail& t, TailMaps* m) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return -1;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t nh = (cuuint64_t)(t.hr1 - t.hr0), row = 2ull * CH * t.W;
  const cuuint64_t h_dims[4] = {CH, (cuuint64_t)t.W, nh, (cuuint64_t)t.B};
  const cuuint64_t h_strides[3] = {2ull * CH, row, row * nh};
  const cuuint32_t h_box[4] = {HC, PW, PH, 1};
  const cuuint64_t dw_dims[2] = {CH, 25}, dw_strides[1] = {2ull * CH};
  const cuuint32_t dw_box[2] = {HC, 25};
  auto one = [&](CUtensorMap* map, cuuint32_t rank, const void* base, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box) {
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                  strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS;
  };
  if (one(&m->h, 4, t.hbuf, h_dims, h_strides, h_box) ||
      one(&m->dw, 2, t.dw, dw_dims, dw_strides, dw_box) ||
      one(&m->dwb, 1, t.dwb, dw_dims, dw_strides, dw_box))
    return -1;
  return 0;
}

// the tail's grid: one block an SM, fewer where the band has fewer tiles
// (ops/kernels/ffn.py::tail_plan repeats it)
inline unsigned tail_grid(const Tail& t, int sms) {
  const long long tiles =
      (long long)t.B * ((t.r1 - t.r0 + TH - 1) / TH) * ((t.W + TW - 1) / TW);
  return (unsigned)(tiles < sms ? tiles : sms);
}

// launch the tail kernel (htb_tail_out_wg, htb_fused_tail_wg) over rows
// [r0, r1) of t
template <typename K>
int launch_tail(K kernel, const Tail& t, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  TailMaps m;
  if (tail_maps(t, &m) || set_smem(kernel, SMEM2)) return -1;
  kernel<<<tail_grid(t, sms), NTT, SMEM2, stream>>>(t, m);
  return (int)cudaGetLastError();
}

}  // namespace wgt

}  // namespace
