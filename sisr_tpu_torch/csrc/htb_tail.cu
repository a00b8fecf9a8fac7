// Fused HTB tail: x = s + LN1(attn); h = gelu(x@W1 + b1);
// h2 = h + gelu(dw5x5(h) + dwb); out = x + LN2(h2@W2 + b2); optionally the
// next block's SCA statistics of out (per-pixel channel mean/max, and the
// per-channel sum/max over the image: per-block partials that the caller
// reduces, or on the wgmma path the totals themselves).
//
// Replaces sisr_tpu/ops/pallas/ffn.py::_htb_tail_pipe (kernels
// _tail_pipe_kernel / _tail_pipe_parity_kernel, with and without stats)
// and _htb_tail_pallas.  The TPU kernel walks row bands in order and
// carries the depthwise conv's 2-row halo from one band to the next in VMEM
// scratch; CUDA blocks run in parallel, so nothing carries over between
// them: each output tile reads h on its own halo.
//
// Bound on the H100: two 180x360 products per pixel (10.2 GFLOP at 192^2,
// 10 us on the bf16 tensor cores) against ~40 MB of bf16 activations read
// and written once (12 us): the op sits on the ridge, and what costs time
// is products off the tensor cores' fast path, weights staged per small
// tile, and h read again over each tile's halo.
//
// Two launches (a band), with h (bfloat16) in device memory between them:
// a fused tail would recompute fc1 and its gelu on its halo (1.875x at
// 8x16, whose 12x20 halo holds 240 pixels for 128 outputs), and the gelu
// epilogue, not the product, is what fc1's time is made of; writing and
// reading h once costs 2 x 26.5 MB at 192^2, ~16 us at the memory's rate.
//  - bfloat16 at the model's widths, C = 180 and Ch = 360 (wgt below), on
//    wgmma: fc1 is persistent, one block an SM keeping all of the packed W1
//    (141 KB) and walking 64-pixel tiles, each warpgroup one half of the
//    hidden channels (n184), the next tile's attn and shortcut rows
//    arriving while the current tile's products run; h = gelu(. + b1)
//    leaves from the accumulators through shared memory, and x is kept in
//    device memory as the tail's residual.  The tail takes 8x16 output
//    tiles (h over a 12x20 halo: 1.875x of h's bytes, against 2.25x for
//    8x8), walks the hidden channels in chunks of 64 whose h, W2 rows and
//    taps arrive by 16-byte cp.async a chunk ahead (two stages), runs
//    the 25 taps on the CUDA cores into h2 and h2 @ W2 on wgmma (each
//    warpgroup 64 pixels x all of C); y then goes through shared memory
//    and one warp a row adds b2, normalises (LN2), adds the residual and
//    stores the row contiguously; the statistics' per-channel totals are
//    summed per tile and added into the image's by atomics.  The rows go
//    in bands that keep h of a band within 256 MiB (the 1080p frame: 6
//    bands of 192 rows; fc1 recomputes the conv's 2-row halo of each).
//    Values round to bfloat16 where the plain version rounds them.
//  - float32 (f32k), and bfloat16 at other widths (tck, wmma 16x16x16):
//    the earlier kernels, 64-pixel fc1 blocks and 8x8 tail tiles; the tail
//    stage is htb_tail.cuh's, shared with htb_fused.cu.
// attn may be the window-padded SCC output: it is read through its own
// batch and row strides, rows [0, H) and columns [0, W) only.
#include "htb_tail.cuh"
#include "wgmma.cuh"

namespace {

// ---- float32: two launches, products on the FP32 pipes -------------------
// The bfloat16 design below (tck) in float32, so that it stays exact: h in
// float32 between the launches.  Both need C % 4 == 0, Ch % 4 == 0 and
// 16-byte aligned h, W1 and W2.

namespace f32k {

// fc1: x (C x LDP) and one W1 chunk (C x HC); 95 KB at C = 180
size_t smem1(int C) { return sizeof(float) * ((size_t)C * LDP + (size_t)C * HC); }

__global__ void __launch_bounds__(NT, 2)
htb_tail_fc1_f32(const float* __restrict__ attn, long long a_bs, long long a_rs,
                 const float* __restrict__ sc, const float* __restrict__ ln1s,
                 const float* __restrict__ ln1b, const float* __restrict__ w1,
                 const float* __restrict__ b1, float* __restrict__ hbuf, int B, int H, int W,
                 int C, int Ch) {
  extern __shared__ __align__(16) float sm[];
  float* xt = sm;                 // C x LDP: x, channel-major
  float* w1s = sm + C * LDP;      // C x HC
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM1;

  // x = s + LN1(a); zero past the last pixel
  build_x<float>(
      warp, BM1, C, C, ln1s, ln1b,
      [&](int p, const float*& ar, const float*& sr) {
        const long long m = m0 + p;
        if (m >= M) return false;
        const long long bi = m / ((long long)H * W), hw = m % ((long long)H * W);
        ar = attn + bi * a_bs + (hw / W) * a_rs + (hw % W) * C;
        sr = sc + m * C;
        return true;
      },
      [&](int p, int c, float x) { xt[c * LDP + p] = x; });

  // pixels 4 pg .. 4 pg + 3 and hidden channels 4 jg .. 4 jg + 3 of a chunk
  const int pg = tid / (HC / 4), jg = tid % (HC / 4);
  for (int ch0 = 0; ch0 < Ch; ch0 += HC) {
    __syncthreads();  // x is built / the previous chunk's readers are done
    for (int e = tid; e < C * (HC / 4); e += NT) {
      const int k = e / (HC / 4), j = (e % (HC / 4)) * 4;
      cp_async16(w1s + k * HC + j, ch0 + j < Ch ? w1 + (long long)k * Ch + ch0 + j : w1,
                 ch0 + j < Ch);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float acc[4][4] = {};
    for (int k = 0; k < C; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(xt + k * LDP + 4 * pg);
      const float4 w = *reinterpret_cast<const float4*>(w1s + k * HC + 4 * jg);
      const float xs[4] = {x.x, x.y, x.z, x.w}, ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ws[j], acc[i][j]);
    }
    const int j0 = ch0 + 4 * jg;
    if (j0 >= Ch) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + 4 * pg + i;
      if (m >= M) continue;
      *reinterpret_cast<float4*>(hbuf + m * Ch + j0) =
          make_float4(gelu_f(acc[i][0] + b1[j0]), gelu_f(acc[i][1] + b1[j0 + 1]),
                      gelu_f(acc[i][2] + b1[j0 + 2]), gelu_f(acc[i][3] + b1[j0 + 3]));
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
htb_tail_out_f32(const float* __restrict__ attn, long long a_bs, long long a_rs,
                 const float* __restrict__ sc, const float* __restrict__ ln1s,
                 const float* __restrict__ ln1b, const float* __restrict__ hbuf,
                 const float* __restrict__ dw, const float* __restrict__ dwb,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                 float* __restrict__ out, float* __restrict__ cmean, float* __restrict__ cmax,
                 float* __restrict__ psum, float* __restrict__ pmax, int H, int W, int C, int Ch) {
  extern __shared__ __align__(16) float sm[];
  tail_out(sm, attn, a_bs, a_rs, sc, ln1s, ln1b, nullptr, hbuf, dw, dwb, w2, b2, ln2s, ln2b, out,
           cmean, cmax, psum, pmax, H, W, C, Ch);
}

}  // namespace f32k

// ---- bfloat16: two launches, products on the tensor cores -----------------
// Both need C % 4 == 0, Ch % 4 == 0 and 8-byte aligned h, W1 and W2.

namespace tck {

// fc1: 64 pixels a block, shared memory in order (multiples of 128 bytes)
constexpr int BM1 = 64;
constexpr size_t X1_B = sizeof(bf16) * BM1 * LDX;      // x, fc1's A
constexpr size_t W1_B = sizeof(bf16) * KP * LDW1;      // one W1 chunk (two buffers)
constexpr size_t F1_B = sizeof(float) * BM1 * LDF;     // fc1 out of the chunk
constexpr size_t SMEM1 = X1_B + 2 * W1_B + F1_B;       // 96 KB: two blocks per SM

__global__ void __launch_bounds__(NT, 2)
htb_tail_fc1_kernel(const bf16* __restrict__ attn, long long a_bs, long long a_rs,
           const bf16* __restrict__ sc, const bf16* __restrict__ ln1s,
           const bf16* __restrict__ ln1b, const bf16* __restrict__ w1,
           const bf16* __restrict__ b1, bf16* __restrict__ hbuf, int B, int H, int W, int C,
           int Ch) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xa = (bf16*)smem;
  bf16* w1s = (bf16*)(smem + X1_B);
  float* fs = (float*)(smem + X1_B + 2 * W1_B);
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM1;
  const int nch = (Ch + HC - 1) / HC;

  auto issue = [&](int buf, int ch0) {
    bf16* dst = w1s + buf * (KP * LDW1);
    for (int e = tid; e < KP * (HC / VEC); e += NT) {
      const int k = e / (HC / VEC), v = e % (HC / VEC), j = ch0 + v * VEC;
      const bool ok = k < C && j < Ch;
      cp_async8(dst + k * LDW1 + v * VEC, ok ? w1 + (long long)k * Ch + j : w1, ok);
    }
  };
  issue(0, 0);
  cp_async_commit();

  // x = s + LN1(a), rounded to bfloat16 as fc1's input; zero in the padded
  // channels [C, KP) and past the last pixel
  build_x<bf16>(
      warp, BM1, C, KP, ln1s, ln1b,
      [&](int p, const bf16*& ar, const bf16*& sr) {
        const long long m = m0 + p;
        if (m >= M) return false;
        const long long bi = m / ((long long)H * W), hw = m % ((long long)H * W);
        ar = attn + bi * a_bs + (hw / W) * a_rs + (hw % W) * C;
        sr = sc + m * C;
        return true;
      },
      [&](int p, int c, float x) { xa[p * LDX + c] = __float2bfloat16(x); });

  // 4 x 4 output fragments of a chunk, two a warp
  const int mt = warp / 2, nt0 = (warp % 2) * 2;
  for (int j = 0; j < nch; ++j) {
    if (j + 1 < nch) issue((j + 1) % 2, (j + 1) * HC);
    cp_async_commit();
    cp_async_wait<1>();   // chunk j has landed
    __syncthreads();      // ... for every thread; x is built; chunk j-1's readers are done
    const bf16* wb = w1s + (j % 2) * (KP * LDW1);
    FragC acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll 4
    for (int k = 0; k < KP; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, xa + mt * 16 * LDX + k, LDX);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        FragB b;
        wmma::load_matrix_sync(b, wb + k * LDW1 + (nt0 + i) * 16, LDW1);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::store_matrix_sync(fs + mt * 16 * LDF + (nt0 + i) * 16, acc[i], LDF,
                              wmma::mem_row_major);
    __syncthreads();
    // h = gelu(fc1 + b1), stored in bfloat16
    const int ch0 = j * HC;
    for (int e = tid; e < BM1 * HC; e += NT) {
      const int p = e / HC, c = e % HC;
      const long long m = m0 + p;
      if (m < M && ch0 + c < Ch)
        hbuf[m * Ch + ch0 + c] =
            __float2bfloat16(gelu_f(fs[p * LDF + c] + to_f<bf16>(b1[ch0 + c])));
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
htb_tail_out_kernel(const bf16* __restrict__ attn, long long a_bs, long long a_rs,
            const bf16* __restrict__ sc, const bf16* __restrict__ ln1s,
            const bf16* __restrict__ ln1b, const bf16* __restrict__ hbuf,
            const bf16* __restrict__ dw, const bf16* __restrict__ dwb,
            const bf16* __restrict__ w2, const bf16* __restrict__ b2,
            const bf16* __restrict__ ln2s, const bf16* __restrict__ ln2b,
            bf16* __restrict__ out, float* __restrict__ cmean, float* __restrict__ cmax,
            float* __restrict__ psum, float* __restrict__ pmax, int H, int W, int C, int Ch) {
  extern __shared__ __align__(128) unsigned char smem[];
  tail_out(smem, attn, a_bs, a_rs, sc, ln1s, ln1b, nullptr, hbuf, dw, dwb, w2, b2, ln2s, ln2b,
           out, cmean, cmax, psum, pmax, H, W, C, Ch);
}

}  // namespace tck

// ---- bfloat16 at the model's widths (C = 180, Ch = 360): wgmma -------------
// Operands are K-major tiles under the 128-byte swizzle (wgmma.cuh): SW(R,
// K) holds K / 64 blocks of R rows of 128 bytes.  W1 and W2 arrive packed
// (ops/kernels/ffn.py::pack_w1, pack_w2).  Every value is rounded to
// bfloat16 where the plain version rounds it: x = s + LN1(a), fc1's product,
// + b1, gelu; the depthwise conv (+ dwb), gelu, h2; fc2's product, + b2,
// LN2, out.

namespace wgt {

constexpr int NTW = 256;            // two warpgroups
constexpr int CC = 180, CH = 360;   // the model's widths
constexpr int KC = 192;             // C padded to the K step
constexpr int NH = 184;             // a half of the hidden channels (180) or C, padded
constexpr int TM = 64;              // fc1: pixels a tile (the wgmma M)
constexpr int W1_B = 2 * NH * KC * 2;   // packed W1 SW(368, 192): 141,312 bytes
constexpr int X_B = TM * KC * 2;        // an x tile SW(64, 192)
constexpr int RAW_B = 2 * TM * CC * 2;  // the tile's attn and shortcut rows as loaded
constexpr int ROWS_B = 3 * TM * 8;      // their offsets, and x's
constexpr int PAR1_B = (2 * CC + CH) * 2;   // ln1 scale and bias, b1
constexpr int SMEM1 = W1_B + X_B + RAW_B + ROWS_B + PAR1_B + 1024;
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
static_assert(SMEM1 <= 232448 && SMEM2 <= 232448, "shared memory");
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

// the attn and shortcut rows of fc1's pixels [m0, m0 + 64) (band-relative:
// image, h row, column) into raw by 8-byte cp.async (zero past the band),
// every load in flight at once; rows: scratch for the 64 pixels' offsets,
// and x's in xbuf (-1 outside the band's own rows)
__device__ __forceinline__ void issue_raw(const Tail& t, long long m0, long long M,
                                          unsigned char* raw, long long* rows) {
  if (threadIdx.x < TM) {
    const long long m = m0 + threadIdx.x;
    const int nh = t.hr1 - t.hr0;
    const long long bi = m / ((long long)nh * t.W), q = m % ((long long)nh * t.W);
    const int y = t.hr0 + (int)(q / t.W), x = (int)(q % t.W);
    const bool ok = m < M;
    rows[threadIdx.x] = ok ? bi * t.a_bs + y * t.a_rs + (long long)x * CC : -1;
    rows[TM + threadIdx.x] = ok ? ((bi * t.H + y) * t.W + x) * CC : -1;
    rows[2 * TM + threadIdx.x] =
        ok && y >= t.r0 && y < t.r1 ? ((bi * (t.r1 - t.r0) + y - t.r0) * t.W + x) * CC : -1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * TM * (CC / 4); e += NTW) {
    const int r = e / (CC / 4), c = e % (CC / 4);
    const long long o = rows[r];
    const bf16* src = r < TM ? t.attn : t.sc;
    cp_async8(raw + r * (CC * 2) + c * 8, o < 0 ? src : src + o + c * 4, o >= 0);
  }
}

// x = s + LN1(a) of fc1's pixels from raw: one warp a pixel, four pixels at
// a time, into the tile SW(64, 192) (zero past the band and in channels
// 180..191) and, for the band's own rows, to xbuf: the tail's residual
__device__ void build_x(const Tail& t, const long long* rows, const unsigned char* raw,
                        const bf16* par, unsigned char* xt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int CPL = KC / 32, G = 4;   // 6 channels a lane, pixels at once
  const bf16* ar0 = (const bf16*)raw;
  const bf16* sr0 = ar0 + TM * CC;
  for (int p0 = warp; p0 < TM; p0 += G * (NTW / 32)) {
    float av[G][CPL], sv[G][CPL], s1[G], s2[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = p0 + u * (NTW / 32);
      const bool ok = rows[p] >= 0;
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
      const long long xo = rows[2 * TM + p];
      const float mean = s1[u] / (float)CC;
      const float rstd = rsqrtf(fmaxf(s2[u] / (float)CC - mean * mean, 0.0f) + 1e-5f);
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        float x = 0.0f;
        if (rows[p] >= 0 && c < CC) {
          const float ln = rbf((av[u][i] - mean) * rstd * __bfloat162float(par[c]) +
                               __bfloat162float(par[CC + c]));
          x = rbf(sv[u][i] + ln);
          if (xo >= 0) t.xbuf[xo + c] = __float2bfloat16(x);
        }
        *reinterpret_cast<bf16*>(xt + sw(TM, p, c)) = __float2bfloat16(x);
      }
    }
  }
}

// fc1, persistent: a block keeps all of W1 (packed, 141 KB) and walks
// 64-pixel tiles of the band's h rows; warpgroup g computes hidden channels
// [180 g, 180 g + 180) (n184) while the next tile's attn and shortcut rows
// arrive.  h = gelu(x W1 + b1) leaves through shared memory.  The first
// band's block 0 also zeroes the statistics' totals.
__global__ void __launch_bounds__(NTW, 1) htb_tail_fc1_wg(Tail t) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* w1s = align1k(smem_raw);
  unsigned char* xs = w1s + W1_B;
  unsigned char* raw = xs + X_B;
  long long* rows = (long long*)(raw + RAW_B);
  bf16* par = (bf16*)(raw + RAW_B + ROWS_B);   // ln1 scale, ln1 bias, b1
  const long long M = (long long)t.B * (t.hr1 - t.hr0) * t.W;
  const long long ntiles = (M + TM - 1) / TM;
  const int g = threadIdx.x >> 7;
  if (t.ssum != nullptr && t.r0 == 0 && blockIdx.x == 0) {
    for (int e = threadIdx.x; e < t.B * CC; e += NTW) {
      t.ssum[e] = 0.0f;
      t.smax[e] = -CUDART_INF_F;
    }
  }
  for (int e = threadIdx.x; e < 2 * NH * (KC / 8); e += NTW) {
    const int n = e / (KC / 8), c = e % (KC / 8);
    cp_async16(w1s + (c >> 3) * 2 * NH * 128 + n * 128 + (((c & 7) ^ (n & 7)) << 4),
               t.w1p + (long long)n * KC + c * 8, true);
  }
  for (int e = threadIdx.x; e < (2 * CC + CH) / 4; e += NTW) {
    const int r = e < CC / 4 ? 0 : e < CC / 2 ? 1 : 2;
    const int c = e - r * (CC / 4);
    cp_async8(par + 4 * e, (r == 0 ? t.ln1s : r == 1 ? t.ln1b : t.b1) + 4 * c, true);
  }
  long long tile = blockIdx.x;
  issue_raw(t, tile * TM, M, raw, rows);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (; tile < ntiles; tile += gridDim.x) {
    build_x(t, rows, raw, par, xs);
    fence_proxy_async();
    __syncthreads();   // x is built, raw is read
    const long long next = tile + gridDim.x;
    if (next < ntiles) issue_raw(t, next * TM, M, raw, rows);
    cp_async_commit();
    float acc[NH / 2];
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) acc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KC / 16; ++s)
      wgmma_m64nNk16<NH>(acc, desc(saddr(xs), TM, 0, s), desc(saddr(w1s), 2 * NH, NH * g, s));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) fence_operand(acc[i]);
    // h = gelu(. + b1) in the accumulators (both warpgroups at once), then
    // through xs (read by the products, now done) one warpgroup's 180
    // channels at a time, and to hbuf 8 bytes a thread
#pragma unroll
    for (int i = 0; i < NH / 2; i += 2) {
      const int n = acc_col(i);
      if (n >= CC) continue;
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(par + 2 * CC + CC * g + n));
      const float2 u = rbf2(acc[i], acc[i + 1]);
      const float2 v = rbf2(u.x + b.x, u.y + b.y);
      const float2 h = rbf2(gelu_f(v.x), gelu_f(v.y));
      acc[i] = h.x;
      acc[i + 1] = h.y;
    }
    __syncthreads();
    for (int half = 0; half < 2; ++half) {
      if (g == half) {
#pragma unroll
        for (int i = 0; i < NH / 2; i += 2) {
          const int n = acc_col(i);
          if (n < CC)
            *reinterpret_cast<__nv_bfloat162*>(xs + (acc_row(i) * CC + n) * 2) =
                pack_bf(acc[i], acc[i + 1]);
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < TM * (CC / 4); e += NTW) {
        const int r = e / (CC / 4), c = e % (CC / 4);
        const long long m = tile * TM + r;
        if (m < M)
          *reinterpret_cast<uint2*>(t.hbuf + m * CH + CC * half + c * 4) =
              *reinterpret_cast<const uint2*>(xs + r * (CC * 2) + c * 8);
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();   // the next tile's rows are in; x is read
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
// and max by atomics).
__global__ void __launch_bounds__(NTW, 1) htb_tail_out_wg(Tail t) {
  extern __shared__ unsigned char smem_raw[];
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

// the shapes this path takes (ops/kernels/ffn.py::wgmma_path repeats it)
inline bool takes(int C, int Ch) { return C == CC && Ch == CH; }

// every band of band_rows rows (a multiple of 8, the last band shorter):
// fc1 then the tail
int launch(Tail t, int band_rows, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (band_rows <= 0 || band_rows % TH) return -1;
  if (set_smem(htb_tail_fc1_wg, SMEM1) || set_smem(htb_tail_out_wg, SMEM2)) return -1;
  for (int r0 = 0; r0 < t.H; r0 += band_rows) {
    t.r0 = r0;
    t.r1 = min(t.H, r0 + band_rows);
    t.hr0 = max(0, r0 - 2);
    t.hr1 = min(t.H, t.r1 + 2);
    const long long M = (long long)t.B * (t.hr1 - t.hr0) * t.W, ntiles = (M + TM - 1) / TM;
    htb_tail_fc1_wg<<<(unsigned)(ntiles < sms ? ntiles : sms), NTW, SMEM1, stream>>>(t);
    dim3 grid((t.W + TW - 1) / TW, (t.r1 - t.r0 + TH - 1) / TH, t.B);
    htb_tail_out_wg<<<grid, NTW, SMEM2, stream>>>(t);
  }
  return (int)cudaGetLastError();
}

}  // namespace wgt

int launch_f32(const void* attn, const void* sc, const void* const* wts, void* out,
               float* const* st, void* hbuf, long long a_bs, long long a_rs, int B, int H,
               int W, int C, int Ch, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  if (hbuf == nullptr || C % 4 || Ch % 4 || !aligned(hbuf) || !aligned(wts[2]) ||
      !aligned(wts[6]))
    return -1;
  const size_t s1 = f32k::smem1(C);
  if (set_smem(f32k::htb_tail_fc1_f32, s1) || set_smem(f32k::htb_tail_out_f32, f32k::SMEM2))
    return -1;
  const float* const* w = (const float* const*)wts;
  const long long M = (long long)B * H * W;
  const unsigned nblk1 = (unsigned)((M + f32k::BM1 - 1) / f32k::BM1);
  f32k::htb_tail_fc1_f32<<<nblk1, NT, s1, stream>>>((const float*)attn, a_bs, a_rs,
                                                     (const float*)sc, w[0], w[1], w[2], w[3],
                                                     (float*)hbuf, B, H, W, C, Ch);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  f32k::htb_tail_out_f32<<<grid, NT, f32k::SMEM2, stream>>>(
      (const float*)attn, a_bs, a_rs, (const float*)sc, w[0], w[1], (const float*)hbuf, w[4],
      w[5], w[6], w[7], w[8], w[9], (float*)out, st[0], st[1], st[2], st[3], H, W, C, Ch);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* attn, const void* sc, const void* const* wts, void* out,
                float* const* st, void* hbuf, long long a_bs, long long a_rs, int B, int H,
                int W, int C, int Ch, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (uintptr_t)p % 8 == 0; };
  if (hbuf == nullptr || C % tck::VEC || Ch % tck::VEC || !aligned(hbuf) || !aligned(wts[2]) ||
      !aligned(wts[6]))
    return -1;
  if (set_smem(tck::htb_tail_fc1_kernel, tck::SMEM1) ||
      set_smem(tck::htb_tail_out_kernel, tck::SMEM2))
    return -1;
  const bf16* const* w = (const bf16* const*)wts;
  const long long M = (long long)B * H * W;
  const unsigned nblk1 = (unsigned)((M + tck::BM1 - 1) / tck::BM1);
  tck::htb_tail_fc1_kernel<<<nblk1, NT, tck::SMEM1, stream>>>(
      (const bf16*)attn, a_bs, a_rs, (const bf16*)sc, w[0], w[1], w[2], w[3], (bf16*)hbuf, B, H,
      W, C, Ch);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  tck::htb_tail_out_kernel<<<grid, NT, tck::SMEM2, stream>>>(
      (const bf16*)attn, a_bs, a_rs, (const bf16*)sc, w[0], w[1], (const bf16*)hbuf, w[4], w[5],
      w[6], w[7], w[8], w[9], (bf16*)out, st[0], st[1], st[2], st[3], H, W, C, Ch);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Weights (in the storage dtype): ln1 scale
// and bias (C), W1 (C, Ch), b1 (Ch), dw (5, 5, Ch), dwb (Ch), W2 (Ch, C),
// b2 (C), ln2 scale and bias (C).  attn is (B, >=H, >=W, C) with batch and
// row strides a_bs, a_rs (elements); shortcut/out (B, H, W, C).  With cmean
// non-NULL the kernel also writes cmean/cmax (B, H, W) and psum/pmax
// (B, nblocks, C), nblocks = ceil(H/8) * ceil(W/8), all float32.  hbuf
// is scratch of (B, H, W, Ch) in the storage dtype.  w1p (368, 192) and w2p
// (184, 384) are the wgmma path's packed W1 and W2 (ops/kernels/ffn.py::
// pack_w1, pack_w2) or NULL.  With them the rows go in bands of band_rows
// (a multiple of 8): hbuf is scratch of (B, band_rows + 4, W, Ch), xbuf of
// (B, band_rows, W, C) for x, and psum/pmax are the (B, C) totals.
// Returns cudaGetLastError() after the launches, or -1 for refused shapes.
extern "C" int htb_tail_launch(int dtype, const void* attn, const void* sc, const void* ln1s,
                               const void* ln1b, const void* w1, const void* b1, const void* dw,
                               const void* dwb, const void* w2, const void* b2,
                               const void* ln2s, const void* ln2b, void* out, void* cmean,
                               void* cmax, void* psum, void* pmax, void* hbuf, const void* w1p,
                               const void* w2p, void* xbuf, long long a_bs, long long a_rs,
                               int B, int H, int W, int C, int Ch, int band_rows, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > MAX_C || Ch <= 0) return -1;
  const void* wts[10] = {ln1s, ln1b, w1, b1, dw, dwb, w2, b2, ln2s, ln2b};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && w1p != nullptr) {
    if (!wgt::takes(C, Ch) || w2p == nullptr || xbuf == nullptr || hbuf == nullptr) return -1;
    const bf16* const* w = (const bf16* const*)wts;
    wgt::Tail t{(const bf16*)attn, (const bf16*)sc, w[0], w[1], (const bf16*)w1p, w[3], w[4],
                w[5], (const bf16*)w2p, w[7], w[8], w[9], (bf16*)out, (bf16*)hbuf,
                (bf16*)xbuf, (float*)cmean, (float*)cmax, (float*)psum, (float*)pmax, a_bs,
                a_rs, B, H, W, 0, 0, 0, 0};
    return wgt::launch(t, band_rows, s);
  }
  float* st[4] = {(float*)cmean, (float*)cmax, (float*)psum, (float*)pmax};
  if (dtype == 0)
    return launch_f32(attn, sc, wts, out, st, hbuf, a_bs, a_rs, B, H, W, C, Ch, s);
  if (dtype == 1)
    return launch_bf16(attn, sc, wts, out, st, hbuf, a_bs, a_rs, B, H, W, C, Ch, s);
  return -1;
}

