// Fused HTB tail: x = s + LN1(attn); h = gelu(x@W1 + b1);
// h2 = h + gelu(dw5x5(h) + dwb); out = x + LN2(h2@W2 + b2); optionally the
// next block's SCA statistics of out (per-pixel channel mean/max, and the
// per-channel sum/max over the image: per-block partials that the caller
// reduces, or on the wgmma path per-block slots of the sums and the
// maxima themselves).
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
//    8x8) in persistent blocks, one an SM, each walking the band's tiles
//    with all of the packed W2 (141 KB) resident.  Its bound is the CUDA
//    cores, not the bytes: the 25 taps, + dwb and the erf gelu of every
//    hidden value are ~45 FP32-pipe instructions against fc2's 360 tensor
//    multiply-adds, ~16k cycles a tile on an SM's 128 lanes (the frame's
//    call ~1.2 ms, against ~0.67 ms for its bytes).  So nothing else may
//    hold the lanes: one thread of a producer warpgroup brings each chunk
//    of 64 hidden channels (h on the halo, its taps and dwb) by TMA
//    through a ring of two stages on mbarriers, the halo's out-of-bounds
//    zero fill being the conv's padding and the band's edge; two consumer
//    warpgroups each take half the tile, a thread one channel pair along
//    a row of 16 outputs (16 independent sums), and leave h2 @ W2 on
//    wgmma running while they compute the next chunk's taps, waiting only
//    on the ring and their own named barrier.  The epilogue works on the
//    accumulators (a row's columns over the lanes of a quad): b2, LN2,
//    the residual, out (staged in shared memory for whole-row stores); the
//    statistics' per-channel sums gather in shared memory and go into the
//    block's slots of the image's sums (added up by the caller in a fixed
//    order, so the bits are the same on every run) and its maxima by
//    atomics as a block leaves the image.  On the H100 a 1080p call takes
//    ~4.0 ms (the 8-warp blocks it replaced, 5.75): the consumers issue ~3
//    instructions a cycle of 4 (csrc/phase_clock.py), so every instruction
//    cut from the taps and gelu shows.
//    The rows go in bands that keep h of a band within 256 MiB (the 1080p
//    frame: 6 bands of 192 rows; fc1 recomputes the conv's 2-row halo of
//    each).
//    Values round to bfloat16 where the plain version rounds them.
//  - float32 (f32k), and bfloat16 at other widths (tck, wmma 16x16x16):
//    the earlier kernels, 64-pixel fc1 blocks and 8x8 tail tiles; the tail
//    stage is htb_tail.cuh's, shared with htb_fused.cu.
// attn may be the window-padded SCC output: it is read through its own
// batch and row strides, rows [0, H) and columns [0, W) only.
#include "htb_tail.cuh"
#include "htb_tail_wg.cuh"

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
// The pieces are in htb_tail_wg.cuh (shared with htb_fused.cu); the
// kernels are here.

namespace wgt {

constexpr int RAW_B = 2 * TM * CC * 2;  // the tile's attn and shortcut rows as loaded
constexpr int ROWS_B = 3 * TM * 8;      // their offsets, and x's
constexpr int SMEM1 = W1_B + X_B + RAW_B + ROWS_B + PAR1_B + 1024;
static_assert(SMEM1 <= 232448, "shared memory");

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

// fc1, persistent: a block keeps all of W1 (packed, 141 KB) and walks
// 64-pixel tiles of the band's h rows; warpgroup g computes hidden channels
// [180 g, 180 g + 180) (n184) while the next tile's attn and shortcut rows
// arrive.  h = gelu(x W1 + b1) leaves through shared memory.  The first
// band's block 0 also sets the statistics' maxima to -inf (the sums' slots
// come zeroed).
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
  if (t.smax != nullptr && t.r0 == 0 && blockIdx.x == 0) {
    for (int e = threadIdx.x; e < t.B * CC; e += NTW) t.smax[e] = -CUDART_INF_F;
  }
  stage_w1(w1s, t.w1p, 0, KC / 64);
  issue_par1(t, par);
  long long tile = blockIdx.x;
  issue_raw(t, tile * TM, M, raw, rows);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (; tile < ntiles; tile += gridDim.x) {
    build_x((const bf16*)raw, (const bf16*)raw + TM * CC, [&](int p) { return rows[p] >= 0; },
            [&](int p) { return rows[2 * TM + p]; }, par, xs, t.xbuf);
    fence_proxy_async();
    __syncthreads();   // x is built, raw is read
    const long long next = tile + gridDim.x;
    if (next < ntiles) issue_raw(t, next * TM, M, raw, rows);
    cp_async_commit();
    float acc[NH / 2];
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) acc[i] = 0.0f;
    const uint32_t w1b = saddr(w1s);
    const uint32_t w1[KC / 64] = {w1b, w1b + 2 * NH * 128, w1b + 4 * NH * 128};
    wgmma_fence();
    fc1_product<0, KC / 16>(acc, saddr(xs), w1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) fence_operand(acc[i]);
    // h = gelu(. + b1) in the accumulators (both warpgroups at once), then
    // through xs (read by the products, now done) one warpgroup's 180
    // channels at a time, and to hbuf 8 bytes a thread
    fc1_gelu(acc, par + 2 * CC + CC * g);
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

// the tail over the band's 8 x 16 tiles (htb_tail_wg.cuh::tail_out)
__global__ void __launch_bounds__(NTT, 1)
    htb_tail_out_wg(const Tail t, const __grid_constant__ TailMaps m) {
  extern __shared__ unsigned char smem_raw[];
  tail_out(t, m, smem_raw);
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
  if (set_smem(htb_tail_fc1_wg, SMEM1)) return -1;
  for (int r0 = 0; r0 < t.H; r0 += band_rows) {
    t.r0 = r0;
    t.r1 = min(t.H, r0 + band_rows);
    t.hr0 = max(0, r0 - 2);
    t.hr1 = min(t.H, t.r1 + 2);
    const long long M = (long long)t.B * (t.hr1 - t.hr0) * t.W, ntiles = (M + TM - 1) / TM;
    htb_tail_fc1_wg<<<(unsigned)(ntiles < sms ? ntiles : sms), NTW, SMEM1, stream>>>(t);
    const int err = launch_tail(htb_tail_out_wg, t, stream);
    if (err) return err;
  }
  return 0;
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
// (B, band_rows, W, C) for x, psum the (2 x SMs, B, C) slots of the sums,
// zeroed (ops/kernels/ffn.py::totals_buffers), pmax the (B, C) maxima.
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

