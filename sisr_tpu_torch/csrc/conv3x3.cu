// 3x3 same-padded convolution + bias, then leaky ReLU (none / 0.01 / 0.2),
// then an optional residual, NHWC activations, HWIO weights; optionally over
// the phase-major x2 pixel shuffle of a packed input (shuf = 1; the kernels
// shuffled_conv_*, the plain ones conv3x3_*).
//
// Replaces sisr_tpu/ops/pallas/conv3x3.py::_conv3x3_pallas (its _conv_kernel
// body) and, with shuf, ::_conv3x3_shuffled_pallas (_shuffled_conv_kernel,
// the x4 head's conv_up2 reading conv_up1's packed output).  The TPU kernels
// walk row bands in order with one-row halos carried beside the band, and
// the shuffled one interleaves the packed band in VMEM; here every block is
// independent and the shuffle is only an address computation in the gather
// (conv_gemm.cuh), so the x2 map never exists in device memory.
//
// Bound on the H100: the model's shapes are GEMMs of M = H*W pixels,
// N = Cout, K = 9*Cin (180->180 at 192^2: 21.5 GFLOP over 27 MB in f32;
// conv_up2 at 384^2, 64->256: 43.5 GFLOP over ~94 MB in bf16), so the
// convolutions are bound by arithmetic, not bytes.  Every kernel is an
// implicit GEMM: a block owns a tile of (pixel, Cout); each K step stages
// a slice of (tap, Cin) columns of the im2col matrix, gathered from the
// input with the zero 'same' padding applied on the fly, and the matching
// weights in shared memory.
//
// The plain convolution (conv3x3, shuf = 0) at the model's shapes:
// - bfloat16 on wgmma (conv3x3_wgmma_*): one or two consumer warpgroups of
//   64 output pixels each, and one N tile that holds all of Cout (n64,
//   n128, n184 or n256), so the im2col rows are gathered once per output
//   tile.  K steps of 64 (128 bytes, one 128-byte swizzle row) go through
//   a ring of 4 stages in dynamic shared memory, filled with cp.async by
//   every thread and read by wgmma through K-major 128B-swizzle
//   descriptors (wgmma.cuh).  A pixel of 180 bfloat16 channels is 360
//   bytes, 8-byte but not 16-byte aligned, so neither TMA nor 16-byte
//   copies reach the activations: A is gathered with 8-byte copies (4
//   channels, which never straddle a tap since Cin % 4 == 0; zero-filled
//   where the conv pads, from a 9-bit mask of the taps inside the image
//   per row) straight into the swizzled layout.  B is the weights packed
//   outside autograd into (Npad, Kpad) rows, K-major in the flat-K order
//   tap-major, Cin inner, zero past Cout and K
//   (ops/kernels/conv3x3.py::pack_weights), read with 16-byte copies into
//   the same swizzled layout; no tensor map.  Loads run two K steps ahead
//   of the products and one wgmma group stays in flight while the next
//   step's copies are issued.  The epilogue works on the accumulator
//   registers: bias, leaky ReLU, residual, and one __nv_bfloat162 store
//   per adjacent column pair.
// - float32 on the FP32 pipes (conv3x3_f32_*, so that it keeps float32
//   products): an 8x8 register tile a thread, float4 reads of both
//   operands, Cout in N tiles of 64, 96 or 128 (two tiles of 96 for 180),
//   16-byte cp.async copies in a ring of 3 stages for the gather (4
//   channels a copy) and the HWIO weights.
// Both take 64-row blocks where 128-row blocks would not fill two waves of
// the card's resident blocks (use_64_rows: 128 rows at a 192x192 tile and a
// frame, 64 at a training step's 2x64x64 and for n64 at a tile; a 192x192
// tile's 288 blocks of 128 rows are 2.18 waves at one block an SM, and no
// height removes that tail).  The rule is explicit in
// dispatch(): the wgmma path needs Cin % 4 == 0, an even Cout no wider
// than the packed tile (<= 256), the packed weights and aligned pointers;
// the float32 path Cin % 4 == 0, Cout % 4 == 0, Cout > 8 and 16-byte
// aligned pointers.  Any other shape, and the shuffled convolution, take
// the loops of conv_gemm.cuh (wmma with cp.async stages in bfloat16,
// register-staged FP32 tiles in float32).
#include "conv_gemm.cuh"
#include "wgmma.cuh"

#include <cstdint>
#include <type_traits>

namespace {

// the GEMM row r of a block starting at output pixel m0 (rows past M are
// padding)
struct FlatRows {
  long long m0, M;
  int H, W;
  __device__ ConvRow operator()(int r) const {
    const long long m = m0 + r;
    if (m >= M) return ConvRow{0, kNoRow, 0};
    const long long hw = (long long)H * W;
    const long long p = m % hw;
    return ConvRow{(int)(m / hw), (int)(p / W), (int)(p % W)};
  }
};

template <typename T, int BM, int BN, int TM, int TN, bool SHUF>
__device__ __forceinline__ void conv3x3_fp32_body(const T* __restrict__ y, const T* __restrict__ res,
                                                  const T* __restrict__ w,
                                                  const T* __restrict__ bias, T* __restrict__ out,
                                                  int B, int H, int W, int Cin, int Cout,
                                                  int act) {
  typedef fp32c::Cfg<BM, BN, TM, TN> G;
  __shared__ __align__(16) float As[fp32c::BK * G::LDA];  // k-major: TM pixels are float4s
  __shared__ __align__(16) float Bs[fp32c::BK * G::LDB];

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tn = tid % (BN / TN), tm = tid / (BN / TN);

  float acc[TM][TN];
  fp32c::mainloop<T, BM, BN, TM, TN, SHUF>(acc, As, Bs, y, w, H, W, Cin, Cout, n0,
                                           FlatRows{m0, M, H, W});

  const float slope = act == 1 ? 0.01f : 0.2f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + tm * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n >= Cout) continue;
      float v = acc[i][j] + to_f<T>(bias[n]);
      if (act) v = leaky_f(v, slope);
      if (res) v += to_f<T>(res[m * Cout + n]);
      out[m * Cout + n] = from_f<T>(v);
    }
  }
}

template <int BM, int BN, int FM, int FN, int WGM, int WGN, bool BVEC, bool SHUF>
__device__ __forceinline__ void conv3x3_tc_body(const bf16* __restrict__ y,
                                                const bf16* __restrict__ res,
                                                const bf16* __restrict__ w,
                                                const bf16* __restrict__ bias,
                                                bf16* __restrict__ out, int B, int H, int W,
                                                int Cin, int Cout, int act) {
  typedef tcc::Cfg<BM, BN, FM, FN, WGM, WGN> G;
  static_assert(G::SMEM <= 48 * 1024, "static shared memory");
  __shared__ __align__(128) unsigned char smem_raw[G::SMEM];
  float* Cs = reinterpret_cast<float*>(smem_raw);   // BM x LDC, after the K loop

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  tcc::Acc<BM, BN, FM, FN, WGM, WGN> acc;
  tcc::mainloop<BM, BN, FM, FN, WGM, WGN, BVEC, SHUF>(
      acc, reinterpret_cast<bf16*>(smem_raw), y, w, H, W, Cin, Cout, n0, FlatRows{m0, M, H, W});
  tcc::store_acc<BM, BN, FM, FN, WGM, WGN>(acc, Cs);
  __syncthreads();

  const float slope = act == 1 ? 0.01f : 0.2f;
  for (int e = tid; e < BM * BN; e += G::NT) {
    const int r = e / BN, c = e % BN;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= Cout) continue;
    float v = Cs[r * G::LDC + c] + __bfloat162float(bias[n]);
    if (act) v = leaky_f(v, slope);
    if (res) v += __bfloat162float(res[m * Cout + n]);
    out[m * Cout + n] = __float2bfloat16(v);
  }
}

// The plain and the shuffled convolution under names of their own, so that a
// profile tells them apart by prefix (conv3x3_*, shuffled_conv_*)
#define CONV_PARAMS(T)                                                                   \
  const T *__restrict__ y, const T *__restrict__ res, const T *__restrict__ w,          \
      const T *__restrict__ bias, T *__restrict__ out, int B, int H, int W, int Cin, \
      int Cout, int act
#define CONV_ARGS y, res, w, bias, out, B, H, W, Cin, Cout, act

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) conv3x3_kernel(CONV_PARAMS(T)) {
  conv3x3_fp32_body<T, BM, BN, TM, TN, false>(CONV_ARGS);
}

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) shuffled_conv_kernel(CONV_PARAMS(T)) {
  conv3x3_fp32_body<T, BM, BN, TM, TN, true>(CONV_ARGS);
}

template <int BM, int BN, int FM, int FN, int WGM, int WGN, bool BVEC>
__global__ void __launch_bounds__(WGM * WGN * 32, 2) conv3x3_tc_kernel(CONV_PARAMS(bf16)) {
  conv3x3_tc_body<BM, BN, FM, FN, WGM, WGN, BVEC, false>(CONV_ARGS);
}

template <int BM, int BN, int FM, int FN, int WGM, int WGN, bool BVEC>
__global__ void __launch_bounds__(WGM * WGN * 32, 2) shuffled_conv_tc_kernel(CONV_PARAMS(bf16)) {
  conv3x3_tc_body<BM, BN, FM, FN, WGM, WGN, BVEC, true>(CONV_ARGS);
}

// ---- bfloat16 on wgmma -------------------------------------------------------
namespace wg {

constexpr int BK = 64;      // K step: 64 bfloat16, one 128-byte swizzle row
constexpr int GROUPS = BK / tcc::VEC;   // 8-byte gather copies per row and step
constexpr int EPI = 8;                  // column blocks of 8 whose epilogue loads go together
constexpr int STAGES = 4;

template <int WGS, int BN, int STAGES>
struct Cfg {
  static constexpr int BM = 64 * WGS, NT = 128 * WGS;
  static constexpr int A_BYTES = BM * 128, STAGE = (BM + BN) * 128;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024;   // + 1024-byte alignment
  static constexpr int RS = NT / GROUPS;        // rows between a thread's gather rows
  static constexpr int A_LD = BM / RS;          // gather rows a thread
  static constexpr int B_CP = BN * 8;           // 16-byte weight copies a step
  static constexpr int B_LD = (B_CP + NT - 1) / NT;
  static_assert(BN % 8 == 0 && BN <= 256 && RS % 8 == 0, "tile shape");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

}  // namespace wg

// out[m, n] = act(sum_k A[m, k] wp[n, k] + bias[n]) (+ res[m, n]) for a
// BM-row block; wp is the packed (BN, Kpad) weight matrix, A the im2col of y
template <int WGS, int BN, int STAGES>
__global__ void __launch_bounds__(128 * WGS, 1)
conv3x3_wgmma_kernel(const bf16* __restrict__ y, const bf16* __restrict__ res,
                     const bf16* __restrict__ wp, const bf16* __restrict__ bias,
                     bf16* __restrict__ out, int B, int H, int W, int Cin, int Cout, int Kpad,
                     int act) {
  typedef wg::Cfg<WGS, BN, STAGES> G;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;    // the swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * G::BM;
  const int K = 9 * Cin, nsteps = Kpad / wg::BK;

  // gather: this thread copies channel group g (4 channels) of rows
  // r0 + i * RS; every such row has r0 % 8 as its row in the swizzle
  const int g = tid % wg::GROUPS, r0 = tid / wg::GROUPS;
  const uint32_t a_off = (uint32_t)r0 * 128 + ((((g >> 1) ^ (r0 & 7)) << 4) | ((g & 1) << 3));
  int a_mask[G::A_LD];   // bit t: tap t of the row's pixel lies inside the image
#pragma unroll
  for (int i = 0; i < G::A_LD; ++i) {
    const long long m = m0 + r0 + i * G::RS;
    int mask = 0;
    if (m < M) {
      const int p = (int)(m % ((long long)H * W)), py = p / W, px = p % W;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = py + t / 3 - 1, xx = px + t % 3 - 1;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) mask |= 1 << t;
      }
    }
    a_mask[i] = mask;
  }

  // start the copies of K step `step` into stage s
  auto issue = [&](int s, int step) {
    unsigned char* sa = smem + s * G::STAGE;
    unsigned char* sb = sa + G::A_BYTES;
    const int k = step * wg::BK + g * tcc::VEC;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / Cin : 0;
    const int shift = ((tap / 3 - 1) * W + (tap % 3 - 1)) * Cin + (k - tap * Cin);
#pragma unroll
    for (int i = 0; i < G::A_LD; ++i) {
      const bool ok = k_ok && ((a_mask[i] >> tap) & 1);
      const long long src = (m0 + r0 + i * G::RS) * Cin + shift;
      cp_async8(sa + a_off + i * G::RS * 128, ok ? y + src : y, ok);
    }
#pragma unroll
    for (int j = 0; j < G::B_LD; ++j) {
      const int e = tid + j * G::NT;
      if (G::B_CP % G::NT == 0 || e < G::B_CP) {
        const int n = e >> 3, c = e & 7;
        cp_async16(sb + n * 128 + ((c ^ (n & 7)) << 4),
                   wp + (long long)n * Kpad + step * wg::BK + c * 8, true);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nsteps) issue(s, s);
    cp_async_commit();   // one group per step, empty or not, so the counts line up
  }
  const int wgi = tid / 128;
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 3>();   // this thread's copies of `step` landed
    fence_proxy_async();
    // every thread's copies landed, and every warpgroup is past the wgmma
    // of step - 2, whose stage the copies below refill
    __syncthreads();
    const uint32_t sa = base + (step % STAGES) * G::STAGE;
    const uint32_t sb = sa + G::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < wg::BK / 16; ++kk)
      wgmma_m64nNk16<BN>(acc, sw128_desc(sa + wgi * 64 * 128 + kk * 32),
                         sw128_desc(sb + kk * 32));
    wgmma_commit();
    const int next = step + STAGES - 2;
    if (next < nsteps) issue(next % STAGES, next);
    cp_async_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

  // accumulator j*4 + h*2 + e of this thread: row 16 * warp + lane / 4 + 8h,
  // column 8j + 2 (lane % 4) + e of the warpgroup's 64 x BN tile.  The
  // bias and residual pairs of EPI column blocks are loaded together
  // before any of their stores, so that their latencies overlap.
  const int lt = tid % 128, warp = lt / 32, lane = lt % 32;
  const long long row0 = m0 + wgi * 64 + warp * 16 + lane / 4;
  const float slope = act == 1 ? 0.01f : 0.2f;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += wg::EPI) {
    __nv_bfloat162 bv[wg::EPI], rv[wg::EPI][2];
#pragma unroll
    for (int jj = 0; jj < wg::EPI; ++jj) {
      const int c = 8 * (j0 + jj) + 2 * (lane % 4);
      const bool col = j0 + jj < BN / 8 && c < Cout;
      bv[jj] = col ? __halves2bfloat162(bias[c], bias[c + 1]) : zero2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = row0 + 8 * h;
        rv[jj][h] = res && col && m < M
                        ? *reinterpret_cast<const __nv_bfloat162*>(res + m * Cout + c)
                        : zero2;
      }
    }
#pragma unroll
    for (int jj = 0; jj < wg::EPI; ++jj) {
      const int j = j0 + jj, c = 8 * j + 2 * (lane % 4);
      if (j >= BN / 8 || c >= Cout) continue;
      const float2 b = __bfloat1622float2(bv[jj]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = row0 + 8 * h;
        if (m >= M) continue;
        float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
        if (act) {
          v0 = leaky_f(v0, slope);
          v1 = leaky_f(v1, slope);
        }
        const float2 r = __bfloat1622float2(rv[jj][h]);
        *reinterpret_cast<__nv_bfloat162*>(out + m * Cout + c) =
            __floats2bfloat162_rn(v0 + r.x, v1 + r.y);
      }
    }
  }
}

// ---- float32 on the FP32 pipes ---------------------------------------------
namespace f32k {

constexpr int BK = 16, TM = 8, TN = 8, STAGES = 3;

template <int BM, int BN>
struct Cfg {
  static constexpr int NT = (BM / TM) * (BN / TN);
  static constexpr int LDA = BK + 4, LDB = BN + 4;      // As[BM][LDA], Bs[BK][LDB]
  static constexpr int STAGE_EL = BM * LDA + BK * LDB;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE_EL;
  static constexpr int A_CP = BM * BK / 4, B_CP = BK * BN / 4;    // 16-byte copies a step
  static constexpr int A_LD = (A_CP + NT - 1) / NT, B_LD = (B_CP + NT - 1) / NT;
  static_assert(NT % 4 == 0 && BN % 8 == 0, "tile shape");
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

}  // namespace f32k

// out = act(im2col(y) x w + bias) (+ res) for a BM x BN tile; w is HWIO,
// (9 Cin, Cout) row-major.  A thread owns rows tm + i BM/TM (i < 8) and
// columns tn*4 + j, BN/2 + tn*4 + j (j < 4), so that its float4 reads of
// either operand fall on distinct banks across a quarter warp.
template <int BM, int BN>
__global__ void __launch_bounds__((BM / f32k::TM) * (BN / f32k::TN))
conv3x3_f32_kernel(const float* __restrict__ y, const float* __restrict__ res,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ out, int B, int H, int W, int Cin, int Cout, int act) {
  using namespace f32k;
  typedef Cfg<BM, BN> G;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin, nsteps = (K + BK - 1) / BK;

  // gather: this thread copies channels 4q..4q+3 of the step for rows
  // (tid / 4) + i NT/4 (NT % 4 == 0, so q is the same for every i)
  const int q = tid & 3;
  int a_mask[G::A_LD];
#pragma unroll
  for (int i = 0; i < G::A_LD; ++i) {
    const int r = (tid >> 2) + i * (G::NT / 4);
    const long long m = m0 + r;
    int mask = 0;
    if (r < BM && m < M) {
      const int p = (int)(m % ((long long)H * W)), py = p / W, px = p % W;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = py + t / 3 - 1, xx = px + t % 3 - 1;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) mask |= 1 << t;
      }
    }
    a_mask[i] = mask;
  }

  auto issue = [&](int s, int step) {
    float* As = smem + s * G::STAGE_EL;
    float* Bs = As + BM * G::LDA;
    const int k0 = step * BK;
    const int k = k0 + 4 * q;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / Cin : 0;
    const int shift = ((tap / 3 - 1) * W + (tap % 3 - 1)) * Cin + (k - tap * Cin);
#pragma unroll
    for (int i = 0; i < G::A_LD; ++i) {
      const int r = (tid >> 2) + i * (G::NT / 4);
      if (G::A_CP % G::NT == 0 || r < BM) {
        const bool ok = k_ok && ((a_mask[i] >> tap) & 1);
        cp_async16(As + r * G::LDA + 4 * q, ok ? y + (m0 + r) * Cin + shift : y, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < G::B_LD; ++i) {
      const int e = tid + i * G::NT;
      if (G::B_CP % G::NT == 0 || e < G::B_CP) {
        const int kk = e / (BN / 4), n = n0 + 4 * (e % (BN / 4));
        const bool ok = k0 + kk < K && n < Cout;
        cp_async16(Bs + kk * G::LDB + 4 * (e % (BN / 4)),
                   ok ? w + (long long)(k0 + kk) * Cout + n : w, ok);
      }
    }
  };

  const int tn = tid % (BN / TN), tm = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) issue(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();   // this step's copies have landed
    __syncthreads();               // ... for every thread; the previous step's reads are done
    const int next = step + STAGES - 1;
    if (next < nsteps) issue(next % STAGES, next);
    cp_async_commit();
    const float* As = smem + (step % STAGES) * G::STAGE_EL;
    const float* Bs = As + BM * G::LDA;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (tm + i * (BM / TM)) * G::LDA + 4 * kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (4 * kq + kk) * G::LDB;
        const float4 b0 = *reinterpret_cast<const float4*>(brow + 4 * tn);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + BN / 2 + 4 * tn);
        const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = comp(a[i], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const float slope = act == 1 ? 0.01f : 0.2f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + h * (BN / 2) + 4 * tn;
    if (n >= Cout) continue;   // Cout % 4 == 0: the four columns are all in or all out
    const float4 bb = *reinterpret_cast<const float4*>(bias + n);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + tm + i * (BM / TM);
      if (m >= M) continue;
      float v[4] = {acc[i][4 * h] + bb.x, acc[i][4 * h + 1] + bb.y, acc[i][4 * h + 2] + bb.z,
                    acc[i][4 * h + 3] + bb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (act) v[e] = leaky_f(v[e], slope);
      if (res) {
        const float4 r = *reinterpret_cast<const float4*>(res + m * Cout + n);
        v[0] += r.x;
        v[1] += r.y;
        v[2] += r.z;
        v[3] += r.w;
      }
      *reinterpret_cast<float4*>(out + m * Cout + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

struct Args {
  const void *y, *res, *w, *wp, *bias;
  void* out;
  int B, H, W, Cin, Cout, npad, act;
  cudaStream_t stream;
};

// the card's SM count and a kernel's resident blocks per SM, asked once
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return n > 0 ? n : 1;
}

// 64 rows a block where 128-row blocks would not fill two waves of the
// card's resident blocks (a training step's 2x64x64 map; a narrow Cout
// whose blocks fit twice on an SM), else 128 (fewer weight reads).
// Measured on the H100 at the model's shapes (PERF.md, conv3x3 findings).
bool use_64_rows(long long m, int n_tiles, int bps128) {
  return (m + 127) / 128 * n_tiles < 2LL * sm_count() * bps128;
}

template <int WGS, int BN, int STAGES>
int launch_wgmma_bm(const Args& a) {
  typedef wg::Cfg<WGS, BN, STAGES> G;
  auto kern = conv3x3_wgmma_kernel<WGS, BN, STAGES>;
  if (set_smem(kern, G::SMEM)) return -1;
  const long long M = (long long)a.B * a.H * a.W;
  const int kpad = (9 * a.Cin + wg::BK - 1) / wg::BK * wg::BK;
  kern<<<(unsigned)((M + G::BM - 1) / G::BM), G::NT, G::SMEM, a.stream>>>(
      (const bf16*)a.y, (const bf16*)a.res, (const bf16*)a.wp, (const bf16*)a.bias,
      (bf16*)a.out, a.B, a.H, a.W, a.Cin, a.Cout, kpad, a.act);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_wgmma(const Args& a) {
  typedef wg::Cfg<2, BN, wg::STAGES> G;
  static int bps = 0;   // resident 128-row blocks per SM
  if (!bps) {
    if (set_smem(conv3x3_wgmma_kernel<2, BN, wg::STAGES>, G::SMEM)) return -1;
    bps = blocks_per_sm(conv3x3_wgmma_kernel<2, BN, wg::STAGES>, G::NT, G::SMEM);
  }
  const long long M = (long long)a.B * a.H * a.W;
  return use_64_rows(M, 1, bps) ? launch_wgmma_bm<1, BN, wg::STAGES>(a)
                                : launch_wgmma_bm<2, BN, wg::STAGES>(a);
}

template <int BM, int BN>
int launch_f32_bm(const Args& a) {
  typedef f32k::Cfg<BM, BN> G;
  auto kern = conv3x3_f32_kernel<BM, BN>;
  if (set_smem(kern, G::SMEM)) return -1;
  const long long M = (long long)a.B * a.H * a.W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((a.Cout + BN - 1) / BN));
  kern<<<grid, G::NT, G::SMEM, a.stream>>>((const float*)a.y, (const float*)a.res,
                                           (const float*)a.w, (const float*)a.bias,
                                           (float*)a.out, a.B, a.H, a.W, a.Cin, a.Cout, a.act);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_f32(const Args& a) {
  typedef f32k::Cfg<128, BN> G;
  static int bps = 0;
  if (!bps) {
    if (set_smem(conv3x3_f32_kernel<128, BN>, G::SMEM)) return -1;
    bps = blocks_per_sm(conv3x3_f32_kernel<128, BN>, G::NT, G::SMEM);
  }
  const long long M = (long long)a.B * a.H * a.W;
  return use_64_rows(M, (a.Cout + BN - 1) / BN, bps) ? launch_f32_bm<64, BN>(a)
                                                     : launch_f32_bm<128, BN>(a);
}

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

// the wgmma path's shape rule (ops/kernels/conv3x3.py::wgmma_width states
// the same): Cin % 4 == 0 for the 8-byte gather, an even Cout (column
// pairs) within the packed width, and aligned pointers
bool wgmma_ok(const Args& a) {
  return a.wp && a.Cin % tcc::VEC == 0 && a.Cout % 2 == 0 && a.Cout <= a.npad &&
         (a.npad == 64 || a.npad == 128 || a.npad == 184 || a.npad == 256) &&
         aligned(a.y, 8) && aligned(a.wp, 16) && aligned(a.out, 4) && aligned(a.bias, 2) &&
         (!a.res || aligned(a.res, 4));
}

// the float32 path's: 16-byte copies of 4 channels and float4 epilogues
bool f32_ok(const Args& a) {
  return a.Cin % 4 == 0 && a.Cout % 4 == 0 && a.Cout > 8 && aligned(a.y, 16) &&
         aligned(a.w, 16) && aligned(a.out, 16) && aligned(a.bias, 16) &&
         (!a.res || aligned(a.res, 16));
}

template <int BM, int BN, int FM, int FN, int WGM, int WGN, bool BVEC, bool SHUF>
int launch_tc(const Args& a) {
  const long long M = (long long)a.B * a.H * a.W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((a.Cout + BN - 1) / BN));
  auto kern = SHUF ? shuffled_conv_tc_kernel<BM, BN, FM, FN, WGM, WGN, BVEC>
                    : conv3x3_tc_kernel<BM, BN, FM, FN, WGM, WGN, BVEC>;
  kern<<<grid, WGM * WGN * 32, 0, a.stream>>>(
      (const bf16*)a.y, (const bf16*)a.res, (const bf16*)a.w, (const bf16*)a.bias, (bf16*)a.out,
      a.B, a.H, a.W, a.Cin, a.Cout, a.act);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN, int TM, int TN, bool SHUF>
int launch_fp32(const Args& a) {
  const long long M = (long long)a.B * a.H * a.W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((a.Cout + BN - 1) / BN));
  auto kern = SHUF ? shuffled_conv_kernel<T, BM, BN, TM, TN> : conv3x3_kernel<T, BM, BN, TM, TN>;
  kern<<<grid, (BM / TM) * (BN / TN), 0, a.stream>>>(
      (const T*)a.y, (const T*)a.res, (const T*)a.w, (const T*)a.bias, (T*)a.out, a.B, a.H, a.W,
      a.Cin, a.Cout, a.act);
  return (int)cudaGetLastError();
}

template <typename T, bool SHUF>
int dispatch(const Args& a) {
  if (!SHUF && std::is_same<T, bf16>::value && wgmma_ok(a)) {
    if (a.npad == 64) return launch_wgmma<64>(a);
    if (a.npad == 128) return launch_wgmma<128>(a);
    if (a.npad == 184) return launch_wgmma<184>(a);
    return launch_wgmma<256>(a);
  }
  if (!SHUF && std::is_same<T, float>::value && f32_ok(a)) {
    // the N tile that pads Cout least, the wider one on a tie (180: 2 x 96)
    const int p64 = (a.Cout + 63) / 64 * 64, p96 = (a.Cout + 95) / 96 * 96,
              p128 = (a.Cout + 127) / 128 * 128;
    if (p128 <= p96 && p128 <= p64) return launch_f32<128>(a);
    if (p96 <= p64) return launch_f32<96>(a);
    return launch_f32<64>(a);
  }
  // bfloat16 on the tensor cores: the 8-byte copies need Cin % 4 == 0 and an
  // aligned input, and for the weights Cout % 4 == 0 and an aligned w, or
  // Cout <= 8 (conv_last: 32x8 fragments, one column tile, weights loaded
  // one by one); other shapes take the FP32 kernel
  if (std::is_same<T, bf16>::value && a.Cin % tcc::VEC == 0 && (uintptr_t)a.y % 8 == 0) {
    if (a.Cout <= 8) return launch_tc<128, 8, 32, 8, 4, 1, false, SHUF>(a);
    if (a.Cout % tcc::VEC == 0 && (uintptr_t)a.w % 8 == 0)
      return launch_tc<128, 64, 16, 16, 4, 2, true, SHUF>(a);
  }
  if (a.Cout <= 8) return launch_fp32<T, 256, 8, 4, 2, SHUF>(a);
  return launch_fp32<T, 128, 64, 8, 4, SHUF>(a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  act: 0 none, 1 leaky 0.01, 2 leaky 0.2.
// res may be NULL.  H, W, Cin are those of the conv input; with shuf = 1
// that input is the phase-major x2 shuffle of y (B, H/2, W/2, 4 Cin).
// wp (may be NULL): w packed for the wgmma path, (npad, Kpad) bfloat16,
// Kpad = 9 Cin rounded up to 64.  Returns cudaGetLastError() after the
// launch, or -1 for arguments the kernel refuses.
extern "C" int conv3x3_launch(int dtype, const void* y, const void* res, const void* w,
                              const void* wp, const void* bias, void* out, int B, int H, int W,
                              int Cin, int Cout, int npad, int act, int shuf, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || act < 0 || act > 2) return -1;
  // the shuffled gather's offset inside one image is a 32-bit int
  if (shuf && (H % 2 || W % 2 || (long long)H * W * Cin >= (1LL << 31))) return -1;
  // the plain gather's tap shift is a 32-bit int
  if ((long long)(W + 1) * Cin >= (1LL << 31)) return -1;
  const Args a{y, res, w, wp, bias, out, B, H, W, Cin, Cout, npad, act, (cudaStream_t)stream};
  if (dtype == 0) return shuf ? dispatch<float, true>(a) : dispatch<float, false>(a);
  if (dtype == 1) return shuf ? dispatch<bf16, true>(a) : dispatch<bf16, false>(a);
  return -1;
}
