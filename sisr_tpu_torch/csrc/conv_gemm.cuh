// The implicit-GEMM main loops of the 3x3 convolutions (conv3x3.cu,
// shuffled_tail.cu): a block owns BM rows (output pixels) x BN columns
// (output channels) of the product im2col(input) x weights, K = 9 * Cin.
// The caller says which input pixel each of its rows is (ConvRow) and owns
// the epilogue; the loops gather the im2col tile with the zero 'same'
// padding applied on the fly.
//
// SHUF reads the conv input as the phase-major x2 pixel shuffle of a packed
// (B, H/2, W/2, 4 Cin) array without materializing it: shuffled pixel
// (y, x), channel c lies at [b, y>>1, x>>1, ((x&1)*2 + (y&1))*Cin + c]
// (sisr_tpu/ops/pixel_shuffle.py::pixel_shuffle_phase_major).  A run of
// channels of one pixel stays contiguous, so the 8-byte copies still hold.
#pragma once

#include "common.cuh"

#include <mma.h>

// one row of the GEMM: the conv input pixel (b, y, x); y = kNoRow for a
// row outside every image (its gather is all padding)
struct ConvRow {
  int b, y, x;
};
constexpr int kNoRow = -1000000;

// The gather's address of input pixel (yy, xx), channel ci, for a row at
// pixel (b, py, px): row_base + tap_offset.  H, W, Cin describe the conv
// input (the shuffled image when SHUF).  Plain: the row's own pixel is the
// base and a tap (dy, dx) adds shift = (dy*W + dx)*Cin + ci, the same for
// every row.  SHUF: the base is image b, and the offset inside the image
// (under 2^31 elements) is computed per tap.
template <bool SHUF>
__device__ __forceinline__ long long row_base(const ConvRow& r, int H, int W, int Cin) {
  if (r.y == kNoRow) return 0;
  return SHUF ? (long long)r.b * H * W * Cin : (((long long)r.b * H + r.y) * W + r.x) * Cin;
}
template <bool SHUF>
__device__ __forceinline__ int tap_offset(int yy, int xx, int shift, int ci, int W, int Cin) {
  if (SHUF)
    return ((yy >> 1) * (W >> 1) + (xx >> 1)) * (4 * Cin) + (((xx & 1) << 1) | (yy & 1)) * Cin +
           ci;
  return shift;
}

// ---- FP32 pipes -------------------------------------------------------------
// A thread keeps a TM x TN register tile, reads its TM rows' values as
// float4s from the k-major im2col tile and its TN weights from the weight
// tile, and loads the next K step's gather and weights into registers while
// this step's products run.
namespace fp32c {

constexpr int BK = 16;

template <int BM, int BN, int TM, int TN>
struct Cfg {
  static constexpr int NT = (BM / TM) * (BN / TN);
  static constexpr int A_LD = BM * BK / NT;              // gathered values a thread
  static constexpr int B_LD = (BK * BN + NT - 1) / NT;   // weights a thread
  static constexpr int LDA = BM + 4, LDB = BN + 4;       // As[BK][LDA], Bs[BK][LDB]
  static constexpr size_t SMEM = sizeof(float) * BK * (LDA + LDB);
  static_assert(NT % BK == 0 && (BM * BK) % NT == 0 && TM % 4 == 0, "tile shape");
};

// acc[i][j] += sum_k A[row tm*TM + i][k] * Wt[k][n0 + tn*TN + j] over the
// whole K; As/Bs are 16-byte aligned shared buffers of Cfg's sizes.  Ends
// with every thread past its last read of As/Bs.
template <typename T, int BM, int BN, int TM, int TN, bool SHUF, typename RowFn>
__device__ __forceinline__ void mainloop(float (&acc)[TM][TN], float* As, float* Bs,
                                         const T* __restrict__ y, const T* __restrict__ w,
                                         int H, int W, int Cin, int Cout, int n0, RowFn row_of) {
  typedef Cfg<BM, BN, TM, TN> G;
  const int tid = threadIdx.x;
  const int K = 9 * Cin;
  const int tn = tid % (BN / TN), tm = tid / (BN / TN);

  // the A rows this thread gathers: fixed pixels, one k column per step
  const int a_k = tid % BK;
  int a_py[G::A_LD], a_px[G::A_LD];
  long long a_base[G::A_LD];
#pragma unroll
  for (int i = 0; i < G::A_LD; ++i) {
    const ConvRow r = row_of(tid / BK + i * (G::NT / BK));
    a_py[i] = r.y;
    a_px[i] = r.x;
    a_base[i] = row_base<SHUF>(r, H, W, Cin);
  }
  float a_reg[G::A_LD], b_reg[G::B_LD];

  auto load = [&](int k0) {
    const int k = k0 + a_k;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / Cin : 0;
    const int ci = k - tap * Cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int shift = (dy * W + dx) * Cin + ci;
#pragma unroll
    for (int i = 0; i < G::A_LD; ++i) {
      const int yy = a_py[i] + dy, xx = a_px[i] + dx;
      a_reg[i] = k_ok && yy >= 0 && yy < H && xx >= 0 && xx < W
                     ? to_f<T>(y[a_base[i] + tap_offset<SHUF>(yy, xx, shift, ci, W, Cin)])
                     : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < G::B_LD; ++i) {
      const int e = tid + i * G::NT, kb = k0 + e / BN, n = n0 + e % BN;
      b_reg[i] = e < BK * BN && kb < K && n < Cout ? to_f<T>(w[(long long)kb * Cout + n]) : 0.0f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < G::A_LD; ++i) As[a_k * G::LDA + tid / BK + i * (G::NT / BK)] = a_reg[i];
#pragma unroll
    for (int i = 0; i < G::B_LD; ++i) {
      const int e = tid + i * G::NT;
      if (e < BK * BN) Bs[(e / BN) * G::LDB + e % BN] = b_reg[i];
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  load(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);  // in flight during this step's products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&As[kk * G::LDA + tm * TM + 4 * q]);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * G::LDB + tn * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }
}

}  // namespace fp32c

// ---- bfloat16 on the tensor cores ------------------------------------------
// wmma products of FM x FN x 16 fragments with float32 accumulators.  Each
// K step of BKT = 32 takes one of STAGES buffers in shared memory holding
// the im2col tile (BM x BKT) and the weights (BKT x BN) as bfloat16; the
// buffers are filled by cp.async (zero-filled where the conv pads), STAGES-1
// steps ahead of the products, so the copies need no registers.  The gather
// copies 4 channels (8 bytes) at a time, so Cin % 4 == 0; so do the weights
// where Cout % 4 == 0 (BVEC), else they are loaded one by one.
namespace tcc {

using namespace nvcuda;

constexpr int BKT = 32;
constexpr int VEC = 4;                 // channels per 8-byte copy
constexpr int STAGES = 3;

template <int BM, int BN, int FM, int FN, int WGM, int WGN>
struct Cfg {
  static constexpr int NT = WGM * WGN * 32;
  static constexpr int LDA = BKT + 8, LDB = BN + 8, LDC = BN + 4;
  static constexpr int WTM = BM / WGM, WTN = BN / WGN;      // warp tile
  static constexpr int FRM = WTM / FM, FRN = WTN / FN;      // fragments per warp
  static constexpr int A_LD = BM * (BKT / VEC) / NT;        // gather copies per thread
  static constexpr int B_LD = BKT * BN / NT;                // weights per thread, one by one
  static constexpr int BV_LD = BKT * (BN / VEC) / NT;       // weight copies per thread
  static constexpr int A_EL = BM * LDA, STAGE_EL = BM * LDA + BKT * LDB;
  static constexpr size_t AB_BYTES = sizeof(bf16) * STAGES * STAGE_EL;
  static constexpr size_t C_BYTES = sizeof(float) * BM * LDC;
  static constexpr size_t SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  static_assert(WTM % FM == 0 && WTN % FN == 0, "warp tile");
  static_assert((BM * (BKT / VEC)) % NT == 0 && NT % (BKT / VEC) == 0 &&
                (BKT * BN) % NT == 0, "load split");
};

template <int BM, int BN, int FM, int FN, int WGM, int WGN>
using Acc = wmma::fragment<wmma::accumulator, FM, FN, 16, float>[Cfg<BM, BN, FM, FN, WGM, WGN>::FRM]
                                                               [Cfg<BM, BN, FM, FN, WGM, WGN>::FRN];

// acc (this warp's fragments of the BM x BN tile) = im2col(y) x w over the
// whole K; smem holds Cfg::SMEM bytes, 128-byte aligned.  Ends with every
// copy landed and every thread past its last product, so the caller may
// reuse smem (for Cfg::C_BYTES of float accumulators, say).
template <int BM, int BN, int FM, int FN, int WGM, int WGN, bool BVEC, bool SHUF, typename RowFn>
__device__ __forceinline__ void mainloop(Acc<BM, BN, FM, FN, WGM, WGN>& acc, bf16* smem,
                                         const bf16* __restrict__ y, const bf16* __restrict__ w,
                                         int H, int W, int Cin, int Cout, int n0, RowFn row_of) {
  typedef Cfg<BM, BN, FM, FN, WGM, WGN> G;
  static_assert(!BVEC || (G::BV_LD > 0 && (BKT * (BN / VEC)) % G::NT == 0), "vector split");
  const int tid = threadIdx.x, warp = tid >> 5;
  const int K = 9 * Cin;

  // gather: thread owns channel group g of rows r0 + i * (NT / 8)
  const int g = tid % (BKT / VEC), r0 = tid / (BKT / VEC);
  int a_py[G::A_LD], a_px[G::A_LD];
  long long a_base[G::A_LD];
#pragma unroll
  for (int i = 0; i < G::A_LD; ++i) {
    const ConvRow r = row_of(r0 + i * (G::NT / (BKT / VEC)));
    a_py[i] = r.y;
    a_px[i] = r.x;
    a_base[i] = row_base<SHUF>(r, H, W, Cin);
  }
  const bf16 zero = __float2bfloat16(0.0f);

  // start the copies of K step k0 into buffer s
  auto issue = [&](int s, int k0) {
    bf16* As = smem + s * G::STAGE_EL;
    bf16* Bs = As + G::A_EL;
    const int k = k0 + g * VEC;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / Cin : 0;
    const int ci = k - tap * Cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int shift = (dy * W + dx) * Cin + ci;
#pragma unroll
    for (int i = 0; i < G::A_LD; ++i) {
      const int yy = a_py[i] + dy, xx = a_px[i] + dx;
      const bool ok = k_ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
      cp_async8(As + (r0 + i * (G::NT / (BKT / VEC))) * G::LDA + g * VEC,
                ok ? y + a_base[i] + tap_offset<SHUF>(yy, xx, shift, ci, W, Cin) : y, ok);
    }
    if (BVEC) {
#pragma unroll
      for (int i = 0; i < G::BV_LD; ++i) {
        const int e = tid + i * G::NT, kk = e / (BN / VEC), nv = e % (BN / VEC);
        const int kb = k0 + kk, n = n0 + nv * VEC;
        const bool ok = kb < K && n < Cout;
        cp_async8(Bs + kk * G::LDB + nv * VEC, ok ? w + (long long)kb * Cout + n : w, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < G::B_LD; ++i) {
        const int e = tid + i * G::NT, kk = e / BN, nn = e % BN;
        const int kb = k0 + kk, n = n0 + nn;
        Bs[kk * G::LDB + nn] = (kb < K && n < Cout) ? w[(long long)kb * Cout + n] : zero;
      }
    }
  };

  const int wm = warp / WGN, wn = warp % WGN;
#pragma unroll
  for (int i = 0; i < G::FRM; ++i)
#pragma unroll
    for (int j = 0; j < G::FRN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nsteps = (K + BKT - 1) / BKT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) issue(s, s * BKT);
    cp_async_commit();  // one group per step, empty or not, so the counts line up
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();  // this step's copies have landed
    __syncthreads();              // ... for every thread; the previous step's reads are done
    const int next = step + STAGES - 1;
    if (next < nsteps) issue(next % STAGES, next * BKT);
    cp_async_commit();
    const bf16* As = smem + (step % STAGES) * G::STAGE_EL;
    const bf16* Bs = As + G::A_EL;
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 16) {
      wmma::fragment<wmma::matrix_a, FM, FN, 16, bf16, wmma::row_major> fa[G::FRM];
#pragma unroll
      for (int i = 0; i < G::FRM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * G::WTM + i * FM) * G::LDA + kk, G::LDA);
#pragma unroll
      for (int j = 0; j < G::FRN; ++j) {
        wmma::fragment<wmma::matrix_b, FM, FN, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * G::LDB + wn * G::WTN + j * FN, G::LDB);
#pragma unroll
        for (int i = 0; i < G::FRM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the accumulators into Cs (BM x LDC floats, row-major), for the epilogue
template <int BM, int BN, int FM, int FN, int WGM, int WGN>
__device__ __forceinline__ void store_acc(Acc<BM, BN, FM, FN, WGM, WGN>& acc, float* Cs) {
  typedef Cfg<BM, BN, FM, FN, WGM, WGN> G;
  const int warp = threadIdx.x >> 5, wm = warp / WGN, wn = warp % WGN;
#pragma unroll
  for (int i = 0; i < G::FRM; ++i)
#pragma unroll
    for (int j = 0; j < G::FRN; ++j)
      wmma::store_matrix_sync(Cs + (wm * G::WTM + i * FM) * G::LDC + wn * G::WTN + j * FN,
                              acc[i][j], G::LDC, wmma::mem_row_major);
}

}  // namespace tcc
