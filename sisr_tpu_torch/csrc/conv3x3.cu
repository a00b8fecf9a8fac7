// 3x3 same-padded convolution + bias, then leaky ReLU (none / 0.01 / 0.2),
// then an optional residual, NHWC activations, HWIO weights.
//
// Replaces sisr_tpu/ops/pallas/conv3x3.py::_conv3x3_pallas (its _conv_kernel
// body).  The TPU kernel walks row bands in order with one-row halos carried
// beside the band; here every block is independent.
//
// Bound on the H100: the model's shapes are GEMMs of M = H*W pixels,
// N = Cout, K = 9*Cin (180->180 at 192^2: 21.5 GFLOP over 27 MB in f32),
// so the convolutions are bound by arithmetic, not bytes (the 768^2 head
// convs, with the most bytes, sit near the ridge).  Design: an implicit
// GEMM.  A block owns a BM x BN tile of (pixel, Cout); each K step stages BK
// (tap, Cin) columns of the im2col matrix, gathered from the input with the
// zero 'same' padding applied on the fly, and the matching BK x BN weights
// in shared memory.  K = 9*Cin needs no alignment (Cin = 180 or 64), and
// ragged M and N are masked, so Cout from 3 to 256 run unchanged; Cout <= 8
// (conv_last, Cout = 3) takes a narrow-N tile, so 3 of 8 columns are used,
// not 3 of 64.  float32 runs on the FP32 pipes (conv3x3_kernel), so that
// it stays exact; bfloat16 runs on the tensor cores (wmma, float32
// accumulators; namespace tcc).  wgmma / TMA tiles are later work.
#include "common.cuh"

#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BK = 16;

// The FP32-pipe kernel (float32, and bfloat16 shapes the tensor-core
// kernel does not take): a thread keeps a TM x TN register tile, reads its
// TM pixels' values as float4s from the k-major im2col tile and its TN
// weights from the weight tile, and loads the next K step's gather and
// weights into registers while this step's products run.
template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv3x3_kernel(const T* __restrict__ y, const T* __restrict__ res,
               const T* __restrict__ w, const T* __restrict__ bias,
               T* __restrict__ out, int B, int H, int W, int Cin, int Cout, int act) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int A_LD = BM * BK / NT;              // gathered values a thread
  constexpr int B_LD = (BK * BN + NT - 1) / NT;   // weights a thread
  static_assert(NT % BK == 0 && (BM * BK) % NT == 0 && TM % 4 == 0, "tile shape");
  __shared__ __align__(16) float As[BK][BM + 4];  // k-major: TM pixels are float4s
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const int tn = tid % (BN / TN), tm = tid / (BN / TN);

  // the A rows this thread gathers: fixed pixels, one k column per step
  const int a_k = tid % BK;
  int a_py[A_LD], a_px[A_LD];
  long long a_base[A_LD];
#pragma unroll
  for (int i = 0; i < A_LD; ++i) {
    const long long m = m0 + tid / BK + (long long)i * (NT / BK);
    if (m < M) {
      const long long hw = m % ((long long)H * W);
      a_py[i] = (int)(hw / W);
      a_px[i] = (int)(hw % W);
      a_base[i] = m * Cin;
    } else {
      a_py[i] = -1000000;  // outside every row: always padding
      a_px[i] = 0;
      a_base[i] = 0;
    }
  }
  float a_reg[A_LD], b_reg[B_LD];

  auto load = [&](int k0) {
    const int k = k0 + a_k;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / Cin : 0;
    const int ci = k - tap * Cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const long long shift = ((long long)dy * W + dx) * Cin + ci;
#pragma unroll
    for (int i = 0; i < A_LD; ++i) {
      const int yy = a_py[i] + dy, xx = a_px[i] + dx;
      a_reg[i] = k_ok && yy >= 0 && yy < H && xx >= 0 && xx < W
                     ? to_f<T>(y[a_base[i] + shift]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < B_LD; ++i) {
      const int e = tid + i * NT, kb = k0 + e / BN, n = n0 + e % BN;
      b_reg[i] = e < BK * BN && kb < K && n < Cout ? to_f<T>(w[(long long)kb * Cout + n])
                                                   : 0.0f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_LD; ++i) As[a_k][tid / BK + i * (NT / BK)] = a_reg[i];
#pragma unroll
    for (int i = 0; i < B_LD; ++i) {
      const int e = tid + i * NT;
      if (e < BK * BN) Bs[e / BN][e % BN] = b_reg[i];
    }
  };

  float acc[TM][TN];
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
        const float4 v = *reinterpret_cast<const float4*>(&As[kk][tm * TM + 4 * q]);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tn * TN + j];
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

// ---- bfloat16: the same implicit GEMM on the tensor cores ------------------
// wmma products of FM x FN x 16 fragments with float32 accumulators.  Each
// K step of BKT = 32 takes one of STAGES buffers in shared memory holding
// the im2col tile (BM x BKT) and the weights (BKT x BN) as bfloat16; the
// buffers are filled by cp.async (zero-filled where the conv pads), STAGES-1
// steps ahead of the products, so the copies need no registers and two
// blocks fit on an SM.  The gather copies 4 channels (8 bytes) at a time, so
// Cin % 4 == 0 (180 and 64 are); so do the weights where Cout % 4 == 0
// (BVEC), else (Cout = 3) they are loaded one by one.  The accumulators go
// through shared memory for the epilogue.

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
  static_assert(SMEM <= 48 * 1024, "static shared memory");
};

template <int BM, int BN, int FM, int FN, int WGM, int WGN, bool BVEC>
__global__ void __launch_bounds__(WGM * WGN * 32, 2)
conv3x3_tc_kernel(const bf16* __restrict__ y, const bf16* __restrict__ res,
                  const bf16* __restrict__ w, const bf16* __restrict__ bias,
                  bf16* __restrict__ out, int B, int H, int W, int Cin, int Cout, int act) {
  typedef Cfg<BM, BN, FM, FN, WGM, WGN> G;
  static_assert(!BVEC || (G::BV_LD > 0 && (BKT * (BN / VEC)) % G::NT == 0), "vector split");
  __shared__ __align__(128) unsigned char smem_raw[G::SMEM];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);   // STAGES x (A tile, B tile)
  float* Cs = reinterpret_cast<float*>(smem_raw);   // BM x LDC, after the K loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;

  // gather: thread owns channel group g of rows r0 + i * (NT / 8)
  const int g = tid % (BKT / VEC), r0 = tid / (BKT / VEC);
  int a_py[G::A_LD], a_px[G::A_LD];
  long long a_base[G::A_LD];
#pragma unroll
  for (int i = 0; i < G::A_LD; ++i) {
    const long long m = m0 + r0 + i * (G::NT / (BKT / VEC));
    if (m < M) {
      const long long hw = m % ((long long)H * W);
      a_py[i] = (int)(hw / W);
      a_px[i] = (int)(hw % W);
      a_base[i] = m * Cin;
    } else {
      a_py[i] = -1000000;  // outside every row: always padding
      a_px[i] = 0;
      a_base[i] = 0;
    }
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
    const long long shift = ((long long)dy * W + dx) * Cin + ci;
#pragma unroll
    for (int i = 0; i < G::A_LD; ++i) {
      const int yy = a_py[i] + dy, xx = a_px[i] + dx;
      const bool ok = k_ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
      cp_async8(As + (r0 + i * (G::NT / (BKT / VEC))) * G::LDA + g * VEC,
                ok ? y + a_base[i] + shift : y, ok);
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
  wmma::fragment<wmma::accumulator, FM, FN, 16, float> acc[G::FRM][G::FRN];
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
  __syncthreads();  // every product is done before Cs (over the buffers) is written
#pragma unroll
  for (int i = 0; i < G::FRM; ++i)
#pragma unroll
    for (int j = 0; j < G::FRN; ++j)
      wmma::store_matrix_sync(Cs + (wm * G::WTM + i * FM) * G::LDC + wn * G::WTN + j * FN,
                              acc[i][j], G::LDC, wmma::mem_row_major);
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

template <int BM, int BN, int FM, int FN, int WGM, int WGN, bool BVEC>
int launch(const void* y, const void* res, const void* w, const void* bias, void* out, int B,
           int H, int W, int Cin, int Cout, int act, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_tc_kernel<BM, BN, FM, FN, WGM, WGN, BVEC><<<grid, WGM * WGN * 32, 0, stream>>>(
      (const bf16*)y, (const bf16*)res, (const bf16*)w, (const bf16*)bias, (bf16*)out, B, H, W,
      Cin, Cout, act);
  return (int)cudaGetLastError();
}

}  // namespace tcc

template <typename T, int BM, int BN, int TM, int TN>
int launch(const void* y, const void* res, const void* w, const void* bias, void* out,
           int B, int H, int W, int Cin, int Cout, int act, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_kernel<T, BM, BN, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      (const T*)y, (const T*)res, (const T*)w, (const T*)bias, (T*)out, B, H, W, Cin, Cout, act);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* y, const void* res, const void* w, const void* bias, void* out,
             int B, int H, int W, int Cin, int Cout, int act, cudaStream_t stream) {
  // bfloat16 on the tensor cores: the 8-byte copies need Cin % 4 == 0 and an
  // aligned input, and for the weights Cout % 4 == 0 and an aligned w, or
  // Cout <= 8 (conv_last: 32x8 fragments, one column tile, weights loaded
  // one by one); other shapes take the FP32 kernel
  if (std::is_same<T, bf16>::value && Cin % tcc::VEC == 0 && (uintptr_t)y % 8 == 0) {
    if (Cout <= 8)
      return tcc::launch<128, 8, 32, 8, 4, 1, false>(y, res, w, bias, out, B, H, W, Cin, Cout,
                                                     act, stream);
    if (Cout % tcc::VEC == 0 && (uintptr_t)w % 8 == 0)
      return tcc::launch<128, 64, 16, 16, 4, 2, true>(y, res, w, bias, out, B, H, W, Cin, Cout,
                                                      act, stream);
  }
  if (Cout <= 8) return launch<T, 256, 8, 4, 2>(y, res, w, bias, out, B, H, W, Cin, Cout, act, stream);
  return launch<T, 128, 64, 8, 4>(y, res, w, bias, out, B, H, W, Cin, Cout, act, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  act: 0 none, 1 leaky 0.01, 2 leaky 0.2.
// res may be NULL.  Returns cudaGetLastError() after the launch, or -1 for
// arguments the kernel refuses.
extern "C" int conv3x3_launch(int dtype, const void* y, const void* res, const void* w,
                              const void* bias, void* out, int B, int H, int W, int Cin,
                              int Cout, int act, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || act < 0 || act > 2) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(y, res, w, bias, out, B, H, W, Cin, Cout, act, s);
  if (dtype == 1) return dispatch<bf16>(y, res, w, bias, out, B, H, W, Cin, Cout, act, s);
  return -1;
}
