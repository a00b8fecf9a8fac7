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
// convolutions are bound by arithmetic, not bytes.  Design: an implicit
// GEMM (conv_gemm.cuh).  A block owns a BM x BN tile of (pixel, Cout); each
// K step stages BK (tap, Cin) columns of the im2col matrix, gathered from
// the input with the zero 'same' padding applied on the fly (at the border
// of the shuffled image when shuf), and the matching BK x BN weights in
// shared memory.  K = 9*Cin needs no alignment (Cin = 180 or 64), and ragged
// M and N are masked, so Cout from 3 to 256 run unchanged; Cout <= 8 takes
// a narrow-N tile.  float32 runs on the FP32 pipes (so that it stays
// exact); bfloat16 on the tensor cores (wmma, float32 accumulators, two
// blocks per SM).  wgmma / TMA tiles are later work.
#include "conv_gemm.cuh"

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

struct Args {
  const void *y, *res, *w, *bias;
  void* out;
  int B, H, W, Cin, Cout, act;
  cudaStream_t stream;
};

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
// Returns cudaGetLastError() after the launch, or -1 for arguments the
// kernel refuses.
extern "C" int conv3x3_launch(int dtype, const void* y, const void* res, const void* w,
                              const void* bias, void* out, int B, int H, int W, int Cin,
                              int Cout, int act, int shuf, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || act < 0 || act > 2) return -1;
  if (shuf && (H % 2 || W % 2)) return -1;
  const Args a{y, res, w, bias, out, B, H, W, Cin, Cout, act, (cudaStream_t)stream};
  if (dtype == 0) return shuf ? dispatch<float, true>(a) : dispatch<float, false>(a);
  if (dtype == 1) return shuf ? dispatch<bf16, true>(a) : dispatch<bf16, false>(a);
  return -1;
}
