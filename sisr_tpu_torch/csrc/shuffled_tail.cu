// The x4 head's conv_hr + conv_last in one kernel:
//   out = conv_last(act1(conv_hr(shuffle(yp))))
// where shuffle is the phase-major x2 pixel shuffle of the packed yp
// (B, H/2, W/2, 4 Cin), hr has C1 <= 64 channels and out Cout (3 for RGB),
// NHWC, HWIO weights.
//
// Replaces sisr_tpu/ops/pallas/conv3x3.py::_conv3x3_shuffled_tail_pallas
// (_shuffled_tail_kernel).  The TPU kernel walks row bands in order, keeps
// the current and previous hr band in VMEM scratch and emits conv_last one
// band behind, so hr never reaches HBM.  CUDA blocks run in parallel and
// carry nothing, so each block recomputes the 1-pixel hr halo it needs:
// a block computes hr on a 16x16 region (rows and columns oy0-1 .. oy0+14)
// into shared memory and emits the 14x14 output tile inside it.
//
// Bound on the H100 (one 192^2 flagship tile: yp 1x384x384x256 -> out
// 1x768x768x3): conv_hr is 43.5 GFLOP and conv_last 2.0, about 46 us at
// 989 TFLOP/s, against ~79 MB of bf16 bytes (~24 us), so arithmetic bounds
// it.  Design: conv_hr is the implicit GEMM of conv_gemm.cuh (256 rows =
// the hr region, 64 columns = hr channels) reading yp through the shuffled
// gather; bfloat16 on the tensor cores (wmma), float32 on the FP32 pipes.
// The accumulators go to shared memory, get bias and act1, are rounded to
// the compute type (the plain version stores hr in it) and set to 0 outside
// the image (there hr is conv_last's zero padding, not conv_hr of padded
// input).  conv_last then reads the hr tile from shared memory on the FP32
// pipes, one output pixel a thread.  The halo recompute costs 31% more
// conv_hr work (256 hr pixels per 196 outputs); larger tiles are later work.
#include "conv_gemm.cuh"

#include <cstdint>

namespace {

constexpr int HR = 16;       // side of the hr region of a block
constexpr int TO = HR - 2;   // side of its output tile
constexpr int BM = HR * HR;  // conv_hr GEMM rows
constexpr int BN = 64;       // conv_hr channels held (C1 <= BN)
constexpr int LDH = BN + 4;  // hr row stride in floats: float4 reads without bank conflicts

typedef tcc::Cfg<BM, BN, 16, 16, 8, 1> TG;   // 8 warps of 32 rows x 64 channels
typedef fp32c::Cfg<BM, BN, 8, 4> FG;         // 512 threads of 8 x 4
static_assert(TG::LDC == LDH, "the tensor-core accumulators are the hr tile");

// the hr region's rows: pixel (y0 + r / HR, x0 + r % HR) of the shuffled
// image; outside it the gather is padding
struct TileRows {
  int b, y0, x0, H, W;
  __device__ ConvRow operator()(int r) const {
    const int yy = y0 + r / HR, xx = x0 + r % HR;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) return ConvRow{b, kNoRow, 0};
    return ConvRow{b, yy, xx};
  }
};

// conv_last's weights as float [9][C1P][Cout], zero rows for c >= C1
template <typename T>
__device__ __forceinline__ void stage_w2(float* w2s, const T* __restrict__ w2, int C1, int C1P,
                                         int Cout) {
  for (int e = threadIdx.x; e < 9 * C1P * Cout; e += blockDim.x) {
    const int t = e / (C1P * Cout), c = (e / Cout) % C1P, co = e % Cout;
    w2s[e] = c < C1 ? to_f<T>(w2[((long long)t * C1 + c) * Cout + co]) : 0.0f;
  }
}

// hr = act1(acc + b1) rounded to T, 0 outside the image and past C1
template <typename T>
__device__ __forceinline__ void hr_epilogue(float* hr, const T* __restrict__ b1, int y0, int x0,
                                            int H, int W, int C1, int act) {
  const float slope = act == 1 ? 0.01f : 0.2f;
  for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
    const int r = e / BN, n = e % BN;
    const int yy = y0 + r / HR, xx = x0 + r % HR;
    float v = 0.0f;
    if (n < C1 && yy >= 0 && yy < H && xx >= 0 && xx < W) {
      v = hr[r * LDH + n] + to_f<T>(b1[n]);
      if (act) v = leaky_f(v, slope);
      v = to_f<T>(from_f<T>(v));
    }
    hr[r * LDH + n] = v;
  }
}

// conv_last over the hr tile: output pixel (oy0 + ty, ox0 + tx) reads hr
// region rows ty..ty+2, columns tx..tx+2
template <typename T>
__device__ __forceinline__ void conv_last_tile(const float* hr, const float* w2s,
                                               const T* __restrict__ b2, T* __restrict__ out,
                                               int b, int oy0, int ox0, int H, int W, int C1P,
                                               int Cout) {
  for (int p = threadIdx.x; p < TO * TO; p += blockDim.x) {
    const int ty = p / TO, tx = p % TO, oy = oy0 + ty, ox = ox0 + tx;
    if (oy >= H || ox >= W) continue;
    T* o = out + (((long long)b * H + oy) * W + ox) * Cout;
    for (int co0 = 0; co0 < Cout; co0 += 4) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int t = 0; t < 9; ++t) {
        const float* hp = hr + ((ty + t / 3) * HR + tx + t % 3) * LDH;
        const float* wt = w2s + t * C1P * Cout + co0;
        for (int c = 0; c < C1P; c += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(hp + c);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* wr = wt + (c + u) * Cout;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (co0 + q < Cout) acc[q] = fmaf(hv[u], wr[q], acc[q]);
          }
        }
      }
      for (int q = 0; q < 4 && co0 + q < Cout; ++q)
        o[co0 + q] = from_f<T>(acc[q] + to_f<T>(b2[co0 + q]));
    }
  }
}

// bfloat16, conv_hr on the tensor cores.  Shared memory: the K-loop stages
// (then the float accumulators = the hr tile), then w2s.
__global__ void __launch_bounds__(TG::NT)
tail_tc_kernel(const bf16* __restrict__ yp, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ b2, bf16* __restrict__ out, int H, int W, int Cin,
               int C1, int Cout, int act) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* hr = reinterpret_cast<float*>(smem_raw);
  float* w2s = reinterpret_cast<float*>(smem_raw + TG::SMEM);
  const int b = blockIdx.z, oy0 = blockIdx.y * TO, ox0 = blockIdx.x * TO;
  const int C1P = (C1 + 3) & ~3;
  stage_w2(w2s, w2, C1, C1P, Cout);

  tcc::Acc<BM, BN, 16, 16, 8, 1> acc;
  tcc::mainloop<BM, BN, 16, 16, 8, 1, true, true>(acc, reinterpret_cast<bf16*>(smem_raw), yp, w1,
                                                  H, W, Cin, C1, 0,
                                                  TileRows{b, oy0 - 1, ox0 - 1, H, W});
  tcc::store_acc<BM, BN, 16, 16, 8, 1>(acc, hr);
  __syncthreads();
  hr_epilogue(hr, b1, oy0 - 1, ox0 - 1, H, W, C1, act);
  __syncthreads();
  conv_last_tile(hr, w2s, b2, out, b, oy0, ox0, H, W, C1P, Cout);
}

// float32 (and bfloat16 shapes the tensor-core kernel does not take),
// conv_hr on the FP32 pipes.  Shared memory: As, Bs, the hr tile, w2s.
template <typename T>
__global__ void __launch_bounds__(FG::NT)
tail_fp32_kernel(const T* __restrict__ yp, const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out, int H,
                 int W, int Cin, int C1, int Cout, int act) {
  extern __shared__ __align__(16) float fsm[];
  float* As = fsm;
  float* Bs = As + fp32c::BK * FG::LDA;
  float* hr = Bs + fp32c::BK * FG::LDB;
  float* w2s = hr + BM * LDH;
  const int b = blockIdx.z, oy0 = blockIdx.y * TO, ox0 = blockIdx.x * TO;
  const int C1P = (C1 + 3) & ~3;
  stage_w2(w2s, w2, C1, C1P, Cout);

  float acc[8][4];
  fp32c::mainloop<T, BM, BN, 8, 4, true>(acc, As, Bs, yp, w1, H, W, Cin, C1, 0,
                                         TileRows{b, oy0 - 1, ox0 - 1, H, W});
  const int tn = threadIdx.x % (BN / 4), tm = threadIdx.x / (BN / 4);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) hr[(tm * 8 + i) * LDH + tn * 4 + j] = acc[i][j];
  __syncthreads();
  hr_epilogue(hr, b1, oy0 - 1, ox0 - 1, H, W, C1, act);
  __syncthreads();
  conv_last_tile(hr, w2s, b2, out, b, oy0, ox0, H, W, C1P, Cout);
}

template <typename T>
int launch_fp32(dim3 grid, size_t w2_bytes, const void* yp, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, int H, int W, int Cin, int C1,
                int Cout, int act, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (fp32c::BK * (FG::LDA + FG::LDB) + BM * LDH) + w2_bytes;
  if (set_smem(tail_fp32_kernel<T>, smem)) return -1;
  tail_fp32_kernel<T><<<grid, FG::NT, smem, stream>>>((const T*)yp, (const T*)w1, (const T*)b1,
                                                      (const T*)w2, (const T*)b2, (T*)out, H, W,
                                                      Cin, C1, Cout, act);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  H, W, Cin describe the shuffled conv_hr
// input (yp is (B, H/2, W/2, 4 Cin)); w1 (3, 3, Cin, C1), w2 (3, 3, C1,
// Cout); out (B, H, W, Cout).  act: 0 none, 1 leaky 0.01, 2 leaky 0.2 (after
// conv_hr).  Returns cudaGetLastError() after the launch, or -1 for
// arguments the kernel refuses.
extern "C" int shuffled_tail_launch(int dtype, const void* yp, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out, int B, int H,
                                    int W, int Cin, int C1, int Cout, int act, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || Cin <= 0 || C1 <= 0 || C1 > BN ||
      Cout <= 0 || act < 0 || act > 2)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int C1P = (C1 + 3) & ~3;
  const size_t w2_bytes = sizeof(float) * 9 * C1P * Cout;
  dim3 grid((unsigned)((W + TO - 1) / TO), (unsigned)((H + TO - 1) / TO), (unsigned)B);
  if (dtype == 1 && Cin % tcc::VEC == 0 && C1 % tcc::VEC == 0 && (uintptr_t)yp % 8 == 0 &&
      (uintptr_t)w1 % 8 == 0) {
    const size_t smem = TG::SMEM + w2_bytes;
    if (set_smem(tail_tc_kernel, smem)) return -1;
    tail_tc_kernel<<<grid, TG::NT, smem, s>>>((const bf16*)yp, (const bf16*)w1,
                                              (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                                              (bf16*)out, H, W, Cin, C1, Cout, act);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) return launch_fp32<float>(grid, w2_bytes, yp, w1, b1, w2, b2, out, H, W, Cin, C1, Cout, act, s);
  if (dtype == 1) return launch_fp32<bf16>(grid, w2_bytes, yp, w1, b1, w2, b2, out, H, W, Cin, C1, Cout, act, s);
  return -1;
}
