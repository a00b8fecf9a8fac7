// 5x5 depthwise convolution + bias, NHWC, stride 1, zero same-padding:
//   y[b, y, x, c] = bias[c] + sum_{i, j < 5} xpad[b, y + i, x + j, c] * w[i, j, c]
// in float32 or bfloat16.
//
// Replaces sisr_tpu/ops/pallas/dwconv.py::_dwconv_pallas, forward and
// backward: dx is this kernel over dy with the filter flipped in both
// spatial axes and a zero bias, as the JAX custom_vjp computes it
// (ops/kernels/dwconv.py flips the 25 x C filter in torch).
//
// Bound: bytes.  Each output element costs 25 FMAs and one element in and
// one out; at (1, 192, 192, 360) that is 53.1 MB in + out in bfloat16
// (15.8 us at 3.35 TB/s, 31.7 us in float32) against 664 MFLOP (9.9 us on
// the FP32 pipes).  The TPU kernel pre-overlaps row tiles in device memory
// so that BlockSpecs can pipeline them; here a block stages its own halo.
//
// Design: channels on threads, so that every load and store of a warp is
// 32 consecutive channels of one pixel.  A block of TH warps takes an
// output tile of TH x TW pixels for CT = 32 channels: it stages the tile
// plus its 2-pixel halo (zero outside the image) in shared memory as
// float32, its 25 taps go to registers, and each thread computes the TW
// outputs of one row of one channel, sliding over the five input rows it
// needs (5 x (TW + 4) shared reads for 25 x TW FMAs).  It accumulates in
// float32, adds the bias and rounds once to the output type.  Tiles and
// channel slices are flattened onto gridDim.x (gridDim.y and z stop at
// 65,535); every index that multiplies a pixel by a channel count is 64-bit.
#include "common.cuh"

namespace {

constexpr int K = 5, R = 2;
constexpr int CT = 32;             // channels per block: a warp's lanes
constexpr int TH = 8;              // output rows per block: a warp each
constexpr int TW = 16;             // output columns per thread
constexpr int SH = TH + 2 * R, SW = TW + 2 * R;
constexpr int NT = CT * TH;

template <typename T>
__global__ void __launch_bounds__(NT)
dwconv_tile(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
            T* __restrict__ y, int H, int W, int C, int tiles_h, int tiles_w, int slices) {
  __shared__ float s[SH * SW][CT];
  long long blk = blockIdx.x;
  const int cs = (int)(blk % slices);
  blk /= slices;
  const int tw = (int)(blk % tiles_w);
  blk /= tiles_w;
  const int th = (int)(blk % tiles_h);
  const long long img = (blk / tiles_h) * H * W;   // first pixel of the image
  const int c0 = cs * CT, y0 = th * TH, x0 = tw * TW;
  const int lane = threadIdx.x % CT, row = threadIdx.x / CT;
  const int c = c0 + lane;
  const bool live = c < C;

  for (int e = threadIdx.x; e < SH * SW * CT; e += NT) {
    const int p = e / CT, cc = e % CT;
    const int gy = y0 - R + p / SW, gx = x0 - R + p % SW;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + cc < C)
      v = to_f<T>(x[(img + (long long)gy * W + gx) * C + c0 + cc]);
    s[p][cc] = v;
  }
  float tap[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) tap[t] = live ? to_f<T>(w[(long long)t * C + c]) : 0.0f;
  const float b0 = live ? to_f<T>(bias[c]) : 0.0f;
  __syncthreads();

  float acc[TW];
#pragma unroll
  for (int t = 0; t < TW; ++t) acc[t] = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float v[SW];
#pragma unroll
    for (int t = 0; t < SW; ++t) v[t] = s[(row + i) * SW + t][lane];
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int t = 0; t < TW; ++t) acc[t] = fmaf(v[t + j], tap[i * K + j], acc[t]);
    }
  }
  const int oy = y0 + row;
  if (!live || oy >= H) return;
  T* out = y + (img + (long long)oy * W) * C + c;
#pragma unroll
  for (int t = 0; t < TW; ++t)
    if (x0 + t < W) out[(long long)(x0 + t) * C] = from_f<T>(acc[t] + b0);
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int B, int H, int W, int C,
           cudaStream_t s) {
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const int slices = (C + CT - 1) / CT;
  const long long blocks = (long long)B * tiles_h * tiles_w * slices;
  if (blocks > 2147483647LL) return -1;
  dwconv_tile<T><<<(unsigned)blocks, NT, 0, s>>>((const T*)x, (const T*)w, (const T*)b, (T*)y,
                                                 H, W, C, tiles_h, tiles_w, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (B, H, W, C); w (5, 5, C); b (C,); all of one type (dtype 0 float32,
// 1 bfloat16), contiguous.  Returns cudaGetLastError(), or -1 for refused
// arguments.
extern "C" int dwconv5x5_launch(int dtype, const void* x, const void* w, const void* b, void* y,
                                int B, int H, int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, b, y, B, H, W, C, s);
  if (dtype == 1) return launch<bf16>(x, w, b, y, B, H, W, C, s);
  return -1;
}
