// 5x5 depthwise convolution + bias, NHWC, stride 1, zero same-padding:
//   y[b, y, x, c] = bias[c] + sum_{i, j < 5} xpad[b, y + i, x + j, c] * w[i, j, c]
// in float32 or bfloat16.
//
// Replaces sisr_tpu/ops/pallas/dwconv.py::_dwconv_pallas, forward and
// backward: dx is this kernel over dy with flip = 1 (tap (i, j) read as
// w[4 - i, 4 - j], the filter flipped in both spatial axes) and no bias, as
// the JAX custom_vjp computes it, in one launch.
//
// Bound: bytes.  Each output element costs 25 FMAs and one element in and
// one out; at (1, 192, 192, 360) that is 53.1 MB in + out in bfloat16
// (15.8 us at 3.35 TB/s, 31.7 us in float32) against 664 MFLOP (9.9 us on
// the FP32 pipes).  The TPU kernel pre-overlaps row tiles in device memory
// so that BlockSpecs can pipeline them; here a block stages its own halo.
//
// Design: channel pairs on threads, so that every load and store of a warp
// is 64 consecutive channels of one pixel: one __nv_bfloat162 (4 bytes) or
// float2 (8 bytes) a thread where C is even, two masked scalars where it is
// odd; the last slice of C = 360 masks its upper 24 channels.  A block of
// TH warps takes an output tile of TH x TW pixels for 64 channels: each
// warp stages whole rows of the tile plus its 2-pixel halo (zero outside
// the image) in shared memory as float32, with no divides; each thread
// computes the TW outputs of one row of its two channels, sliding over the
// five input rows it needs (5 x (TW + 4) shared reads for 25 x TW FMAs a
// channel), and reads the taps of each filter row as it gets to it (L1
// hits after the first block), so that it fits 80 registers and three
// blocks share an SM.  The kernel waits on memory latency more than on
// bytes: three resident blocks instead of two, with TW = 16, took a 192x192
// tile from 0.108 to 0.080 ms in bfloat16 (PERF.md, dwconv5x5 findings).
// It accumulates in float32, adds the bias (if any) and rounds once to the
// output type.
// Tiles and channel slices are flattened onto gridDim.x (gridDim.y and z
// stop at 65,535); every index that multiplies a pixel by a channel count
// is 64-bit.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int K = 5, R = 2;
constexpr int CP = 32;             // channel pairs per block: a warp's lanes
constexpr int TH = 8;              // output rows per block: a warp each
constexpr int TW = 16;             // output columns per thread
constexpr int SH = TH + 2 * R, SW = TW + 2 * R;
constexpr int NT = CP * TH;
constexpr int MIN_BLOCKS = 3;      // resident blocks per SM (80 registers a thread)
constexpr size_t SMEM = sizeof(float2) * SH * SW * CP;

__device__ __forceinline__ float2 vload2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 vload2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void vstore2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void vstore2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// channels c, c + 1 at p (p points at channel c; c is even); zero past C.
// VEC (C even, pointers aligned): one vector access, the pair is all in or
// all out
template <bool VEC, typename T>
__device__ __forceinline__ float2 load2(const T* p, int c, int C) {
  if (VEC) return c < C ? vload2(p) : make_float2(0.0f, 0.0f);
  return make_float2(c < C ? to_f<T>(p[0]) : 0.0f, c + 1 < C ? to_f<T>(p[1]) : 0.0f);
}
template <bool VEC, typename T>
__device__ __forceinline__ void store2(T* p, float2 v, int c, int C) {
  if (VEC) {
    if (c < C) vstore2(p, v);
    return;
  }
  if (c < C) p[0] = from_f<T>(v.x);
  if (c + 1 < C) p[1] = from_f<T>(v.y);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
dwconv_tile(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
            T* __restrict__ y, int H, int W, int C, int tiles_h, int tiles_w, int slices,
            int flip) {
  extern __shared__ float2 s_raw[];
  float2(*s)[CP] = reinterpret_cast<float2(*)[CP]>(s_raw);   // [SH * SW][CP]
  long long blk = blockIdx.x;
  const int cs = (int)(blk % slices);
  blk /= slices;
  const int tw = (int)(blk % tiles_w);
  blk /= tiles_w;
  const int th = (int)(blk % tiles_h);
  const long long img = (blk / tiles_h) * H * W;   // first pixel of the image
  const int y0 = th * TH, x0 = tw * TW;
  const int lane = threadIdx.x % CP, row = threadIdx.x / CP;
  const int c = cs * 2 * CP + 2 * lane;

  // warp `row` stages rows row, row + TH, ... of the haloed tile
  for (int sy = row; sy < SH; sy += TH) {
    const int gy = y0 - R + sy;
    const bool y_ok = gy >= 0 && gy < H;
    const T* src = x + (img + (long long)(y_ok ? gy : 0) * W) * C + c;
#pragma unroll
    for (int sx = 0; sx < SW; ++sx) {
      const int gx = x0 - R + sx;
      s[sy * SW + sx][lane] = y_ok && gx >= 0 && gx < W
                                  ? load2<VEC>(src + (long long)gx * C, c, C)
                                  : make_float2(0.0f, 0.0f);
    }
  }
  const float2 b0 = bias ? load2<VEC>(bias + c, c, C) : make_float2(0.0f, 0.0f);
  __syncthreads();

  float2 acc[TW];
#pragma unroll
  for (int t = 0; t < TW; ++t) acc[t] = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float2 v[SW];
#pragma unroll
    for (int t = 0; t < SW; ++t) v[t] = s[(row + i) * SW + t][lane];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int tap = flip ? K * K - 1 - (i * K + j) : i * K + j;
      const float2 f = load2<VEC>(w + (long long)tap * C + c, c, C);
#pragma unroll
      for (int t = 0; t < TW; ++t) {
        acc[t].x = fmaf(v[t + j].x, f.x, acc[t].x);
        acc[t].y = fmaf(v[t + j].y, f.y, acc[t].y);
      }
    }
  }
  const int oy = y0 + row;
  if (c >= C || oy >= H) return;
  T* out = y + (img + (long long)oy * W) * C + c;
#pragma unroll
  for (int t = 0; t < TW; ++t)
    if (x0 + t < W)
      store2<VEC>(out + (long long)(x0 + t) * C, make_float2(acc[t].x + b0.x, acc[t].y + b0.y),
                  c, C);
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int B, int H, int W, int C,
           int flip, cudaStream_t s) {
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const int slices = (C + 2 * CP - 1) / (2 * CP);
  const long long blocks = (long long)B * tiles_h * tiles_w * slices;
  if (blocks > 2147483647LL) return -1;
  const size_t pair = 2 * sizeof(T);
  const bool vec = C % 2 == 0 && (uintptr_t)x % pair == 0 && (uintptr_t)w % pair == 0 &&
                   (uintptr_t)y % pair == 0 && (uintptr_t)b % pair == 0;
  auto kern = vec ? dwconv_tile<T, true> : dwconv_tile<T, false>;
  if (set_smem(kern, SMEM)) return -1;
  kern<<<(unsigned)blocks, NT, SMEM, s>>>((const T*)x, (const T*)w, (const T*)b, (T*)y, H, W, C,
                                       tiles_h, tiles_w, slices, flip);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (B, H, W, C); w (5, 5, C); b (C,) or NULL (no bias); all of one type
// (dtype 0 float32, 1 bfloat16), contiguous.  flip = 1 reads the filter
// flipped in both spatial axes (dx of the conv on dy).  Returns
// cudaGetLastError(), or -1 for refused arguments.
extern "C" int dwconv5x5_launch(int dtype, const void* x, const void* w, const void* b, void* y,
                                int B, int H, int W, int C, int flip, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || flip < 0 || flip > 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, b, y, B, H, W, C, flip, s);
  if (dtype == 1) return launch<bf16>(x, w, b, y, B, H, W, C, flip, s);
  return -1;
}
