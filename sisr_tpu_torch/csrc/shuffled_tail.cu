// The x4 head's conv_hr + conv_last in one kernel:
//   out = conv_last(act1(conv_hr(shuffle(yp))))
// where shuffle is the phase-major x2 pixel shuffle of the packed yp
// (B, H/2, W/2, 4 Cin), hr has C1 <= 64 channels and out Cout (3 for RGB),
// NHWC, HWIO weights.  The packed output (B, H, W/16, 16 Cout) is the same
// bytes, so one kernel writes both.
//
// Replaces sisr_tpu/ops/pallas/conv3x3.py::_conv3x3_shuffled_tail_pallas
// (_shuffled_tail_kernel) and ::_conv3x3_shuffled_tail_packed_pallas.  The
// TPU kernel walks row bands in order, keeps the current and previous hr
// band in VMEM scratch and emits conv_last one band behind, so hr never
// reaches HBM.  CUDA blocks run in parallel and carry nothing, so each
// block recomputes the 1-pixel hr halo it needs: a block computes hr on a
// region of RH x RW pixels (rows oy0-1 .., columns ox0-1 ..) into shared
// memory and emits the (RH-2) x (RW-2) output tile inside it.
//
// Bound on the H100 (one 192^2 flagship tile: yp 1x384x384x256 -> out
// 1x768x768x3): conv_hr is 43.5 GFLOP and conv_last 2.0, about 46 us at
// 989 TFLOP/s, against ~79 MB of bf16 bytes (~24 us), so arithmetic bounds
// it.  Design, at the model's shapes (the rule in shuffled_tail_launch;
// ops/kernels/conv3x3.py::tail_wgmma states it too):
// - bfloat16 (tail_wgmma_kernel): a 16 x 32 hr region, 512 hr pixels for
//   14 x 30 outputs, so the halo adds 22% to conv_hr (a 16 x 16 region
//   added 31%).  conv_hr is a wgmma product, (512 hr pixels) x 64 channels
//   x K = 9 x 64, run as 4 passes of 128 rows (two warpgroups of 64), n64.
//   Gathering each tap's im2col rows from L2 (as the shuffled conv does)
//   reads every input pixel 9 times for only 64 output channels, which
//   held a first version of this kernel at 0.42 ms a tile (PERF.md, PR 7),
//   so a pass copies its 6 x 34 input pixels once into a patch in shared
//   memory (the shuffled 16-byte gather of conv_gemm.cuh::sgw; a pixel's
//   64 channels are one 128-byte swizzled row; the next pass's patch loads
//   while this one computes), and every tap's A fragments come from it by
//   ldmatrix with one row address a lane into wgmma's register operand.
//   The packed conv_hr weights (pack_weights, (64, 576), 72 KB) stay in
//   shared memory for the block.  Each pass's epilogue works on the
//   accumulator registers: bias, act1, rounding to bfloat16 (where the
//   plain version stores hr), zero outside the image (conv_last's
//   padding), one bfloat16 pair per store into the hr tile (64 KB,
//   bfloat16, 128-byte swizzled rows).  conv_last (64 -> Cout <= 8) runs
//   on the tensor cores too: mma.sync m16n8k16 over 16 output pixels a
//   tile, A by ldmatrix with one hr row address a lane, B the HWIO
//   conv_last weights padded to n8 in registers, one tap at a time,
//   float32 accumulators.
// - float32 (tail_f32_kernel): the same region, conv_hr as 2 chunks of
//   256 rows on f32k's 8x8 register tiles (conv_gemm.cuh) through the
//   shuffled gather, hr in float32 in shared memory, conv_last on the FP32
//   pipes, one output pixel a thread at a time with float4 reads of hr and
//   of the weights (Cout padded to 4).
// The earlier kernel (tail_fp32_kernel: a 16 x 16 region, conv_hr on
// conv_gemm.cuh's register-staged FP32 loop, hr in float32, conv_last one
// output pixel a thread) exists for generality alone: no shape of the model
// takes it.  It serves what the two region kernels cannot: in float32
// Cin % 4 != 0 or C1 % 4 != 0 (f32k's 16-byte copies of the input and of
// w1's rows) or unaligned pointers, in bfloat16 every shape outside the
// wgmma rule (Cin != 64, Cout > 8, no pack).  Those bfloat16 shapes run on
// the FP32 pipes, not on the tensor cores.
#include "conv_gemm.cuh"
#include "wgmma.cuh"

#include <cstdint>

namespace {

constexpr int HR = 16;       // side of the hr region of a block
constexpr int TO = HR - 2;   // side of its output tile
constexpr int BM = HR * HR;  // conv_hr GEMM rows
constexpr int BN = 64;       // conv_hr channels held (C1 <= BN)
constexpr int LDH = BN + 4;  // hr row stride in floats: float4 reads without bank conflicts

typedef fp32c::Cfg<BM, BN, 8, 4> FG;         // 512 threads of 8 x 4

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

// the shapes outside the region kernels' rule, in either type: conv_hr on
// the FP32 pipes.  Shared memory: As, Bs, the hr tile, w2s.
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

// ---- the region kernels: bfloat16 on wgmma, float32 on f32k -----------------
namespace rg {

constexpr int RH = 16, RW = 32;             // the hr region of a block
constexpr int OH = RH - 2, OW = RW - 2;     // its output tile
constexpr int ROWS = RH * RW;               // 512 hr pixels
constexpr int NPIX = OH * OW;               // 420 outputs

// region row r of a chunk starting at region row r0: hr pixel (y0 + r / RW,
// x0 + r % RW) of image b; outside the image the gather is padding
struct RegionRows {
  int b, y0, x0, r0, H, W;
  __device__ ConvRow operator()(int r) const {
    const int yy = y0 + (r0 + r) / RW, xx = x0 + (r0 + r) % RW;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) return ConvRow{b, kNoRow, 0};
    return ConvRow{b, yy, xx};
  }
};

}  // namespace rg

namespace tw {   // bfloat16 on wgmma

constexpr int NT = 256;                     // two consumer warpgroups
constexpr int CHUNK = 128;                  // conv_hr rows a pass (64 a warpgroup)
constexpr int CROWS = CHUNK / rg::RW;       // region rows a pass (4)
constexpr int NCHUNK = rg::ROWS / CHUNK;
constexpr int C = 64;                       // conv_hr's input and output channels (n64)
constexpr int PH = CROWS + 2, PW = rg::RW + 2;   // a pass's input patch (6 x 34 pixels)
constexpr int PATCH_BYTES = (PH * PW * 128 + 1023) / 1024 * 1024;
constexpr int HR_BYTES = rg::ROWS * 128, B_BYTES = 9 * C * 128;
constexpr int MTILES = (rg::NPIX + 15) / 16;   // conv_last's m16 tiles
constexpr size_t SMEM = 1024 + HR_BYTES + B_BYTES + 2 * PATCH_BYTES;

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// keeps r live (in its register) up to this point: an A fragment that an
// asynchronous wgmma may still read
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d += a (16 x 16, row-major) x b (16 x 8, column-major), bfloat16 in,
// float32 accumulators
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace tw

// bfloat16 at Cin = 64: conv_hr on wgmma into a bfloat16 hr tile, conv_last
// on mma.sync.  A pass of 128 hr pixels (4 region rows) reads its 6 x 34
// input pixels once: the patch (64 channels = one 128-byte swizzled row a
// pixel) is copied in by the shuffled 16-byte gather, one pass ahead, and
// each tap's A fragments come from it by ldmatrix, one row address a lane
// (the tap's shifted rows need no copy of their own), into wgmma's
// register operand; B, the packed conv_hr weights (64, 576), stays in
// shared memory for the block.  Shared memory (1024-byte aligned): the hr
// tile, the weights, two patches.
__global__ void __launch_bounds__(tw::NT, 1)
tail_wgmma_kernel(const bf16* __restrict__ yp, const bf16* __restrict__ w1p,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b2, bf16* __restrict__ out, int H, int W, int C1,
                  int Cout, int act) {
  using namespace tw;
  extern __shared__ unsigned char tw_smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(tw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle repeats every 1024 bytes
  unsigned char* hr = tw_smem + (base - raw);
  unsigned char* wsm = hr + HR_BYTES;
  unsigned char* patches = wsm + B_BYTES;
  const uint32_t w_s = base + HR_BYTES, patch_s = w_s + B_BYTES;

  const int tid = threadIdx.x, b = blockIdx.z;
  const int oy0 = blockIdx.y * rg::OH, ox0 = blockIdx.x * rg::OW;
  const int y0 = oy0 - 1, x0 = ox0 - 1;
  const long long img = (long long)b * H * W * C;

  // pass c's patch: pixel (pr, pc) is shuffled pixel (y0 + c CROWS - 1 +
  // pr, x0 - 1 + pc), row pr * PW + pc of the patch, zero outside the image
  auto load_patch = [&](int c) {
    unsigned char* dst = patches + (c & 1) * PATCH_BYTES;
    for (int e = tid; e < PH * PW * 8; e += NT) {
      const int pp = e >> 3, ch = e & 7;
      sgw::gather16(dst + sgw::sw128(pp, ch), yp, img, y0 + c * CROWS - 1 + pp / PW,
                    x0 - 1 + pp % PW, 4, ch * sgw::CH, H, W, C);
    }
  };
  // the conv_hr weights, once: tap t of row n at wsm + t * 8192 + n * 128
  for (int e = tid; e < C * 9 * 8; e += NT) {
    const int n = e / 72, c8 = e % 72;
    cp_async16(wsm + (c8 >> 3) * (C * 128) + sgw::sw128(n, c8 & 7),
               w1p + (long long)n * 9 * C + c8 * 8, true);
  }
  load_patch(0);
  cp_async_commit();
  load_patch(1);
  cp_async_commit();

  const int wgi = tid / 128, lt = tid % 128, warp4 = lt / 32, lane = lt % 32;
  const float slope = act == 1 ? 0.01f : 0.2f;
  float b1v[2 * C / 8];
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * (lane % 4) + e;
      b1v[2 * j + e] = c < C1 ? __bfloat162float(b1[c]) : 0.0f;
    }
  // this lane's ldmatrix row: pass row wgi*64 + 16 warp + lane % 8 + 8
  // ((lane / 8) % 2), i.e. region row (in the pass) ar, column ac; its
  // 16-byte chunk 2kk + lane / 16
  const int arow = wgi * 64 + warp4 * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ar = arow / rg::RW, ac = arow % rg::RW, half = lane >> 4;

  for (int c = 0; c < NCHUNK; ++c) {
    cp_async_wait<1>();   // this thread's copies of pass c's patch landed
    __syncthreads();      // ... everyone's
    const uint32_t ps = patch_s + (c & 1) * PATCH_BYTES;
    float acc[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[i] = 0.0f;
    uint32_t a[2][4][4];   // two taps' fragments: one may be read by a wgmma in flight
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int pp = (ar + t / 3) * PW + ac + t % 3;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[t & 1][kk], ps + sgw::sw128(pp, 2 * kk + half));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64nNk16_rs<C>(acc, a[t & 1][kk], sw128_desc(w_s + t * (C * 128) + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();   // the product of tap t - 1 is done: its fragments may be reused
      if (t > 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) keep(a[(t - 1) & 1][kk][i]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) keep(a[8 & 1][kk][i]);
#pragma unroll
    for (int i = 0; i < C / 2; ++i) fence_operand(acc[i]);
    __syncthreads();   // every warp is done with this patch
    if (c + 2 < NCHUNK) load_patch(c + 2);
    cp_async_commit();   // one group a pass, empty or not, so the counts line up

    // the pass's epilogue: accumulator j*4 + h*2 + e is hr row 16 * warp +
    // lane / 4 + 8h of the warpgroup's 64, channel 8j + 2 (lane % 4) + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = c * CHUNK + wgi * 64 + warp4 * 16 + lane / 4 + 8 * h;
      const int yy = y0 + r / rg::RW, xx = x0 + r % rg::RW;
      const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        float v0 = acc[4 * j + 2 * h] + b1v[2 * j], v1 = acc[4 * j + 2 * h + 1] + b1v[2 * j + 1];
        if (act) {
          v0 = leaky_f(v0, slope);
          v1 = leaky_f(v1, slope);
        }
        *reinterpret_cast<__nv_bfloat162*>(hr + sgw::sw128(r, j) + 4 * (lane % 4)) =
            inside ? __floats2bfloat162_rn(v0, v1) : __floats2bfloat162_rn(0.0f, 0.0f);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the hr tile is whole

  // conv_last: warp w takes the m16 tiles w, w + 8, ... of the 420 output
  // pixels (row-major in the 14 x 30 tile); a lane's ldmatrix row is pixel
  // mt*16 + lane % 8 + 8 ((lane / 8) % 2), its 16-byte chunk 2kk + lane / 16
  const int warp = tid / 32;
  constexpr int MT_W = (MTILES + 7) / 8;
  float d[MT_W][4];
#pragma unroll
  for (int u = 0; u < MT_W; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[u][e] = 0.0f;
  const bf16 zero = __float2bfloat16(0.0f);
  const int bn = lane / 4;
  for (int t = 0; t < 9; ++t) {
    uint32_t bfr[4][2];   // B (16 x 8) of tap t's k16 steps: rows c, columns n
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = 16 * kk + 8 * hf + 2 * (lane % 4);
        const bool ok = bn < Cout;
        const long long at = ((long long)t * C1 + c) * Cout + bn;
        bfr[kk][hf] = pack2(ok && c < C1 ? w2[at] : zero, ok && c + 1 < C1 ? w2[at + Cout] : zero);
      }
#pragma unroll
    for (int u = 0; u < MT_W; ++u) {
      const int mt = warp + 8 * u;
      if (mt >= MTILES) break;
      const int p = min(mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), rg::NPIX - 1);
      const int rr = (p / rg::OW + t / 3) * rg::RW + p % rg::OW + t % 3;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, base + sgw::sw128(rr, 2 * kk + (lane >> 4)));
        mma_16816(d[u], a, bfr[kk]);
      }
    }
  }
  // d[u][2h + e]: output pixel mt*16 + lane / 4 + 8h, channel 2 (lane % 4) + e
  float b2v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = 2 * (lane % 4) + e;
    b2v[e] = n < Cout ? __bfloat162float(b2[n]) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < MT_W; ++u) {
    const int mt = warp + 8 * u;
    if (mt >= MTILES) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + lane / 4 + 8 * h;
      const int oy = oy0 + p / rg::OW, ox = ox0 + p % rg::OW;
      if (p >= rg::NPIX || oy >= H || ox >= W) continue;
      bf16* o = out + (((long long)b * H + oy) * W + ox) * Cout;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 2 * (lane % 4) + e;
        if (n < Cout) o[n] = __float2bfloat16(d[u][2 * h + e] + b2v[e]);
      }
    }
  }
}

namespace tf {   // float32 on f32k's register tiles

constexpr int BM = 256, BN = 64;            // a conv_hr pass: 256 rows x 64 channels
typedef f32k::Cfg<BM, BN> G;
constexpr int NCHUNK = rg::ROWS / BM;
constexpr int LDH = BN + 4;                 // hr row stride in floats
constexpr size_t SMEM = G::SMEM + sizeof(float) * rg::ROWS * LDH;

// conv_last's weights [9][64][CP] (CP = Cout rounded up to 4) fit the stages
__host__ __device__ constexpr int cp_of(int cout) { return (cout + 3) & ~3; }
constexpr bool w2_fits(int cout) { return sizeof(float) * 9 * BN * cp_of(cout) <= G::SMEM; }

}  // namespace tf

// float32: conv_hr on f32k's register tiles into a float32 hr tile,
// conv_last on the FP32 pipes.  Shared memory: f32k's stages (after conv_hr
// the conv_last weights), then the hr tile.
__global__ void __launch_bounds__(tf::G::NT, 1)
tail_f32_kernel(const float* __restrict__ yp, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int H, int W, int Cin,
                int C1, int Cout, int act) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* hr = stages + tf::G::SMEM / sizeof(float);
  const int tid = threadIdx.x, b = blockIdx.z;
  const int oy0 = blockIdx.y * rg::OH, ox0 = blockIdx.x * rg::OW;
  const int y0 = oy0 - 1, x0 = ox0 - 1;
  const int tn = tid % (tf::BN / f32k::TN), tm = tid / (tf::BN / f32k::TN);
  const float slope = act == 1 ? 0.01f : 0.2f;

  for (int chunk = 0; chunk < tf::NCHUNK; ++chunk) {
    float acc[f32k::TM][f32k::TN];
    f32k::mainloop<tf::BM, tf::BN, true>(acc, stages, yp, w1, H, W, Cin, C1, 0,
                                         rg::RegionRows{b, y0, x0, chunk * tf::BM, H, W});
    // rows tm + i BM/TM, columns h BN/2 + 4 tn + j of the pass
#pragma unroll
    for (int i = 0; i < f32k::TM; ++i) {
      const int r = chunk * tf::BM + tm + i * (tf::BM / f32k::TM);
      const int yy = y0 + r / rg::RW, xx = x0 + r % rg::RW;
      const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = h * (tf::BN / 2) + 4 * tn;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[i][4 * h + j] + (n + j < C1 ? b1[n + j] : 0.0f);
          if (act) v[j] = leaky_f(v[j], slope);
          if (!inside || n + j >= C1) v[j] = 0.0f;
        }
        *reinterpret_cast<float4*>(hr + r * tf::LDH + n) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();   // every read of the stages is done before they are refilled
  }

  // conv_last's weights into the stages: w2s[(t * 64 + c) * CP + co]
  const int CP = tf::cp_of(Cout);
  float* w2s = stages;
  for (int e = tid; e < 9 * tf::BN * CP; e += tf::G::NT) {
    const int t = e / (tf::BN * CP), c = (e / CP) % tf::BN, co = e % CP;
    w2s[e] = c < C1 && co < Cout ? w2[((long long)t * C1 + c) * Cout + co] : 0.0f;
  }
  __syncthreads();
  const int C1P = (C1 + 3) & ~3;
  for (int p = tid; p < rg::NPIX; p += tf::G::NT) {
    const int ty = p / rg::OW, tx = p % rg::OW, oy = oy0 + ty, ox = ox0 + tx;
    if (oy >= H || ox >= W) continue;
    float* o = out + (((long long)b * H + oy) * W + ox) * Cout;
    for (int co0 = 0; co0 < CP; co0 += 4) {
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int t = 0; t < 9; ++t) {
        const float* hp = hr + ((ty + t / 3) * rg::RW + tx + t % 3) * tf::LDH;
        const float* wt = w2s + t * tf::BN * CP + co0;
        for (int c = 0; c < C1P; c += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(hp + c);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 w4 = *reinterpret_cast<const float4*>(wt + (c + u) * CP);
            s.x = fmaf(hv[u], w4.x, s.x);
            s.y = fmaf(hv[u], w4.y, s.y);
            s.z = fmaf(hv[u], w4.z, s.z);
            s.w = fmaf(hv[u], w4.w, s.w);
          }
        }
      }
      const float sv[4] = {s.x, s.y, s.z, s.w};
      for (int q = 0; q < 4 && co0 + q < Cout; ++q) o[co0 + q] = sv[q] + b2[co0 + q];
    }
  }
}

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

// the region kernels' shape rule (ops/kernels/conv3x3.py::tail_wgmma
// states the bfloat16 one).  bfloat16 on wgmma: the packed conv_hr weights
// (64, 576), Cin == 64 (a patch pixel is one 128-byte row), Cout <= 8
// (conv_last's n8), a 16-byte aligned yp and w1p.  float32: Cin % 4 == 0
// (16-byte gather) and C1 % 4 == 0 (f32k copies w1's rows of C1 floats 4
// at a time, as conv3x3.cu's f32_ok requires of Cout), Cout <= 32 (its
// weights in the stages), 16-byte aligned yp and w1.
bool wgmma_ok(const void* yp, const void* w1p, int Cin, int Cout) {
  return w1p && Cin == tw::C && Cout <= 8 && aligned(yp, 16) && aligned(w1p, 16);
}
bool f32_ok(const void* yp, const void* w1, int Cin, int C1, int Cout) {
  return Cin % 4 == 0 && C1 % 4 == 0 && tf::w2_fits(Cout) && aligned(yp, 16) &&
         aligned(w1, 16);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  H, W, Cin describe the shuffled conv_hr
// input (yp is (B, H/2, W/2, 4 Cin)); w1 (3, 3, Cin, C1), w2 (3, 3, C1,
// Cout); out (B, H, W, Cout).  w1p (may be NULL): w1 packed for the wgmma
// path, (64, 9 Cin) bfloat16 (pack_weights at N = 64).  act: 0 none, 1
// leaky 0.01, 2 leaky 0.2 (after conv_hr).  Returns cudaGetLastError()
// after the launch, or -1 for arguments the kernel refuses.
extern "C" int shuffled_tail_launch(int dtype, const void* yp, const void* w1, const void* w1p,
                                    const void* b1, const void* w2, const void* b2, void* out,
                                    int B, int H, int W, int Cin, int C1, int Cout, int act,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || Cin <= 0 || C1 <= 0 || C1 > BN ||
      Cout <= 0 || act < 0 || act > 2 || (long long)H * W * Cin >= (1LL << 31) ||
      B > 65535)
    return -1;   // (the shuffled gather's offset inside one image is a 32-bit int)
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 regions((unsigned)((W + rg::OW - 1) / rg::OW),
                     (unsigned)((H + rg::OH - 1) / rg::OH), (unsigned)B);
  if (dtype == 1 && wgmma_ok(yp, w1p, Cin, Cout)) {
    if (set_smem(tail_wgmma_kernel, tw::SMEM)) return -1;
    tail_wgmma_kernel<<<regions, tw::NT, tw::SMEM, s>>>((const bf16*)yp, (const bf16*)w1p,
                                                        (const bf16*)b1, (const bf16*)w2,
                                                        (const bf16*)b2, (bf16*)out, H, W, C1,
                                                        Cout, act);
    return (int)cudaGetLastError();
  }
  if (dtype == 0 && f32_ok(yp, w1, Cin, C1, Cout)) {
    if (set_smem(tail_f32_kernel, tf::SMEM)) return -1;
    tail_f32_kernel<<<regions, tf::G::NT, tf::SMEM, s>>>((const float*)yp, (const float*)w1,
                                                         (const float*)b1, (const float*)w2,
                                                         (const float*)b2, (float*)out, H, W,
                                                         Cin, C1, Cout, act);
    return (int)cudaGetLastError();
  }
  // the earlier kernel: a 16 x 16 region on the FP32 pipes
  const int C1P = (C1 + 3) & ~3;
  const size_t w2_bytes = sizeof(float) * 9 * C1P * Cout;
  dim3 grid((unsigned)((W + TO - 1) / TO), (unsigned)((H + TO - 1) / TO), (unsigned)B);
  if (dtype == 0)
    return launch_fp32<float>(grid, w2_bytes, yp, w1, b1, w2, b2, out, H, W, Cin, C1, Cout, act,
                              s);
  if (dtype == 1)
    return launch_fp32<bf16>(grid, w2_bytes, yp, w1, b1, w2, b2, out, H, W, Cin, C1, Cout, act,
                             s);
  return -1;
}
