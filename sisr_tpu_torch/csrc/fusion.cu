// The Fusion gate between the deep and shallow streams (reference
// models/hit_sir_pro.py:104-162): three UnionAttentions on a, a + b and b,
// then out = a * sigmoid(a_att * g) + b * sigmoid(b_att * (1 - g)) with
// g = sigmoid(ua2).  NHWC, a and b (B, H, W, C) in float32 or bfloat16.
//
// Replaces sisr_tpu/ops/pallas/fusion_ops.py:
//   fusion_pools_launch   _fusion_pools_pallas (_pools_kernel): the nine
//                         mean/max pool pairs over C, H and W of a, a+b, b;
//   fusion_maps_gate_launch  _fused_fusion_pallas: its maps kernel
//                         (_maps_kernel) and gate kernel (_gate_kernel).
//
// Pools.  The TPU kernel reads a and b once in row bands and folds the H
// pools across the sequential band steps in its output block.  CUDA blocks
// run in parallel, and float atomics would make a result change from run
// to run, so the pools take two passes with no cross-block sums: a block a
// row for the C pools (a warp a pixel) and the W pools (a thread a
// channel), then a thread a (w, c) column for the H pools.  Read-bound:
// one 192^2 x 180 bf16 tile reads 26.5 MB (~8 us at 3.35 TB/s); these
// passes read a and b twice (the second pass partly from L2).  a + b is
// formed in registers, rounded to the storage type as the plain version's
// a + b is.
//
// Maps.  Each UnionAttention ends in conv_last(c_att + h_att + w_att), and
// conv_last is linear, so it splits over the three broadcast terms: the
// row-constant h_att becomes a 1-D conv along W with row-summed kernels
// (hout, plus the corrections hcorr where row 0 / H-1 misses a kernel row
// to the zero padding), the column-constant w_att a 1-D conv along H (wout,
// wcorr), and c_att a 9-tap product with the channel-summed kernel (k1blk)
// left to the gate.  One launch: blocks for c_att (3x3 conv of the C pools
// over (H, W)) and blocks for the folded maps, each a row tile of h_att or
// w_att (3x3 convs of the H / W pools over (C, W) / (C, H), computed into
// shared memory) times the nine (C, C) kernels of its side.  About 0.7
// GFLOP a tile on the FP32 pipes, in float32 as the TPU kernel keeps it.
//
// Gate.  A block per (image, row, 16 pixels), a thread per channel: the
// 27-tap c_att patches of its pixels are gathered from catt into shared
// memory (rounded to the compute type first, as the TPU kernel rounds p27;
// never materialized), base = p27 @ k1blk, plus hout[w] and wout[h], minus
// the border corrections, then the sigmoids and the gate in float32, stored
// in a's type.  Reads a and b, writes out: ~42 MB a bf16 tile, ~12.5 us.
#include "common.cuh"

#include <algorithm>

namespace {

// ---- pools ------------------------------------------------------------------

constexpr int POOL_NT = 256;

// cp (B, 6, H, W) and wp (B, 6, H, C) of image row (blockIdx.y, blockIdx.x);
// slot 2k is the mean and 2k+1 the max of source k (a, a+b, b)
template <typename T>
__global__ void __launch_bounds__(POOL_NT)
pools_rows(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ cp,
           T* __restrict__ wp, int H, int W, int C) {
  const int h = blockIdx.x, bi = blockIdx.y;
  const long long row = ((long long)bi * H + h) * W * C;
  const T* ar = a + row;
  const T* br = b + row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // C pools: a warp per pixel, lanes over channels
  for (int w = warp; w < W; w += POOL_NT / 32) {
    float s[3] = {0.0f, 0.0f, 0.0f}, m[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int c = lane; c < C; c += 32) {
      const float va = to_f<T>(ar[w * C + c]), vb = to_f<T>(br[w * C + c]);
      const float v[3] = {va, to_f<T>(from_f<T>(va + vb)), vb};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] += v[k];
        m[k] = fmaxf(m[k], v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s[k] = warp_sum(s[k]);
      m[k] = warp_max(m[k]);
      if (lane == 0) {
        cp[(((long long)bi * 6 + 2 * k) * H + h) * W + w] = from_f<T>(s[k] / (float)C);
        cp[(((long long)bi * 6 + 2 * k + 1) * H + h) * W + w] = from_f<T>(m[k]);
      }
    }
  }
  // W pools: a thread per channel, over the row's pixels
  for (int c = threadIdx.x; c < C; c += POOL_NT) {
    float s[3] = {0.0f, 0.0f, 0.0f}, m[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int w = 0; w < W; ++w) {
      const float va = to_f<T>(ar[w * C + c]), vb = to_f<T>(br[w * C + c]);
      const float v[3] = {va, to_f<T>(from_f<T>(va + vb)), vb};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] += v[k];
        m[k] = fmaxf(m[k], v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      wp[(((long long)bi * 6 + 2 * k) * H + h) * C + c] = from_f<T>(s[k] / (float)W);
      wp[(((long long)bi * 6 + 2 * k + 1) * H + h) * C + c] = from_f<T>(m[k]);
    }
  }
}

// hp (B, 6, W, C) float32: a block holds COLS consecutive (w, c) columns
// in ROWG row groups, each summing every ROWG-th row; the groups are then
// combined in a fixed order
constexpr int COLS = 64, ROWG = POOL_NT / COLS;

template <typename T>
__global__ void __launch_bounds__(POOL_NT)
pools_cols(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ hp, int H,
           int W, int C) {
  __shared__ float part[ROWG][6][COLS];
  const long long WC = (long long)W * C;
  const int col = threadIdx.x % COLS, g = threadIdx.x / COLS, bi = blockIdx.y;
  const long long e = (long long)blockIdx.x * COLS + col;
  float s[3] = {0.0f, 0.0f, 0.0f}, m[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  if (e < WC) {
    const T* ap = a + (long long)bi * H * WC + e;
    const T* bp = b + (long long)bi * H * WC + e;
#pragma unroll 4
    for (int h = g; h < H; h += ROWG) {
      const float va = to_f<T>(ap[h * WC]), vb = to_f<T>(bp[h * WC]);
      const float v[3] = {va, to_f<T>(from_f<T>(va + vb)), vb};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] += v[k];
        m[k] = fmaxf(m[k], v[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    part[g][2 * k][col] = s[k];
    part[g][2 * k + 1][col] = m[k];
  }
  __syncthreads();
  if (g != 0 || e >= WC) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float ts = part[0][2 * k][col], tm = part[0][2 * k + 1][col];
    for (int q = 1; q < ROWG; ++q) {
      ts += part[q][2 * k][col];
      tm = fmaxf(tm, part[q][2 * k + 1][col]);
    }
    hp[((long long)bi * 6 + 2 * k) * WC + e] = ts / (float)H;
    hp[((long long)bi * 6 + 2 * k + 1) * WC + e] = tm;
  }
}

// ---- maps -------------------------------------------------------------------

constexpr int MAP_NT = 256;
constexpr int MAP_R = 8;   // output rows of a folded-map block

struct Maps {
  // pools and packed weights (fusion_ops.py::pack_params)
  const void *cp, *wp;   // the compute type
  const float* hp;
  const float *c1w, *c2w, *c3w, *cb, *clb;   // (3, 18), (3, 18), (3, 18), (9,), (3, C)
  const void* khw;                            // (3, 18, C, C), the compute type
  // outputs, float32
  float *catt, *hout, *wout, *hcorr, *wcorr;  // (B,3,H,W) (B,3,W,C) (B,3,H,C) (B,2,3,W,C) (B,2,3,H,C)
  int B, H, W, C;
};

// c_att[k] = conv1 of (cp[2k], cp[2k+1]) over (H, W), zero padded; a block
// per (b, k, h) row
template <typename T>
__device__ void catt_row(const Maps& p, int bi, int k, int h) {
  const T* cp = (const T*)p.cp;
  const float* w = p.c1w + k * 18;
  for (int x = threadIdx.x; x < p.W; x += MAP_NT) {
    float acc = 0.0f;
    for (int ch = 0; ch < 2; ++ch) {
      const T* m = cp + (((long long)bi * 6 + 2 * k + ch) * p.H) * p.W;
      for (int i = 0; i < 3; ++i) {
        const int yy = h + i - 1;
        if (yy < 0 || yy >= p.H) continue;
        for (int j = 0; j < 3; ++j) {
          const int xx = x + j - 1;
          if (xx >= 0 && xx < p.W) acc = fmaf(to_f<T>(m[(long long)yy * p.W + xx]), w[ch * 9 + i * 3 + j], acc);
        }
      }
    }
    p.catt[(((long long)bi * 3 + k) * p.H + h) * p.W + x] = acc + p.cb[3 * k];
  }
}

// rows r0-1 .. r0+MAP_R of the (N, C) map att (h_att: N = W from hp with
// conv2; w_att: N = H from wp with conv3) into src[MAP_R+2][C], zero
// outside [0, N).  The conv runs over the grid (C, N): out[n][c] = bias +
// sum pool[ch][n + bb - 1][c + a - 1] * w[ch*9 + a*3 + bb]
template <typename P>
__device__ void side_rows(float* src, const P* pool2, const float* w, float bias, int N, int C,
                          int r0) {
  for (int e = threadIdx.x; e < (MAP_R + 2) * C; e += MAP_NT) {
    const int rr = e / C, c = e % C, n = r0 - 1 + rr;
    float acc = 0.0f;
    if (n >= 0 && n < N) {
      for (int ch = 0; ch < 2; ++ch) {
        const P* m = pool2 + (long long)ch * N * C;
        for (int bb = 0; bb < 3; ++bb) {
          const int nn = n + bb - 1;
          if (nn < 0 || nn >= N) continue;
          for (int a = 0; a < 3; ++a) {
            const int cc = c + a - 1;
            if (cc >= 0 && cc < C) acc = fmaf(to_f<P>(m[(long long)nn * C + cc]), w[ch * 9 + a * 3 + bb], acc);
          }
        }
      }
      acc += bias;
    }
    src[e] = acc;
  }
}

// out_q[r][n] = sum_j sum_c src[r + j][c] * khw[k][base + 3q + j][c][n] for
// q < 3 (the main map, then its two border corrections), rows r0 .. r0+MAP_R-1
template <typename T>
__device__ void folded_rows(const Maps& p, const float* src, int k, int base, int N, int r0,
                            float* o0, float* o1, float* o2, const float* bias) {
  const T* khw = (const T*)p.khw;
  const int C = p.C;
  const long long CC = (long long)C * C;
  for (int n = threadIdx.x; n < C; n += MAP_NT) {
    float acc[3][MAP_R];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int r = 0; r < MAP_R; ++r) acc[q][r] = 0.0f;
    for (int j = 0; j < 3; ++j) {
      const T* k0 = khw + ((long long)k * 18 + base + j) * CC + n;
      const T* k1 = k0 + 3 * CC;
      const T* k2 = k0 + 6 * CC;
      for (int c = 0; c < C; ++c) {
        const float w0 = to_f<T>(k0[(long long)c * C]), w1 = to_f<T>(k1[(long long)c * C]),
                    w2 = to_f<T>(k2[(long long)c * C]);
#pragma unroll
        for (int r = 0; r < MAP_R; ++r) {
          const float s = src[(r + j) * C + c];
          acc[0][r] = fmaf(s, w0, acc[0][r]);
          acc[1][r] = fmaf(s, w1, acc[1][r]);
          acc[2][r] = fmaf(s, w2, acc[2][r]);
        }
      }
    }
    const float bn = bias ? bias[n] : 0.0f;
#pragma unroll
    for (int r = 0; r < MAP_R; ++r) {
      if (r0 + r >= N) break;
      const long long o = (long long)(r0 + r) * C + n;
      o0[o] = acc[0][r] + bn;
      o1[o] = acc[1][r];
      o2[o] = acc[2][r];
    }
  }
}

// blocks [0, B*3*H): c_att rows; then B * 3 * 2 * tiles folded-map blocks
// (side 0: hout/hcorr along W; side 1: wout/wcorr along H)
template <typename T>
__global__ void __launch_bounds__(MAP_NT) fusion_maps(Maps p) {
  extern __shared__ float src[];   // (MAP_R + 2) x C
  const int n_catt = p.B * 3 * p.H;
  int blk = blockIdx.x;
  if (blk < n_catt) {
    catt_row<T>(p, blk / (3 * p.H), (blk / p.H) % 3, blk % p.H);
    return;
  }
  blk -= n_catt;
  const int tw = (p.W + MAP_R - 1) / MAP_R, th = (p.H + MAP_R - 1) / MAP_R;
  const int per = tw + th;
  const int bk = blk / per, t = blk % per;
  const int bi = bk / 3, k = bk % 3;
  const int C = p.C;
  if (t < tw) {
    const int r0 = t * MAP_R;
    side_rows(src, p.hp + ((long long)bi * 6 + 2 * k) * p.W * C, p.c2w + k * 18,
              p.cb[3 * k + 1], p.W, C, r0);
    __syncthreads();
    const long long WC = (long long)p.W * C;
    folded_rows<T>(p, src, k, 0, p.W, r0, p.hout + ((long long)bi * 3 + k) * WC,
                   p.hcorr + ((long long)bi * 6 + k) * WC, p.hcorr + ((long long)bi * 6 + 3 + k) * WC,
                   p.clb + k * C);
  } else {
    const int r0 = (t - tw) * MAP_R;
    side_rows(src, (const T*)p.wp + ((long long)bi * 6 + 2 * k) * p.H * C, p.c3w + k * 18,
              p.cb[3 * k + 2], p.H, C, r0);
    __syncthreads();
    const long long HC = (long long)p.H * C;
    folded_rows<T>(p, src, k, 9, p.H, r0, p.wout + ((long long)bi * 3 + k) * HC,
                   p.wcorr + ((long long)bi * 6 + k) * HC, p.wcorr + ((long long)bi * 6 + 3 + k) * HC,
                   nullptr);
  }
}

// ---- gate -------------------------------------------------------------------

constexpr int GATE_TW = 16;   // pixels of a gate block

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T>
__global__ void fusion_gate(const T* __restrict__ a, const T* __restrict__ b,
                            const T* __restrict__ k1blk, const float* __restrict__ catt,
                            const float* __restrict__ hout, const float* __restrict__ wout,
                            const float* __restrict__ hcorr, const float* __restrict__ wcorr,
                            T* __restrict__ out, int H, int W, int C) {
  __shared__ float p27[27][GATE_TW];
  const int x0 = blockIdx.x * GATE_TW, h = blockIdx.y, bi = blockIdx.z;
  // the 27 taps (k, i, j) of c_att around each pixel, zero padded, rounded
  // to the compute type
  for (int e = threadIdx.x; e < 27 * GATE_TW; e += blockDim.x) {
    const int tap = e / GATE_TW, px = e % GATE_TW;
    const int k = tap / 9, i = (tap % 9) / 3, j = tap % 3;
    const int yy = h + i - 1, xx = x0 + px + j - 1;
    float v = 0.0f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = to_f<T>(from_f<T>(catt[(((long long)bi * 3 + k) * H + yy) * W + xx]));
    p27[tap][px] = v;
  }
  __syncthreads();
  const long long WC = (long long)W * C, HC = (long long)H * C;
  const int npx = min(GATE_TW, W - x0);
  for (int n = threadIdx.x; n < C; n += blockDim.x) {
    float kt[27], wo[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int t = 0; t < 9; ++t) kt[9 * k + t] = to_f<T>(k1blk[(long long)(9 * k + t) * 3 * C + k * C + n]);
      wo[k] = wout[((long long)bi * 3 + k) * HC + (long long)h * C + n];
    }
    for (int px = 0; px < npx; ++px) {
      const int x = x0 + px;
      float att[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float base = 0.0f;
#pragma unroll
        for (int t = 0; t < 9; ++t) base = fmaf(p27[9 * k + t][px], kt[9 * k + t], base);
        float v = base + hout[((long long)bi * 3 + k) * WC + (long long)x * C + n] + wo[k];
        if (h == 0) v -= hcorr[((long long)bi * 6 + k) * WC + (long long)x * C + n];
        if (h == H - 1) v -= hcorr[((long long)bi * 6 + 3 + k) * WC + (long long)x * C + n];
        if (x == 0) v -= wcorr[((long long)bi * 6 + k) * HC + (long long)h * C + n];
        if (x == W - 1) v -= wcorr[((long long)bi * 6 + 3 + k) * HC + (long long)h * C + n];
        att[k] = v;
      }
      const long long o = (((long long)bi * H + h) * W + x) * C + n;
      const float g = sigmoid_f(att[1]);
      const float va = to_f<T>(a[o]), vb = to_f<T>(b[o]);
      out[o] = from_f<T>(va * sigmoid_f(att[0] * g) + vb * sigmoid_f(att[2] * (1.0f - g)));
    }
  }
}

template <typename T>
int pools(const void* a, const void* b, void* cp, float* hp, void* wp, int B, int H, int W, int C,
          cudaStream_t s) {
  pools_rows<T><<<dim3(H, B), POOL_NT, 0, s>>>((const T*)a, (const T*)b, (T*)cp, (T*)wp, H, W, C);
  const long long WC = (long long)W * C;
  pools_cols<T><<<dim3((unsigned)((WC + COLS - 1) / COLS), B), POOL_NT, 0, s>>>(
      (const T*)a, (const T*)b, hp, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T>
int maps_gate(const void* a, const void* b, const Maps& p, const void* k1blk, void* out,
              cudaStream_t s) {
  const int tw = (p.W + MAP_R - 1) / MAP_R, th = (p.H + MAP_R - 1) / MAP_R;
  const int nblk = p.B * 3 * p.H + p.B * 3 * (tw + th);
  const size_t smem = sizeof(float) * (MAP_R + 2) * p.C;
  if (set_smem(fusion_maps<T>, smem)) return -1;
  fusion_maps<T><<<nblk, MAP_NT, smem, s>>>(p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int nt = std::min(256, (p.C + 31) / 32 * 32);
  fusion_gate<T><<<dim3((p.W + GATE_TW - 1) / GATE_TW, p.H, p.B), nt, 0, s>>>(
      (const T*)a, (const T*)b, (const T*)k1blk, p.catt, p.hout, p.wout, p.hcorr, p.wcorr,
      (T*)out, p.H, p.W, p.C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  a, b (B, H, W, C); cp (B, 6, H, W) and wp
// (B, 6, H, C) in a's type, hp (B, 6, W, C) float32.  Two launches.
// Returns cudaGetLastError() after them, or -1 for refused arguments.
extern "C" int fusion_pools_launch(int dtype, const void* a, const void* b, void* cp, void* hp,
                                   void* wp, int B, int H, int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return pools<float>(a, b, cp, (float*)hp, wp, B, H, W, C, s);
  if (dtype == 1) return pools<bf16>(a, b, cp, (float*)hp, wp, B, H, W, C, s);
  return -1;
}

// The maps and gate launches, after fusion_pools_launch: the pools cp, hp,
// wp; the packed weights c1w, c2w, c3w (3, 18), cb (9,), clb (3, C) float32
// and khw (3, 18, C, C), k1blk (27, 3C) in a's type; scratch holds
// B * (3HW + 9WC + 9HC) floats (catt, hout, wout, hcorr, wcorr); out (B, H,
// W, C) in a's type.  Returns cudaGetLastError(), or -1 for refused
// arguments.
extern "C" int fusion_maps_gate_launch(int dtype, const void* a, const void* b, const void* cp,
                                       const void* hp, const void* wp, const void* c1w,
                                       const void* c2w, const void* c3w, const void* cb,
                                       const void* khw, const void* clb, const void* k1blk,
                                       void* scratch, void* out, int B, int H, int W, int C,
                                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return -1;
  float* f = (float*)scratch;
  const long long HW = (long long)H * W, WC = (long long)W * C, HC = (long long)H * C;
  Maps p;
  p.cp = cp;
  p.wp = wp;
  p.hp = (const float*)hp;
  p.c1w = (const float*)c1w;
  p.c2w = (const float*)c2w;
  p.c3w = (const float*)c3w;
  p.cb = (const float*)cb;
  p.clb = (const float*)clb;
  p.khw = khw;
  p.catt = f;
  p.hout = p.catt + B * 3 * HW;
  p.wout = p.hout + B * 3 * WC;
  p.hcorr = p.wout + B * 3 * HC;
  p.wcorr = p.hcorr + B * 6 * WC;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return maps_gate<float>(a, b, p, k1blk, out, s);
  if (dtype == 1) return maps_gate<bf16>(a, b, p, k1blk, out, s);
  return -1;
}
