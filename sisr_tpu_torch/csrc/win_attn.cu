// Softmax attention in windows over an NHWC map, one launch for every
// (window, head) of one HAT or DAT attention call:
//   out[pixel, head] = sum_j softmax_j(q . k_j * d^-0.5 + bias[head, i, j]
//                                      (+ mask[i, j])) v_j
// reading q, k, v in place from the qkv Linear's output (B, H, W, 3C),
// channels [q | k | v] each (head, d), and writing (B, H, W, C) at the
// query's own pixel, in float32 or bfloat16:
//   - the map is taken as zero-padded at the bottom and right to (Hp, Wp)
//     (DAT pads to multiples of 32; HAT pads outside, so Hp = H): a key
//     past the real H x W is a zero read as a zero (a logit of the bias
//     alone, a value of 0), not masked, and a query past it is computed
//     and not written;
//   - key window == window (WH x WW, square for HAT, 8 x 32 for DAT): the
//     keys are the window's pixels; with a shift (sh, sw) the window lies on
//     the padded map rolled by -(sh, sw) (the query and key at rolled (Y, X)
//     are read at ((Y + sh) % Hp, (X + sw) % Wp), and the output written
//     there, which is the roll back) and a pair in different regions of the
//     rolled map (each axis cut at n - window and n - shift) gets -100, from
//     region ids computed here;
//   - two branches (DAT's): the heads split in two halves, the second half
//     in windows of WW x WH with the shift (sw, sh); a head's channels sit
//     at head * d in q, k, v and out whichever branch it is in, so a branch's
//     heads are read and written at its channel offset;
//   - key window > window (HAT's overlapping cross-attention, square): the
//     keys are the key-window square around the window, (wk - ws) / 2
//     pixels past each side; keys past the map are zeros read as zeros.
// No pad, roll, partition, unfold, cat or window-reverse copy is made.  bias
// is the float32 dense (heads, N, M) table (both branches' heads in turn)
// that the wrapper derives once per weight version from the module's
// position table or position MLP.
//
// Replaces no TPU kernel: the JAX package has no softmax window attention
// (HiT-SR's SCC has no softmax); HAT brought it and DAT widened it (PERF.md,
// kernel row 12).
//
// Bound: at HAT's and DAT's widths (d = 30, 256 queries a window; 256 or
// 576 keys for HAT, 256 in 8 x 32 or 32 x 8 for DAT) a score costs 2 x 30
// multiply-adds on the tensor cores but ~10 scalar instructions (scale,
// bias, mask, max, exp2, sum, convert), and the dense bias is read per
// (window, head) from L2, so the instruction rate of the FP32 and SFU pipes
// bounds the kernel, not the 989 TFLOP/s of its products nor the bytes of
// q, k, v and out.  A rectangle changes none of that: it changes which
// pixels a block stages, not how many.  Design: bfloat16 products on
// mma.sync m16n8k16 with float32 accumulators and softmax statistics (flash
// attention's online softmax over key chunks of 64); each warp owns 16
// queries, a block of 8 warps 128 queries of one (window, head); q, k and
// v of the block staged once in shared memory, head size padded to 32 with
// zeros, rows 80 bytes apart so that every ldmatrix is free of bank
// conflicts; scores scaled by log2(e) and exponentiated with exp2f.
// float32: one query a thread on the FP32 pipes (as the port's other
// float32 kernels), keys and values staged 32 at a time.
// Offsets that multiply a pixel by a channel count are 64-bit.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -100.0f;
constexpr int DP = 32;                  // head size padded
constexpr int ROW = DP + 8;             // bfloat16 row stride in shared memory (80 bytes)
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int QROWS = WARPS * 16;       // queries a block (bfloat16 and float32)
constexpr int KC = 64;                  // keys a chunk (bfloat16)
constexpr int FK = 32;                  // keys a chunk (float32)

struct Geo {
  int B, H, W, Hp, Wp, C, heads, hpb, d, sh, sw;   // heads in all; hpb a branch
  int nwin, qblocks;
  float scale;
};

// a window of WH x WW queries and its KH x KW keys (== the window: the
// window itself; larger: the overlapping square)
template <int WH, int WW, int KH, int KW>
struct Win {
  static constexpr int N = WH * WW, M = KH * KW, OH = (KH - WH) / 2, OW = (KW - WW) / 2;
  static constexpr bool OWN = KH == WH && KW == WW;
  static_assert(M % 2 == 0, "keys are read in pairs");
  static constexpr int QBLOCKS = (N + QROWS - 1) / QROWS;
  static constexpr int MP = (M + KC - 1) / KC * KC;     // keys padded to whole chunks
};

// a block's (image, window, head, first query), and its branch's window
// origin and shift
struct Block {
  int b, head, q0, y0, x0, sh, sw;
};

template <int WH, int WW>
__device__ __forceinline__ Block block_of(const Geo& g, int sh, int sw) {
  int bid = blockIdx.x;
  Block k;
  const int qb = bid % g.qblocks;
  bid /= g.qblocks;
  k.head = bid % g.heads;
  bid /= g.heads;
  const int win = bid % g.nwin;
  k.b = bid / g.nwin;
  const int nww = g.Wp / WW;
  k.y0 = win / nww * WH;
  k.x0 = win % nww * WW;
  k.q0 = qb * QROWS;
  k.sh = sh;
  k.sw = sw;
  return k;
}

// the pixel (flat index over B, H, W) at (Y, X) of the map rolled by
// -(sh, sw), or -1 in the padding (PAD: the map is zero-padded to (Hp, Wp);
// without it Hp = H and Wp = W, and HAT's instantiations keep the index
// arithmetic, and the registers, of a kernel that knows no padding)
template <bool PAD>
__device__ __forceinline__ long long pixel(const Geo& g, const Block& k, int Y, int X) {
  int y = Y + k.sh, x = X + k.sw;
  if (y >= g.Hp) y -= g.Hp;
  if (x >= g.Wp) x -= g.Wp;
  if (PAD && (y >= g.H || x >= g.W)) return -1;
  return ((long long)k.b * g.H + y) * g.W + x;
}

template <int WH, int WW, bool PAD>
__device__ __forceinline__ long long query_pixel(const Geo& g, const Block& k, int i) {
  return pixel<PAD>(g, k, k.y0 + i / WW, k.x0 + i % WW);
}

// the pixel of key j, or -1 past the map
template <int WH, int WW, int KH, int KW, bool PAD>
__device__ __forceinline__ long long key_pixel(const Geo& g, const Block& k, int j) {
  using V = Win<WH, WW, KH, KW>;
  if (V::OWN) return query_pixel<WH, WW, PAD>(g, k, j);
  const int y = k.y0 - V::OH + j / KW, x = k.x0 - V::OW + j % KW;
  if (y < 0 || y >= g.H || x < 0 || x >= g.W) return -1;
  return ((long long)k.b * g.H + y) * g.W + x;
}

// region id of rolled coordinate v on an axis of n with window w and
// shift s: 0, 1 or 2
__device__ __forceinline__ int region(int v, int n, int w, int s) {
  return v < n - w ? 0 : (v < n - s ? 1 : 2);
}

// region of window pixel i (rolled map), or 0 without a shift
template <int WH, int WW>
__device__ __forceinline__ int region_of(const Geo& g, const Block& k, int i) {
  if (!(k.sh | k.sw)) return 0;
  return 3 * region(k.y0 + i / WW, g.Hp, WH, k.sh) + region(k.x0 + i % WW, g.Wp, WW, k.sw);
}

// ------------------------------------------------------------- bfloat16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += a (16 x 16, row-major) x b (16 x 8, column-major), bfloat16 in,
// float32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows of (pixel, 2 values) pairs into shared memory by cp.async: row r
// of dst from the head's d channels at part (0 q, 1 k, 2 v) of pixel
// pix(r), zero-filled past d, past n rows and where pix is -1
template <typename Pix>
__device__ __forceinline__ void stage(bf16* dst, int rows, int n, const bf16* qkv,
                                      const Geo& g, int part, int head, Pix pix) {
  const long long c3 = 3LL * g.C;
  const int chan = part * g.C + head * g.d;
  for (int i = threadIdx.x; i < rows * (DP / 2); i += NT) {
    const int r = i / (DP / 2), p = i % (DP / 2);
    const long long px = r < n && 2 * p < g.d ? pix(r) : -1;
    cp_async4(dst + r * ROW + 2 * p, px >= 0 ? qkv + px * c3 + chan + 2 * p : qkv, px >= 0);
  }
}

template <int WH, int WW, int KH, int KW, bool PAD>
__device__ __forceinline__ void attend_bf16(const bf16* __restrict__ qkv,
                                            const float* __restrict__ bias,
                                            bf16* __restrict__ out, const Geo& g, int sh,
                                            int sw, unsigned char* smem) {
  using V = Win<WH, WW, KH, KW>;
  constexpr int mp = V::MP;
  const Block k = block_of<WH, WW>(g, sh, sw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + QROWS * ROW;
  bf16* vs = ks + mp * ROW;
  const int nq = min(QROWS, V::N - k.q0);
  stage(qs, QROWS, nq, qkv, g, 0, k.head,
        [&](int r) { return query_pixel<WH, WW, PAD>(g, k, k.q0 + r); });
  stage(ks, mp, V::M, qkv, g, 1, k.head,
        [&](int r) { return key_pixel<WH, WW, KH, KW, PAD>(g, k, r); });
  stage(vs, mp, V::M, qkv, g, 2, k.head,
        [&](int r) { return key_pixel<WH, WW, KH, KW, PAD>(g, k, r); });
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  if (r0 >= nq) return;
  const int gr = lane >> 2, t = lane & 3;

  uint32_t qa[2][4];
  for (int s = 0; s < 2; ++s)
    ldsm_x4(qa[s], smem_u32(qs + (r0 + (lane & 15)) * ROW + s * 16 + (lane >> 4) * 8));

  // this thread's two query rows: r0 + gr and r0 + gr + 8
  int qi[2], qreg[2];
  const float* brow[2];
  for (int h = 0; h < 2; ++h) {
    qi[h] = k.q0 + r0 + gr + 8 * h;
    const int row = min(qi[h], V::N - 1);         // rows past N are computed, not stored
    qreg[h] = region_of<WH, WW>(g, k, row);
    brow[h] = bias + ((long long)k.head * V::N + row) * V::M;
  }
  const bool shifted = (k.sh | k.sw) != 0;
  const float sc = g.scale * LOG2E;
  float o[4][4] = {};
  float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F}, lrow[2] = {0.0f, 0.0f};

  for (int c0 = 0; c0 < mp; c0 += KC) {
    float s[8][4] = {};
    for (int np = 0; np < 4; ++np) {
      const int n0 = c0 + np * 16;
      for (int st = 0; st < 2; ++st) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(ks + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ROW + st * 16 +
                             ((lane >> 3) & 1) * 8));
        mma16816(s[2 * np], qa[st], kb[0], kb[1]);
        mma16816(s[2 * np + 1], qa[st], kb[2], kb[3]);
      }
    }
    // logits in log2 units, the chunk's row maxima; a thread's keys come in
    // pairs (j, j + 1), and M is even, so a pair's bias is one float2
    float cmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
    for (int nt = 0; nt < 8; ++nt) {
      const int j = c0 + nt * 8 + 2 * t;
      for (int h = 0; h < 2; ++h) {
        float2 add = make_float2(0.0f, 0.0f);
        if (j < V::M) add = __ldg(reinterpret_cast<const float2*>(brow[h] + j));
        if (shifted) {
          if (region_of<WH, WW>(g, k, j) != qreg[h]) add.x += MASK;
          if (region_of<WH, WW>(g, k, j + 1) != qreg[h]) add.y += MASK;
        }
        const float v0 = j < V::M ? fmaf(s[nt][2 * h], sc, add.x * LOG2E) : -CUDART_INF_F;
        const float v1 = j < V::M ? fmaf(s[nt][2 * h + 1], sc, add.y * LOG2E) : -CUDART_INF_F;
        s[nt][2 * h] = v0;
        s[nt][2 * h + 1] = v1;
        cmax[h] = fmaxf(cmax[h], fmaxf(v0, v1));
      }
    }
    float alpha[2];
    for (int h = 0; h < 2; ++h) {
      cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 1));
      cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 2));
      const float mnew = fmaxf(mrow[h], cmax[h]);
      alpha[h] = exp2f(mrow[h] - mnew);
      mrow[h] = mnew;
      lrow[h] *= alpha[h];
    }
    for (int dt = 0; dt < 4; ++dt)
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];
    for (int nt = 0; nt < 8; ++nt)
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mrow[e >> 1]);
        lrow[e >> 1] += p;
        s[nt][e] = p;
      }
    // o += p v, p as the A operand straight from the score fragments
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = c0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, smem_u32(vs + key * ROW + dp * 16 + (lane >> 4) * 8));
        mma16816(o[2 * dp], pa, vb[0], vb[1]);
        mma16816(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  for (int h = 0; h < 2; ++h) {
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
  }
  for (int h = 0; h < 2; ++h) {
    if (qi[h] >= V::N) continue;
    const long long px = query_pixel<WH, WW, PAD>(g, k, qi[h]);
    if (PAD && px < 0) continue;
    const float inv = 1.0f / lrow[h];
    bf16* dst = out + px * (long long)g.C + k.head * g.d;
    for (int dt = 0; dt < 4; ++dt) {
      const int dd = dt * 8 + 2 * t;
      if (dd < g.d)
        *reinterpret_cast<__nv_bfloat162*>(dst + dd) =
            __floats2bfloat162_rn(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
    }
  }
}

// the first branch's heads in WH x WW windows with the shift (sh, sw), the
// second's (if any) in WW x WH with (sw, sh)
template <int WH, int WW, int KH, int KW, bool PAD>
__global__ void __launch_bounds__(NT) win_attn_bf16(const bf16* __restrict__ qkv,
                                                    const float* __restrict__ bias,
                                                    bf16* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool second = (blockIdx.x / g.qblocks) % g.heads >= g.hpb;
  if (WH == WW && KH == KW)
    attend_bf16<WH, WW, KH, KW, PAD>(qkv, bias, out, g, g.sh, g.sw, smem);
  else if (!second)
    attend_bf16<WH, WW, KH, KW, PAD>(qkv, bias, out, g, g.sh, g.sw, smem);
  else
    attend_bf16<WW, WH, KW, KH, PAD>(qkv, bias, out, g, g.sw, g.sh, smem);
}

// -------------------------------------------------------------- float32

template <int WH, int WW, int KH, int KW, bool PAD>
__device__ __forceinline__ void attend_f32(const float* __restrict__ qkv,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, const Geo& g, int sh,
                                           int sw, float (&kv)[2][FK][DP]) {
  using V = Win<WH, WW, KH, KW>;
  const Block k = block_of<WH, WW>(g, sh, sw);
  const int i = k.q0 + threadIdx.x;
  const int row = i < V::N ? i : V::N - 1;
  const long long c3 = 3LL * g.C;
  const long long qpix = query_pixel<WH, WW, PAD>(g, k, row);
  const bool live = i < V::N && (!PAD || qpix >= 0);
  float q[DP], o[DP];
  const float* qp = qkv + (qpix >= 0 ? qpix : 0) * c3 + k.head * g.d;
#pragma unroll
  for (int dd = 0; dd < DP; ++dd) {
    q[dd] = dd < g.d && qpix >= 0 ? qp[dd] * g.scale * LOG2E : 0.0f;
    o[dd] = 0.0f;
  }
  const bool shifted = (k.sh | k.sw) != 0;
  const int qreg = region_of<WH, WW>(g, k, row);
  const float* brow = bias + ((long long)k.head * V::N + row) * V::M;
  float mrow = -CUDART_INF_F, lrow = 0.0f;

  for (int j0 = 0; j0 < V::M; j0 += FK) {
    __syncthreads();
    for (int e = threadIdx.x; e < FK * DP; e += QROWS) {
      const int j = e / DP, dd = e % DP;
      const long long px =
          j0 + j < V::M && dd < g.d ? key_pixel<WH, WW, KH, KW, PAD>(g, k, j0 + j) : -1;
      const float* src = px >= 0 ? qkv + px * c3 + g.C + k.head * g.d + dd : qkv;
      cp_async4(&kv[0][j][dd], src, px >= 0);
      cp_async4(&kv[1][j][dd], px >= 0 ? src + g.C : qkv, px >= 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[FK];
    float cmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      float v = -CUDART_INF_F;
      if (j0 + j < V::M) {
        float acc = 0.0f;
#pragma unroll
        for (int dd = 0; dd < DP; ++dd) acc = fmaf(q[dd], kv[0][j][dd], acc);
        float add = __ldg(brow + j0 + j);
        if (shifted && region_of<WH, WW>(g, k, j0 + j) != qreg) add += MASK;
        v = fmaf(add, LOG2E, acc);
      }
      s[j] = v;
      cmax = fmaxf(cmax, v);
    }
    const float mnew = fmaxf(mrow, cmax);
    const float alpha = exp2f(mrow - mnew);
    mrow = mnew;
    lrow *= alpha;
#pragma unroll
    for (int dd = 0; dd < DP; ++dd) o[dd] *= alpha;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      const float p = exp2f(s[j] - mnew);
      lrow += p;
#pragma unroll
      for (int dd = 0; dd < DP; ++dd) o[dd] = fmaf(p, kv[1][j][dd], o[dd]);
    }
  }
  if (!live) return;
  const float inv = 1.0f / lrow;
  float* dst = out + qpix * (long long)g.C + k.head * g.d;
  for (int dd = 0; dd < g.d; ++dd) dst[dd] = o[dd] * inv;
}

template <int WH, int WW, int KH, int KW, bool PAD>
__global__ void __launch_bounds__(QROWS) win_attn_f32(const float* __restrict__ qkv,
                                                     const float* __restrict__ bias,
                                                     float* __restrict__ out, Geo g) {
  __shared__ __align__(16) float kv[2][FK][DP];
  const bool second = (blockIdx.x / g.qblocks) % g.heads >= g.hpb;
  if (WH == WW && KH == KW)
    attend_f32<WH, WW, KH, KW, PAD>(qkv, bias, out, g, g.sh, g.sw, kv);
  else if (!second)
    attend_f32<WH, WW, KH, KW, PAD>(qkv, bias, out, g, g.sh, g.sw, kv);
  else
    attend_f32<WW, WH, KW, KH, PAD>(qkv, bias, out, g, g.sw, g.sh, kv);
}

template <int WH, int WW, int KH, int KW, bool PAD>
int launch(int dtype, const void* qkv, const void* bias, void* out, Geo g, cudaStream_t s) {
  using V = Win<WH, WW, KH, KW>;
  g.qblocks = V::QBLOCKS;
  g.nwin = (g.Hp / WH) * (g.Wp / WW);
  const long long blocks = (long long)g.B * g.nwin * g.heads * g.qblocks;
  if (blocks >= (1LL << 31)) return -1;
  if (dtype == 1) {
    const size_t bytes = sizeof(bf16) * (size_t)(QROWS + 2 * V::MP) * ROW;
    if (set_smem(win_attn_bf16<WH, WW, KH, KW, PAD>, bytes)) return -1;
    win_attn_bf16<WH, WW, KH, KW, PAD><<<(unsigned)blocks, NT, bytes, s>>>(
        static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
        static_cast<bf16*>(out), g);
  } else if (dtype == 0) {
    win_attn_f32<WH, WW, KH, KW, PAD><<<(unsigned)blocks, QROWS, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias),
        static_cast<float*>(out), g);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// windows compiled: HAT's 16 x 16 with its own keys (wk 0) or the 24 square
// (overlap ratio 0.5), one branch, no padding; DAT's 8 x 32 with its own
// keys, one or two branches (the second in 32 x 8), padded.  Others are
// refused.  heads counts every branch's; (Hp, Wp) is the zero-padded map
// the windows tile.
extern "C" int win_attn_launch(int dtype, const void* qkv, const void* bias, void* out, int B,
                               int H, int W, int Hp, int Wp, int C, int heads, int branches,
                               int wh, int ww, int wk, int sh, int sw, float scale,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || heads <= 0 || C % heads || wh <= 0 || ww <= 0) return -1;
  if (branches < 1 || branches > 2 || heads % branches) return -1;
  const int d = C / heads;
  if (d > DP || d % 2 || Hp < H || Wp < W || Hp % wh || Wp % ww) return -1;
  if (branches == 2 && (Hp % ww || Wp % wh)) return -1;
  if (sh < 0 || sh >= wh || sw < 0 || sw >= ww) return -1;
  if (wk && ((sh | sw) || wh != ww || branches != 1 || Hp != H || Wp != W)) return -1;
  Geo g;
  g.B = B, g.H = H, g.W = W, g.Hp = Hp, g.Wp = Wp, g.C = C, g.heads = heads;
  g.hpb = heads / branches, g.d = d, g.sh = sh, g.sw = sw;
  g.nwin = 0, g.qblocks = 0;
  g.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  const bool unpadded = Hp == H && Wp == W;
  if (wh == 16 && ww == 16 && !wk && branches == 1 && unpadded)
    return launch<16, 16, 16, 16, false>(dtype, qkv, bias, out, g, s);
  if (wh == 16 && ww == 16 && wk == 24)
    return launch<16, 16, 24, 24, false>(dtype, qkv, bias, out, g, s);
  if (wh == 8 && ww == 32 && !wk) return launch<8, 32, 8, 32, true>(dtype, qkv, bias, out, g, s);
  return -1;
}
