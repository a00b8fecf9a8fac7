// One whole HierarchicalTransformerBlock for degenerate windows (window ==
// base window: the 4- and 8-windows, L = 16 or 64 tokens, 12 of the
// flagship's 36 blocks), without the attention output ever reaching device
// memory:
//   qkv  = x + SCA(x)
//   attn = proj(SCC(qkv))                      (scc_block.cu's function)
//   x2   = x + LN1(attn);  h = gelu(x2 @ W1 + b1)
//   out  = x2 + LN2((h + gelu(dw5x5(h) + dwb)) @ W2 + b2)   (+ next block's stats)
//
// Replaces sisr_tpu/ops/pallas/htb_block.py::htb_fused (_make_fused_kernel).
// The TPU kernel walks window-row bands in order as one lagged pipeline and
// carries x2 and h of the previous band in VMEM for the depthwise conv's
// halo.  CUDA blocks carry nothing, so two launches, A (the attention, LN1
// and fc1 of whole windows; only x2 and h leave it) and B (the tail over
// output tiles, reading h on its halo and x2 as stored).
//
// Bound on the H100: per token ~16 k (k), 32 k (proj), 65 k (fc1), 65 k
// (fc2), ~25 k (the L <= 64 attention) multiply-adds against ~1.5 KB of
// bf16 traffic (x, x2, h, out, h read again): arithmetic.
//
// bfloat16 at the model's shapes (C = 180 in 6 heads, Ch = 360, L = 16 or
// 64; fwg below): launch A is htb_fused_wg, one 64-token tile a block
// (four 4x4 windows or one 8x8) on scc_block's wgmma phases (scc_wg.cuh:
// qkv, k, the gram, KP / VP through the block-diagonal pooling tile, M
// and VP_big as hi + lo pairs, [out_s | out_c], the projection), then on
// the same tile while it is on chip x2 = x + LN1(attn) (to device memory,
// and into shared memory as fc1's A operand) and fc1 with its gelu
// epilogue (htb_tail_wg.cuh's product and per-pair rounding, the packed
// W1's two n184 halves).  The attention fills the block's shared memory
// (231 KB at L = 64), so the packed W1 (141 KB) cannot stay resident: it
// streams from L2 in its three 64-deep K blocks, those that fit into the
// regions the window loop frees (bias, pool, gram, Ball: two blocks at L =
// 64, one at 16) behind the tile's x rows while the projection runs, the
// others over the projection's weights once its product is done; fc1
// starts on the first blocks while the last land.  On an H100 (clock64
// phase marks) the streaming costs ~0.4k cycles of a ~90k-cycle tile:
// staging W1 once for four tiles, with x2 read back from L2, ran slower.
// What costs time is the CUDA-core epilogues (LN1, gelu) at one 8-warp
// block an SM and the instruction cache: the kernel's straight-line code
// runs once a block, so its epilogue is written as loops (~130 KB of
// SASS, against 172 KB unrolled, which slowed the attention by 17%).
// Launch B is htb_tail's wgmma tail (htb_tail_wg.cuh::tail_out: persistent
// blocks over 8x16 tiles, h by TMA, the taps beside fc2 on wgmma, the
// statistics' sums into per-block slots) over the whole map as one band: h
// and x2 stay whole, as the earlier kernels kept them.
// Values round to bfloat16 exactly where the two-kernel chain (scc_block,
// then htb_tail) rounds them, so the two store the same bits.
//
// float32, and bfloat16 at other shapes: the earlier kernels.
//   A (htb_fused_attn_fc1): a block of 512 threads takes 64 tokens of whole
//     windows (4 windows of 4x4 or one of 8x8), computes qkv, the degenerate
//     SCC, the projection, x2 and h in shared memory and writes only x2 and
//     h.  16 warps a block, and in bfloat16 two blocks per SM (97 KB of
//     shared memory each; 188 KB in float32, one), hide latency.  The
//     attention map lives in the block's shared memory (Qt below, between
//     the projection and LN1) and nowhere else.
//   B (htb_fused_tail_*): htb_tail.cuh's tail stage over 8x8 tiles, reading
//     h with its halo and x2 as stored (htb_tail rebuilds x from attn).
// Design of A: the degenerate window pools by one scalar (KP = pw*k + pb),
// so the spatial branch is the plain version's own form, per head scores
// S = q KP^T / d + bias (L x L) then S @ VP, and the channel branch is
// reassociated for L < C/2: out_c = ((v k^T) / L) q (L x L, not C/2 x C/2).
// Both run on the FP32 pipes in either type (the plain version keeps the
// spatial branch in float32), a thread taking 4 consecutive tokens of one
// window, so that one 4-token load and one broadcast value feed 4
// independent FMAs.  The three large products (k, proj, fc1) are
// block_gemm: bfloat16 on the tensor cores (wmma, operands channel-major in
// shared memory read as col-major A fragments), float32 as register tiles on
// the FP32 pipes.  Values are rounded to the storage type where the plain
// version stores them: qkv, k, [out_s | out_c], attn (as the two-kernel
// chain stores it, before LN1), LN1's output, x2 and h.
#include "htb_tail.cuh"
#include "htb_tail_wg.cuh"
#include "scc_wg.cuh"

#include <type_traits>

namespace {

constexpr int TOK = 64;           // tokens of a launch-A block: whole windows
constexpr int NTA = 512;          // threads of a launch-A block
constexpr int NWA = NTA / 32;
constexpr int LDP = TOK + 8;      // token stride of the channel-major tiles
constexpr int KMAX = MAX_C;       // channel rows, padded to whole MMA depths
constexpr int HMAX = 96;          // C/2 rows of k
constexpr int NB = 64;            // output columns per block_gemm chunk
constexpr int LDB = NB + 8, LDC = NB + 4;
constexpr int NPAT = 18;          // SCA patch taps per token

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBR;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragAcc;

struct FArgs {
  const void *x, *patches, *w9a, *b9a, *w9m, *b9m, *s1, *s2;  // patches NULL: no SCA
  const void *wkv, *bb, *pmat;
  const float* pb;
  const void *bias, *proj, *projb, *ln1s, *ln1b, *w1, *b1;
  void *x2, *hbuf;
  int B, H, W, C, heads, wh, ww, Ch;
};

struct Geo {
  int L, half, d, nwh, nww, nwin, nwb;  // nwb: windows a block
};

// pixel of token l of window win
__device__ __forceinline__ long long token_pixel(const FArgs& a, const Geo& g, int win, int l) {
  const int wx = win % g.nww, wy = (win / g.nww) % g.nwh, bi = win / (g.nww * g.nwh);
  return ((long long)bi * a.H + wy * a.wh + l / a.ww) * a.W + wx * a.ww + l % a.ww;
}

// block_gemm: v(p, n) = sum_{k < K} At[k][p] * Bw[k][n] for p < TOK, n < N,
// handed to epi(p, n, v).  At is channel-major in shared memory (row stride
// LDP) with rows [K, K rounded up to 16) zero; Bw (K x N) row-major in
// device memory, staged NB columns at a time by 4-byte cp.async copies, all
// of a chunk in flight at once (N even, Bw 4-byte aligned).  Starts and
// ends with a barrier, so At may be written before and after.

// float32: 2 tokens x 4 columns a thread; stage holds KMAX x NB floats
template <typename Epi>
__device__ void block_gemm(const float* At, int K, const float* __restrict__ Bw, int N,
                           unsigned char* stage, Epi epi) {
  static_assert(TOK / 2 * (NB / 4) == NTA, "thread tile");
  float* Bs = (float*)stage;
  const int tid = threadIdx.x, pg = tid / (NB / 4), jg = tid % (NB / 4);
  for (int n0 = 0; n0 < N; n0 += NB) {
    __syncthreads();
    for (int e = tid; e < K * NB; e += NTA) {
      const int k = e / NB, j = e % NB;
      const bool ok = n0 + j < N;
      cp_async4(Bs + e, ok ? Bw + (long long)k * N + n0 + j : Bw, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float acc[2][4] = {};
    for (int k = 0; k < K; ++k) {
      const float2 x = *reinterpret_cast<const float2*>(At + k * LDP + 2 * pg);
      const float4 w = *reinterpret_cast<const float4*>(Bs + k * NB + 4 * jg);
      const float xs[2] = {x.x, x.y}, ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ws[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + 4 * jg + j < N) epi(2 * pg + i, n0 + 4 * jg + j, acc[i][j]);
  }
  __syncthreads();
}

// bfloat16 on the tensor cores: 4 x 4 fragments of a chunk, one a warp;
// stage holds the Bw chunk (KMAX x LDB bf16), then over it the
// accumulators (TOK x LDC floats)
constexpr size_t STAGE_TC = sizeof(bf16) * KMAX * LDB > sizeof(float) * TOK * LDC
                                ? sizeof(bf16) * KMAX * LDB : sizeof(float) * TOK * LDC;

template <typename Epi>
__device__ void block_gemm(const bf16* At, int K, const bf16* __restrict__ Bw, int N,
                           unsigned char* stage, Epi epi) {
  bf16* Bs = (bf16*)stage;
  float* Cs = (float*)stage;
  const int kp = (K + 15) & ~15;
  static_assert((TOK / 16) * (NB / 16) == NWA, "a fragment a warp");
  const int tid = threadIdx.x, warp = tid >> 5, mt = warp / (NB / 16), nt = warp % (NB / 16);
  for (int n0 = 0; n0 < N; n0 += NB) {
    __syncthreads();
    for (int e = tid; e < kp * (NB / 2); e += NTA) {   // bf16 pairs (N even)
      const int k = e / (NB / 2), j = 2 * (e % (NB / 2));
      const bool ok = k < K && n0 + j < N;
      cp_async4(Bs + k * LDB + j, ok ? Bw + (long long)k * N + n0 + j : Bw, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    FragAcc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < kp; k += 16) {
      FragAT fa;
      FragBR fb;
      wmma::load_matrix_sync(fa, At + k * LDP + mt * 16, LDP);
      wmma::load_matrix_sync(fb, Bs + k * LDB + nt * 16, LDB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    __syncthreads();   // every read of Bs is done before Cs overwrites it
    wmma::store_matrix_sync(Cs + mt * 16 * LDC + nt * 16, acc, LDC, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < TOK * NB; e += NTA) {
      const int p = e / NB, j = e % NB;
      if (n0 + j < N) epi(p, n0 + j, Cs[p * LDC + j]);
    }
  }
  __syncthreads();
}

template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
  return std::is_same<T, bf16>::value ? STAGE_TC : sizeof(float) * KMAX * NB;
}

// the stage also holds the SCA weights and patches (before the first
// product) and the scores St (between the first product and the second)
static_assert(STAGE_TC >= sizeof(float) * TOK * TOK &&
              STAGE_TC >= sizeof(float) * (22 * MAX_C + TOK * NPAT), "stage reuse");

// 97 KB in bfloat16: two blocks per SM; 188 KB in float32: one
template <typename T>
constexpr size_t smem_a() {
  return sizeof(T) * (2 * KMAX + HMAX) * LDP + stage_bytes<T>() + sizeof(long long) * TOK;
}

// round to the storage type and back
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f<T>(from_f<T>(v)); }

template <typename T>
__global__ void __launch_bounds__(NTA, 2) htb_fused_attn_fc1(FArgs a, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qt = (T*)smem;                       // KMAX x LDP: qkv, then attn
  T* Ot = Qt + KMAX * LDP;                // KMAX x LDP: [out_s | out_c], then x2
  T* Kt = Ot + KMAX * LDP;                // HMAX x LDP: k
  unsigned char* stage = (unsigned char*)(Kt + HMAX * LDP);
  float* St = (float*)stage;              // L x TOK: scores, token-minor, over the stage
  long long* pix = (long long*)(stage + stage_bytes<T>());   // TOK: each token's pixel

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = a.C, half = g.half, L = g.L, d = g.d;
  const int win0 = blockIdx.x * g.nwb;
  const int tv = min(g.nwb, g.nwin - win0) * L;   // the block's tokens
  const T* x = (const T*)a.x;
  const T zero = from_f<T>(0.0f);

  for (int e = tid; e < (2 * KMAX + HMAX) * LDP; e += NTA) Qt[e] = zero;
  for (int t = tid; t < tv; t += NTA) pix[t] = token_pixel(a, g, win0 + t / L, t % L);

  // qkv = x + (leaky(P9a w9a + b9a) s1 + leaky(P9m w9m + b9m) s2) / 2
  float* Sw = (float*)stage;      // 22 x C: w9a (9 rows), w9m (9), b9a, b9m, s1, s2
  float* Pt = Sw + 22 * C;        // TOK x NPAT: the tokens' patches
  const bool sca = a.patches != nullptr;
  const int img_wins = g.nww * g.nwh, bi0 = win0 / img_wins;
  // loads of device memory UQ at a time, all issued before any is stored,
  // so that their latencies overlap
  constexpr int UQ = 8;
  const auto stage_in = [&](int n, auto load, auto store) {
    for (int e0 = tid; e0 < n; e0 += UQ * NTA) {
      float v[UQ];
#pragma unroll
      for (int u = 0; u < UQ; ++u) v[u] = e0 + u * NTA < n ? load(e0 + u * NTA) : 0.0f;
#pragma unroll
      for (int u = 0; u < UQ; ++u)
        if (e0 + u * NTA < n) store(e0 + u * NTA, v[u]);
    }
  };
  if (sca)
    stage_in(22 * C, [&](int e) {
      const int r = e / C, c = e % C;
      // s1, s2 of the block's first image (a later one reads its own below)
      const T* src = r < 9 ? (const T*)a.w9a + r * C
                     : r < 18 ? (const T*)a.w9m + (r - 9) * C
                     : r == 18 ? (const T*)a.b9a : r == 19 ? (const T*)a.b9m
                     : (const T*)(r == 20 ? a.s1 : a.s2) + (long long)bi0 * C;
      return to_f<T>(src[c]);
    }, [&](int e, float v) { Sw[e] = v; });
  __syncthreads();   // pix is written
  if (sca)
    stage_in(tv * NPAT,
             [&](int e) { return to_f<T>(((const T*)a.patches)[pix[e / NPAT] * NPAT + e % NPAT]); },
             [&](int e, float v) { Pt[e] = v; });
  __syncthreads();
  for (int e0 = tid; e0 < tv * C; e0 += UQ * NTA) {
    float xv[UQ];
#pragma unroll
    for (int u = 0; u < UQ; ++u) {
      const int e = e0 + u * NTA;
      xv[u] = e < tv * C ? to_f<T>(x[pix[e / C] * C + e % C]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UQ; ++u) {
      const int e = e0 + u * NTA, t = e / C, c = e % C;
      if (e >= tv * C) break;
      float v = xv[u];
      if (sca) {
        const int bi = (win0 + t / L) / img_wins;
        const float* p = Pt + t * NPAT;
        float sa = Sw[18 * C + c], sm2 = Sw[19 * C + c];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          sa = fmaf(p[i], Sw[i * C + c], sa);
          sm2 = fmaf(p[9 + i], Sw[(9 + i) * C + c], sm2);
        }
        const float s1 = bi == bi0 ? Sw[20 * C + c] : to_f<T>(((const T*)a.s1)[(long long)bi * C + c]);
        const float s2 = bi == bi0 ? Sw[21 * C + c] : to_f<T>(((const T*)a.s2)[(long long)bi * C + c]);
        v += (leaky_f(sa, 0.2f) * s1 + leaky_f(sm2, 0.2f) * s2) * 0.5f;
      }
      Qt[c * LDP + t] = from_f<T>(v);
    }
  }

  // k = qkv @ [w1; w2] + bb
  const T* bb = (const T*)a.bb;
  block_gemm(Qt, C, (const T*)a.wkv, half, stage, [&](int p, int n, float v) {
    Kt[n * LDP + p] = from_f<T>(v + to_f<T>(bb[n]));
  });

  // The attention, 4 consecutive tokens (of one window: L % 4 == 0) a
  // thread: one 4-token load and one broadcast value feed 4 FMAs.
  // Channel branch: St[j][t] = (v_t . k_j) / L over the token's window,
  // then out_c[t] = sum_j St[j][t] q_j.
  const float inv_l = 1.0f / (float)L;
  for (int e = tid; e < L * (TOK / 4); e += NTA) {
    const int j = e / (TOK / 4), t0 = 4 * (e % (TOK / 4));
    if (t0 >= tv) continue;
    const T* v = Qt + half * LDP + t0;
    const T* k = Kt + t0 / L * L + j;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < half; ++c) {
      const float4 vc = load4(v + c * LDP);
      const float kc = to_f<T>(k[c * LDP]);
      s = make_float4(fmaf(vc.x, kc, s.x), fmaf(vc.y, kc, s.y), fmaf(vc.z, kc, s.z),
                      fmaf(vc.w, kc, s.w));
    }
    *reinterpret_cast<float4*>(St + j * TOK + t0) =
        make_float4(rnd<T>(s.x * inv_l), rnd<T>(s.y * inv_l), rnd<T>(s.z * inv_l),
                    rnd<T>(s.w * inv_l));
  }
  __syncthreads();
  for (int e = tid; e < half * (TOK / 4); e += NTA) {
    const int c = e / (TOK / 4), t0 = 4 * (e % (TOK / 4));
    if (t0 >= tv) continue;
    const T* q = Qt + c * LDP + t0 / L * L;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < L; ++j) {
      const float4 a = load4(St + j * TOK + t0);
      const float qj = to_f<T>(q[j]);
      s = make_float4(fmaf(a.x, qj, s.x), fmaf(a.y, qj, s.y), fmaf(a.z, qj, s.z),
                      fmaf(a.w, qj, s.w));
    }
    T* o = Ot + (half + c) * LDP + t0;
    o[0] = from_f<T>(s.x);
    o[1] = from_f<T>(s.y);
    o[2] = from_f<T>(s.z);
    o[3] = from_f<T>(s.w);
  }
  // Spatial branch, head by head: KP = pw k + pb, VP = pw v + pb, with pw k
  // rounded to the storage type as pmat @ k is; k and v are not read
  // unrounded past this point, so pw k and pw v replace them in place.
  // S = q KP^T / d + bias, out_s = S VP.
  const float pw = to_f<T>(((const T*)a.pmat)[0]), pb = *a.pb;
  for (int e = tid; e < 2 * half * TOK; e += NTA) {
    const int r = e % (half * TOK);
    T* kv = (e < half * TOK ? Kt : Qt + half * LDP) + r / TOK * LDP + r % TOK;
    *kv = from_f<T>(pw * to_f<T>(*kv));
  }
  const float inv_d = 1.0f / (float)d;
  const T* bias = (const T*)a.bias;       // (L, heads * L)
  for (int hd = 0; hd < a.heads; ++hd) {
    __syncthreads();   // KP and VP are in place / the previous readers of St are done
    for (int e = tid; e < L * (TOK / 4); e += NTA) {
      const int j = e / (TOK / 4), t0 = 4 * (e % (TOK / 4));
      if (t0 >= tv) continue;
      const T* q = Qt + t0;
      const T* kp = Kt + t0 / L * L + j;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int c = hd * d; c < (hd + 1) * d; ++c) {
        const float4 qc = load4(q + c * LDP);
        const float kc = to_f<T>(kp[c * LDP]) + pb;
        s = make_float4(fmaf(qc.x, kc, s.x), fmaf(qc.y, kc, s.y), fmaf(qc.z, kc, s.z),
                        fmaf(qc.w, kc, s.w));
      }
      const T* b = bias + (long long)(t0 % L) * a.heads * L + hd * L + j;
      const long long bs = (long long)a.heads * L;   // bias rows of the 4 tokens
      *reinterpret_cast<float4*>(St + j * TOK + t0) =
          make_float4(s.x * inv_d + to_f<T>(b[0]), s.y * inv_d + to_f<T>(b[bs]),
                      s.z * inv_d + to_f<T>(b[2 * bs]), s.w * inv_d + to_f<T>(b[3 * bs]));
    }
    __syncthreads();
    for (int e = tid; e < d * (TOK / 4); e += NTA) {
      const int c = hd * d + e / (TOK / 4), t0 = 4 * (e % (TOK / 4));
      if (t0 >= tv) continue;
      const T* vp = Qt + (half + c) * LDP + t0 / L * L;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < L; ++j) {
        const float4 sj = load4(St + j * TOK + t0);
        const float vj = to_f<T>(vp[j]) + pb;
        s = make_float4(fmaf(sj.x, vj, s.x), fmaf(sj.y, vj, s.y), fmaf(sj.z, vj, s.z),
                        fmaf(sj.w, vj, s.w));
      }
      T* o = Ot + c * LDP + t0;
      o[0] = from_f<T>(s.x);
      o[1] = from_f<T>(s.y);
      o[2] = from_f<T>(s.z);
      o[3] = from_f<T>(s.w);
    }
  }

  // attn = [out_s | out_c] @ proj + projb over qkv in Qt: the attention
  // map of these tokens, in shared memory only
  const T* projb = (const T*)a.projb;
  block_gemm(Ot, C, (const T*)a.proj, C, stage, [&](int p, int n, float v) {
    Qt[n * LDP + p] = from_f<T>(v + to_f<T>(projb[n]));
  });

  // x2 = x + LN1(attn): a warp a token, into device memory and into Ot as
  // fc1's operand (Ot's rows past C are still zero)
  const T* ln1s = (const T*)a.ln1s;
  const T* ln1b = (const T*)a.ln1b;
  T* x2 = (T*)a.x2;
  for (int t = warp; t < tv; t += NWA) {
    constexpr int CPL = MAX_C / 32;
    float av[CPL], s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      av[i] = c < C ? to_f<T>(Qt[c * LDP + t]) : 0.0f;
      s1 += av[i];
      s2 += av[i] * av[i];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mean = s1 / (float)C;
    const float rstd = rsqrtf(fmaxf(s2 / (float)C - mean * mean, 0.0f) + 1e-5f);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c >= C) continue;
      const float ln = rnd<T>((av[i] - mean) * rstd * to_f<T>(ln1s[c]) + to_f<T>(ln1b[c]));
      const T v = from_f<T>(to_f<T>(x[pix[t] * C + c]) + ln);
      x2[pix[t] * C + c] = v;
      Ot[c * LDP + t] = v;
    }
  }

  // h = gelu(x2 @ W1 + b1)
  const T* b1 = (const T*)a.b1;
  T* hbuf = (T*)a.hbuf;
  block_gemm(Ot, C, (const T*)a.w1, a.Ch, stage, [&](int p, int n, float v) {
    if (p < tv)
      hbuf[pix[p] * a.Ch + n] =
          from_f<T>(gelu_f(v + to_f<T>(b1[n])));
  });
}

// launch B: the tail stage, with the residual read from x2
__global__ void __launch_bounds__(NT, 2)
htb_fused_tail_f32(const float* __restrict__ x2, const float* __restrict__ hbuf,
                   const float* __restrict__ dw, const float* __restrict__ dwb,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                   float* __restrict__ out, float* __restrict__ cmean, float* __restrict__ cmax,
                   float* __restrict__ psum, float* __restrict__ pmax, int H, int W, int C,
                   int Ch) {
  extern __shared__ __align__(16) float sm[];
  f32k::tail_out(sm, nullptr, 0, 0, nullptr, nullptr, nullptr, x2, hbuf, dw, dwb, w2, b2, ln2s,
                 ln2b, out, cmean, cmax, psum, pmax, H, W, C, Ch);
}

__global__ void __launch_bounds__(NT, 2)
htb_fused_tail_bf16(const bf16* __restrict__ x2, const bf16* __restrict__ hbuf,
                    const bf16* __restrict__ dw, const bf16* __restrict__ dwb,
                    const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                    const bf16* __restrict__ ln2s, const bf16* __restrict__ ln2b,
                    bf16* __restrict__ out, float* __restrict__ cmean, float* __restrict__ cmax,
                    float* __restrict__ psum, float* __restrict__ pmax, int H, int W, int C,
                    int Ch) {
  extern __shared__ __align__(128) unsigned char smem[];
  tck::tail_out(smem, nullptr, 0, 0, nullptr, nullptr, nullptr, x2, hbuf, dw, dwb, w2, b2, ln2s,
                ln2b, out, cmean, cmax, psum, pmax, H, W, C, Ch);
}

template <typename T>
int launch(const FArgs& a, const void* const* tw, void* out, float* const* st, cudaStream_t s) {
  constexpr bool is_bf16 = std::is_same<T, bf16>::value;
  Geo g;
  g.L = a.wh * a.ww;
  g.half = a.C / 2;
  g.d = g.half / a.heads;
  g.nwh = a.H / a.wh;
  g.nww = a.W / a.ww;
  g.nwin = a.B * g.nwh * g.nww;
  g.nwb = TOK / g.L;
  // launch B's copies: 16-byte (float32) or 8-byte (bfloat16) aligned h and W2
  // and launch A's 4-byte copies of wkv, proj and W1
  const size_t align = is_bf16 ? 8 : 16;
  const auto al4 = [](const void* p) { return (uintptr_t)p % 4 == 0; };
  if (g.L > TOK || g.L % 4 || a.C > KMAX || g.half > HMAX || a.C % 4 || a.Ch % 4 ||
      (uintptr_t)a.hbuf % align || (uintptr_t)tw[2] % align || !al4(a.wkv) ||
      !al4(a.proj) || !al4(a.w1))
    return -1;
  const size_t sa = smem_a<T>(), sb = is_bf16 ? tck::SMEM2 : f32k::SMEM2;
  const int refused = is_bf16 ? set_smem(htb_fused_tail_bf16, sb) : set_smem(htb_fused_tail_f32, sb);
  if (set_smem(htb_fused_attn_fc1<T>, sa) || refused) return -1;
  // the window blocks on gridDim.x (up to 2^31 - 1)
  const unsigned nblk = (unsigned)((g.nwin + g.nwb - 1) / g.nwb);
  htb_fused_attn_fc1<T><<<nblk, NTA, sa, s>>>(a, g);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, a.B);
  const T* const* w = (const T* const*)tw;   // dw, dwb, w2, b2, ln2s, ln2b
  if constexpr (is_bf16)
    htb_fused_tail_bf16<<<grid, NT, sb, s>>>((const bf16*)a.x2, (const bf16*)a.hbuf, w[0], w[1],
                                             w[2], w[3], w[4], w[5], (bf16*)out, st[0], st[1],
                                             st[2], st[3], a.H, a.W, a.C, a.Ch);
  else
    htb_fused_tail_f32<<<grid, NT, sb, s>>>((const float*)a.x2, (const float*)a.hbuf, w[0], w[1],
                                            w[2], w[3], w[4], w[5], (float*)out, st[0], st[1],
                                            st[2], st[3], a.H, a.W, a.C, a.Ch);
  return (int)cudaGetLastError();
}

// ---- bfloat16 at the model's shapes: wgmma ---------------------------------

namespace fwg {

using wgs::Args;
using wgs::Dims;
using wgs::Meta;
using wgs::Tile;

constexpr int KB = wgt::KC / 64;                 // W1's 64-deep K blocks
constexpr int W1C_B = 2 * wgt::NH * 64 * 2;     // one, SW(368, 64): 47,104 bytes
constexpr int XR_B = wgs::TT * wgs::CC * 2;     // the tile's x rows: x2's residual
constexpr int U_ATT = wgs::KPVP_B + wgs::QT_B + wgs::VT_B + wgs::KT_B;
// the regions the attention's window loop frees: bias, pool, gram, Ball
template <int LB>
__host__ __device__ constexpr int free_b() {
  return wgs::bias_b(LB) + wgs::PM_B + wgs::G_B + wgs::xs_ball_b(LB);
}
// W1's K blocks that land there beside the x rows and the LN1 and fc1
// parameters while the projection runs; the others land over U after it
template <int LB>
__host__ __device__ constexpr int nf() {
  return (free_b<LB>() - XR_B - wgt::PAR1_B) / W1C_B;
}
// U: the attention's [w1; w2], KP, VP, q^T, v^T, k^T and the projection;
// then W1's other K blocks and the x2 tile (fc1's A, SW(64, 192))
template <int LB>
__host__ __device__ constexpr int u_b() {
  return U_ATT > (KB - nf<LB>()) * W1C_B + wgt::X_B ? U_ATT : (KB - nf<LB>()) * W1C_B + wgt::X_B;
}
template <int LB>
__host__ __device__ constexpr int smem() {
  return wgs::XA_B + free_b<LB>() + wgs::META_B + u_b<LB>() + 1024;
}
static_assert(nf<16>() == 1 && nf<64>() == 2 && smem<16>() <= 232448 && smem<64>() <= 232448 &&
                  wgs::TT * wgt::CH * 2 <= W1C_B,
              "launch A's shared memory");

// Launch A: the 64-token tile blockIdx.x.  Shared memory (every region
// 1024-byte aligned): Xa | bias | pool | G | Ball | meta | U, the
// attention's regions as scc_fused_wg's with meta before U, so that U and
// what follows it lie in a row for the K blocks of W1 that land after the
// projection.  Block 0 also sets the statistics' maxima to -inf.
template <int LB>
__global__ void __launch_bounds__(wgs::NTW, 1) htb_fused_wg(Args a, Dims D, wgt::Tail t) {
  constexpr int NF = nf<LB>();
  extern __shared__ unsigned char smem_raw[];
  Tile r;
  r.Xa = wgs::align1k(smem_raw);
  r.Bs = r.Xa + wgs::XA_B;
  r.Pm = r.Bs + wgs::bias_b(LB);
  r.Gi = r.Pm + wgs::PM_B;
  r.Ba = r.Gi + wgs::G_B;
  r.meta = (Meta*)(r.Ba + wgs::xs_ball_b(LB));
  r.U = r.Ba + wgs::xs_ball_b(LB) + wgs::META_B;
  r.Qt = r.U + wgs::KPVP_B;
  r.Vt = r.Qt + wgs::QT_B;
  r.Kt = r.Vt + wgs::VT_B;
  unsigned char* xr = r.Bs + NF * W1C_B;          // the x rows, after W1's first blocks
  bf16* par = (bf16*)(xr + XR_B);                 // ln1 scale, ln1 bias, b1
  unsigned char* x2t = r.U + (KB - NF) * W1C_B;   // x2, fc1's A
  const int g = threadIdx.x >> 7;
  if (t.smax != nullptr && blockIdx.x == 0) {
    for (int e = threadIdx.x; e < t.B * wgt::CC; e += wgs::NTW) t.smax[e] = -CUDART_INF_F;
  }
  wgs::attend_tile<LB>(a, D, r);
  // the projection's weights over U; the x rows and the parameters over
  // the window loop's regions
  wgs::stage_packed(r.U, a.projp, wgs::NPROJ, wgs::KX);
  cp_async_commit();
  wgs::issue_rows(a, r.meta, xr);
  wgt::issue_par1(t, par);
  cp_async_commit();
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();
  // W1's first blocks behind them, then attn = [out_s | out_c] @ proj +
  // proj_b, 180 bfloat16 a token over Xa; then W1's other blocks over the
  // projection's weights
  wgt::stage_w1(r.Bs, t.w1p, 0, NF);
  cp_async_commit();
  wgs::proj_rows(a, r.Xa, wgs::saddr(r.U));
  wgt::stage_w1(r.U, t.w1p, NF, KB);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();
  // x2 = x + LN1(attn): to device memory and into x2t
  const long long* pix = r.meta->pix;
  wgt::build_x((const bf16*)r.Xa, (const bf16*)xr, [&](int p) { return pix[p] >= 0; },
               [&](int p) { return pix[p] < 0 ? -1LL : pix[p] * wgt::CC; }, par, x2t, t.xbuf);
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();
  // h = gelu(x2 W1 + b1): the first blocks' slices while the others land
  uint32_t w1[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k)
    w1[k] = k < NF ? wgs::saddr(r.Bs) + k * W1C_B : wgs::saddr(r.U) + (k - NF) * W1C_B;
  float acc[wgt::NH / 2];
#pragma unroll
  for (int i = 0; i < wgt::NH / 2; ++i) acc[i] = 0.0f;
  wgmma_fence();
  wgt::fc1_product<0, 4 * NF>(acc, wgs::saddr(x2t), w1);
  wgmma_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  wgmma_fence();
  wgt::fc1_product<4 * NF, 4 * KB>(acc, wgs::saddr(x2t), w1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < wgt::NH / 2; ++i) fence_operand(acc[i]);
  // The epilogue in loops, not unrolled over the accumulators as
  // htb_tail_fc1_wg's: this kernel runs its straight-line code once a
  // block, past what the instruction cache holds, and the unrolled gelu
  // (51 KB of instructions) took ~19k cycles a tile here against ~8k in
  // fc1_wg's loop over tiles (H100 SXM, clock64 phase marks).  The product
  // rounded (u) into hs, a row of 360 a token, over W1's first block once
  // both products have read it; then h = gelu_h(u, b1) a channel pair an
  // item, and out to h.
  __syncthreads();
  unsigned char* hs = r.Bs;
#pragma unroll
  for (int i = 0; i < wgt::NH / 2; i += 2) {
    const int n = wgt::acc_col(i);
    if (n < wgt::CC)
      *reinterpret_cast<__nv_bfloat162*>(hs + (wgt::acc_row(i) * wgt::CH + wgt::CC * g + n) * 2) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
  __syncthreads();
  const __nv_bfloat162* b1 = reinterpret_cast<const __nv_bfloat162*>(par + 2 * wgt::CC);
  __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(hs);
  constexpr int PAIRS = wgt::CH / 2;
  static_assert(wgs::NTW > PAIRS && wgs::NTW < 2 * PAIRS && wgs::TT * PAIRS % wgs::NTW == 0,
                "the pair index steps by NTW - PAIRS");
  int c2 = threadIdx.x % PAIRS;   // the channel pair of item e
#pragma unroll 9
  for (int e = threadIdx.x; e < wgs::TT * PAIRS; e += wgs::NTW) {
    const float2 h = wgt::gelu_h(__bfloat1622float2(hp[e]), __bfloat1622float2(b1[c2]));
    hp[e] = __floats2bfloat162_rn(h.x, h.y);
    c2 += wgs::NTW - PAIRS;
    if (c2 >= PAIRS) c2 -= PAIRS;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < wgs::TT * (wgt::CH / 4); e += wgs::NTW) {
    const int row = e / (wgt::CH / 4), c = e % (wgt::CH / 4);
    if (pix[row] >= 0)
      *reinterpret_cast<uint2*>(t.hbuf + pix[row] * wgt::CH + c * 4) =
          *reinterpret_cast<const uint2*>(hs + row * (wgt::CH * 2) + c * 8);
  }
}

// Launch B: htb_tail's wgmma tail over the map's 8 x 16 output tiles
__global__ void __launch_bounds__(wgt::NTT, 1)
    htb_fused_tail_wg(const wgt::Tail t, const __grid_constant__ wgt::TailMaps m) {
  extern __shared__ unsigned char smem_raw[];
  wgt::tail_out(t, m, smem_raw);
}

// the shapes this path takes (ops/kernels/htb_block.py::wgmma_path repeats it)
__host__ __device__ inline bool takes(int C, int heads, int Ch, int L) {
  return C == wgs::CC && heads == wgs::HEADS && Ch == wgt::CH && (L == 16 || L == 64);
}

int launch(const Args& a, wgt::Tail t, int Ch, cudaStream_t s) {
  const Dims D = scc::dims_of(a.B, a.Hp, a.Wp, a.C, a.heads, a.wh, a.ww, a.lb);
  if (!takes(a.C, a.heads, Ch, D.L) || a.lb != D.L || a.wkvp == nullptr ||
      a.projp == nullptr || t.w1p == nullptr || t.w2p == nullptr)
    return -1;
  const unsigned units = (unsigned)((D.nwin * (long long)D.L + wgs::TT - 1) / wgs::TT);
  if (D.L == 16) {
    if (set_smem(htb_fused_wg<16>, smem<16>())) return -1;
    htb_fused_wg<16><<<units, wgs::NTW, smem<16>(), s>>>(a, D, t);
  } else {
    if (set_smem(htb_fused_wg<64>, smem<64>())) return -1;
    htb_fused_wg<64><<<units, wgs::NTW, smem<64>(), s>>>(a, D, t);
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  // the tail over the whole map as one band: h and x2 of every row
  t.r0 = t.hr0 = 0;
  t.r1 = t.hr1 = t.H;
  return wgt::launch_tail(htb_fused_tail_wg, t, s);
}

}  // namespace fwg

}  // namespace

// dtype: 0 float32, 1 bfloat16.  x/out (B, H, W, C) with H % wh == W % ww
// == 0 (no window padding); the SCC arguments as scc_block_launch's
// (patches NULL: no SCA; pmat (L, L), of which the earlier kernels read
// only pmat[0] = pw; pb one float32 on the device); then the tail weights
// as htb_tail_launch's: ln1 scale and bias (C), W1 (C, Ch), b1 (Ch), dw (5,
// 5, Ch), dwb (Ch), W2 (Ch, C), b2 (C), ln2 scale and bias (C).  x2 (B, H,
// W, C) and hbuf (B, H, W, Ch) are scratch in the storage type.  With
// cmean non-NULL also cmean/cmax (B, H, W) and psum/pmax (B, nblocks, C)
// as htb_tail_launch.  wkvp (96, 192), projp (192, 192), w1p (368, 192)
// and w2p (184, 384) are the wgmma path's packed weights
// (ops/kernels/scc_block.py::pack_wkv, pack_proj, ops/kernels/ffn.py::
// pack_w1, pack_w2) or NULL; with them (bfloat16 only) wkv may be NULL and
// psum/pmax are the sums' slots and the maxima, as htb_tail_launch's.
// Returns cudaGetLastError() after the launches, or -1 for refused shapes.
extern "C" int htb_fused_launch(int dtype, const void* x, const void* patches, const void* w9a,
                                const void* b9a, const void* w9m, const void* b9m,
                                const void* s1, const void* s2, const void* wkv, const void* bb,
                                const void* pmat, const void* pb, const void* bias,
                                const void* proj, const void* projb, const void* ln1s,
                                const void* ln1b, const void* w1, const void* b1, const void* dw,
                                const void* dwb, const void* w2, const void* b2,
                                const void* ln2s, const void* ln2b, void* x2, void* hbuf,
                                void* out, void* cmean, void* cmax, void* psum, void* pmax,
                                const void* wkvp, const void* projp, const void* w1p,
                                const void* w2p, int B, int H, int W, int C, int heads, int wh,
                                int ww, int Ch, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 2 || heads <= 0 || (C / 2) % heads ||
      wh <= 0 || ww <= 0 || H % wh || W % ww || Ch <= 0)
    return -1;
  const FArgs a{x, patches, w9a, b9a, w9m, b9m, s1, s2, wkv, bb, pmat, (const float*)pb, bias,
                proj, projb, ln1s, ln1b, w1, b1, x2, hbuf, B, H, W, C, heads, wh, ww, Ch};
  const void* tw[6] = {dw, dwb, w2, b2, ln2s, ln2b};
  float* st[4] = {(float*)cmean, (float*)cmax, (float*)psum, (float*)pmax};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && wkvp != nullptr) {
    const wgs::Args wa{x,    patches, w9a,   b9a,  w9m,   b9m,     s1, s2, nullptr, bb, pmat,
                       (const float*)pb, bias, proj, projb, wkvp, projp, nullptr, B, H, W, C,
                       heads, wh, ww, wh * ww};
    const bf16* const* w = (const bf16* const*)tw;   // dw, dwb, w2, b2, ln2s, ln2b
    const wgt::Tail t{nullptr, nullptr, (const bf16*)ln1s, (const bf16*)ln1b, (const bf16*)w1p,
                      (const bf16*)b1, w[0], w[1], (const bf16*)w2p, w[3], w[4], w[5],
                      (bf16*)out, (bf16*)hbuf, (bf16*)x2, st[0], st[1], st[2], st[3], 0, 0, B,
                      H, W, 0, 0, 0, 0};
    return fwg::launch(wa, t, Ch, s);
  }
  if (dtype == 0) return launch<float>(a, tw, out, st, s);
  if (dtype == 1) return launch<bf16>(a, tw, out, st, s);
  return -1;
}
