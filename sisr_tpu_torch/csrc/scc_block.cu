// Fused SCA + SCC + projection window attention.
//
// Replaces sisr_tpu/ops/pallas/scc_block.py::_scc_block_pallas, both its
// per-window body (_make_kernel, windows larger than the base window) and
// its row-of-windows body (_make_band_kernel, windows <= base, where the
// pooling is the scalar pw*k + pb).
//
// Per window of L tokens (q = qkv[:, :C/2], v = qkv[:, C/2:], d = C/2/heads):
//   qkv = x + (leaky0.2(P9a . w9a + b9a) * s1 + leaky0.2(P9m . w9m + b9m) * s2) / 2
//   k   = qkv @ [w1; w2] + bb
//   G   = q^T k / L                      (C/2 x C/2; out_c = v @ G^T)
//   KP  = pmat @ k + pb, VP = pmat @ v + pb    (l_base x C/2)
//   M   = samehead(KP^T VP) / d          (C/2 x C/2)
//   out_s = q @ M + bias @ V_big         (linear attention, reassociated)
//   out = [out_s | out_c] @ proj + proj_b
//
// Bound on the H100: ~93 k multiply-adds per token (the k synthesis, the
// gram, the pooling, out_c, the spatial branch and the projection) against
// x read and out written once, 720 bytes a token in bfloat16: at a 192x192
// tile 6.9 GFLOP (7.0 us on the bf16 tensor cores) against 27 MB (7.9 us),
// so the op sits on the ridge, and what costs time is everything that is
// neither: per-window staging, scratch in device memory, launches.
//
// bfloat16 at the model's shapes (C = 180, 6 heads, l_base 16 or 64; wgs
// below): every product on wgmma, qkv rounded to bfloat16 where both
// references round it, the operands in K-major 128-byte-swizzled tiles with
// the channels of each half in 96 head-padded slots (one 16-deep slice a
// head), weights packed once per weight tensor by the wrapper:
//  - windows of 16 and 64 tokens (4x4, 8x8): one launch, scc_fused_wg, a
//    block a 64-token tile (four 4x4 windows or one 8x8).  x is read once
//    and out written once; qkv, k, the gram, KP, VP, M and [out_s | out_c]
//    never leave shared memory.  The four windows of a 4x4 tile share the
//    products of the tile (k, KP and VP through a block-diagonal pooling
//    tile, the projection) and take their per-window products in turn,
//    each warp keeping the rows of its window;
//  - windows of 256 tokens and more (16x16 .. 64x64): scc_reduce_wg per
//    (window, 256-token split) sums the gram, KP and VP over its tiles in
//    the wgmma accumulators; a window of one split (16x16) finishes its
//    operands there, others write float32 partials that scc_finish_wg
//    totals (one launch for the totals and M); scc_apply_wg per (window,
//    64-token tile) recomputes qkv from x, computes out_s | out_c and runs
//    the projection in its epilogue.  Only the windows' operands (60 KB a
//    window) and the partials (86 KB a split) reach device memory, no qkv.
//  The spatial branch is float32 in the plain version (the float32 pb
//  promotes it), so M and VP_big enter their products as hi + lo bfloat16
//  pairs into the same float32 accumulators.  One 16-slot product a head
//  keeps M's and VP_big's head mask out of the arithmetic.
//
// float32, and bfloat16 at other shapes: the earlier kernels, with up to six
// launches and float32 scratch:
//   Q  (64 pixels): qkv = x + SCA(x) into float32 scratch (qkv = x
//      without SCA), read by A1 and B;
//   A1 (window, 128-token split): k for 32-token chunks of qkv in shared
//      memory; G, KP, VP partial sums stay on chip and are written once per
//      block.  In bfloat16 its three products (k, the gram, the pooling)
//      run on the tensor cores (scc_a1_bf16);
//   A2 (elementwise, windows of several splits only): sums the partials
//      into G / L, KP + pb, VP + pb; M (window): forms M's same-head blocks;
//   B  (window, 32-token tile): out_s and out_c in float32 on the FP32
//      pipes, with M, G, VP and the tile's bias rows in shared memory and 4
//      tokens x 3 channels of each in registers; writes [out_s | out_c]
//      into out, rounded to the storage type where the plain version
//      rounds it, before the projection;
//   P  (rows of out): out = out @ proj + proj_b in place, on the tensor
//      cores in bfloat16 (scc_proj_bf16).
// The SCA patches (channel mean/max maps) and s1/s2 are built by the
// caller, as in JAX.
#include "scc_wg.cuh"

#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;
using namespace scc;

constexpr int NT = 256;
constexpr int TC = 32;      // tokens per chunk in A1 and per tile in B
constexpr int SCA_ROWS = 22;  // w9a (9 rows), w9m (9), b9a, b9m, s1, s2: rows of C
constexpr int LDT = TC + 4;   // token stride of the channel-major tiles in B and P

// n rounded up to whole float4s, so that every shared region stays 16-byte aligned
__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// Per window, A1's partial sums and their totals are laid out [G | KP |
// VP] (part_floats).  A total as B and M read it: G / L, KP + pb, VP + pb.
__device__ __forceinline__ float finish_sum(const Args& a, const Dims& D, int r, float s) {
  return r < D.half * D.half ? s * (1.0f / (float)D.L) : s + *a.pb;
}

// Q: qkv = x + SCA(x) in float32 scratch, TQ pixels of one image a block,
// with the SCA weights, the image's squeeze-excite vectors and the pixels'
// patches staged in shared memory (qkv = x without SCA).  A1 and B read it.
constexpr int TQ = 64;

size_t smem_q(int C) { return sizeof(float) * ((size_t)SCA_ROWS * C + (size_t)TQ * NPAT); }

template <typename T>
__global__ void __launch_bounds__(NT) scc_qkv(Args a, float* qkv) {
  extern __shared__ __align__(16) float sm[];
  const int C = a.C, bi = blockIdx.y;
  float* S = sm;                        // SCA_ROWS x C
  float* Pt = sm + SCA_ROWS * C;        // TQ x NPAT
  const long long hw = (long long)a.Hp * a.Wp;
  const long long p0 = (long long)blockIdx.x * TQ;
  const int np = (int)min((long long)TQ, hw - p0);
  const T* img = (const T*)a.x + (long long)bi * hw * C;
  float* out = qkv + (long long)bi * hw * C;
  if (a.patches == nullptr) {
    for (int e = threadIdx.x; e < np * C; e += NT) out[p0 * C + e] = to_f<T>(img[p0 * C + e]);
    return;
  }
  const T* pat = (const T*)a.patches + ((long long)bi * hw + p0) * NPAT;
  for (int e = threadIdx.x; e < SCA_ROWS * C; e += NT) {
    const int r = e / C, c = e % C;
    const T* src = r < 9 ? (const T*)a.w9a + r * C
                   : r < 18 ? (const T*)a.w9m + (r - 9) * C
                   : r == 18 ? (const T*)a.b9a
                   : r == 19 ? (const T*)a.b9m
                   : r == 20 ? (const T*)a.s1 + (long long)bi * C
                             : (const T*)a.s2 + (long long)bi * C;
    S[e] = to_f<T>(src[c]);
  }
  for (int e = threadIdx.x; e < np * NPAT; e += NT) Pt[e] = to_f<T>(pat[e]);
  __syncthreads();
  for (int e = threadIdx.x; e < np * C; e += NT) {
    const int t = e / C, c = e % C;
    const float* p = Pt + t * NPAT;
    float sa = S[18 * C + c], sm2 = S[19 * C + c];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      sa = fmaf(p[i], S[i * C + c], sa);
      sm2 = fmaf(p[9 + i], S[(9 + i) * C + c], sm2);
    }
    const long long q = (p0 + t) * C + c;
    out[q] = (leaky_f(sa, 0.2f) * S[20 * C + c] + leaky_f(sm2, 0.2f) * S[21 * C + c]) * 0.5f +
             to_f<T>(img[q]);
  }
}

size_t smem_a1(int C, int lb) {
  const int half = C / 2;
  return sizeof(float) * ((size_t)up4(C * half) + (size_t)TC * C + (size_t)C * LDT +
                          (size_t)TC * half + (size_t)lb * TC);
}
size_t smem_m(int C, int lb) { return sizeof(float) * 2 * (size_t)lb * (C / 2); }

// A1 in float32: per (split, window) partial sums of G, KP, VP on the FP32
// pipes.  Warp w and lane l own rows w + 8i of G (i < 12) and of KP and VP
// (i < 8), columns l, l+32, l+64, in registers across the block's chunks;
// per chunk, k = qkv @ [w1; w2] + bb is a 4-token x 3-column register tile
// a thread, with [w1; w2] staged once a block.  A window of one split
// writes its totals (finish_sum) at once.  Needs C/2 <= 96, l_base <= 64.
constexpr int GR = 12, PR = 8;   // rows of G and of KP/VP a warp owns
static_assert(NT / 32 * GR >= 96 && NT / 32 * PR >= 64, "rows of G, KP and VP");

template <typename T>
__global__ void __launch_bounds__(NT) scc_a1(Args a, Dims D, const float* qkv, float* part) {
  extern __shared__ __align__(16) float sm[];
  const int C = a.C, half = D.half, lb = a.lb, L = D.L;
  float* Ws = sm;                 // C x half: [w1; w2]
  float* Q = Ws + up4(C * half);  // TC x C: qkv of the chunk
  float* Qt = Q + TC * C;         // C x LDT: the same, channel-major
  float* Kc = Qt + C * LDT;       // TC x half: k of the chunk
  float* Pc = Kc + TC * half;     // lb x TC: pmat columns of the chunk
  const int win = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const T* wkv = (const T*)a.wkv;
  const T* pmat = (const T*)a.pmat;

  for (int e = tid; e < C * half; e += NT) Ws[e] = to_f<T>(wkv[e]);
  int cl[3];         // the lane's columns, clamped for the loads
  float bbv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    cl[j] = min(lane + 32 * j, half - 1);
    bbv[j] = to_f<T>(((const T*)a.bb)[cl[j]]);
  }
  float g[GR][3] = {}, kp[PR][3] = {}, vp[PR][3] = {};
  const int t0 = 4 * warp;

  const int lbeg = split * TOK_A, lend = min(L, lbeg + TOK_A);
  for (int l0 = lbeg; l0 < lend; l0 += TC) {
    const int nt = min(TC, lend - l0);
    __syncthreads();  // Ws is staged / the previous chunk's readers are done
    for (int e = tid; e < lb * TC; e += NT) {
      const int j = e / TC, t = e % TC;
      Pc[e] = t < nt ? to_f<T>(pmat[(long long)j * L + l0 + t]) : 0.0f;
    }
    for (int e = tid; e < TC * C; e += NT) {
      const int t = e / C, c = e % C;
      const float v = t < nt ? qkv[pixel_of(a, D, win, l0 + t) * C + c] : 0.0f;
      Q[e] = v;
      Qt[c * LDT + t] = v;
    }
    __syncthreads();
    // k of tokens t0 .. t0 + 3, the lane's columns
    float k4[4][3];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) k4[i][j] = bbv[j];
    for (int c = 0; c < C; ++c) {
      const float4 q = *reinterpret_cast<const float4*>(Qt + c * LDT + t0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float w = Ws[c * half + cl[j]];
        k4[0][j] = fmaf(q.x, w, k4[0][j]);
        k4[1][j] = fmaf(q.y, w, k4[1][j]);
        k4[2][j] = fmaf(q.z, w, k4[2][j]);
        k4[3][j] = fmaf(q.w, w, k4[3][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (lane + 32 * j < half) Kc[(t0 + i) * half + cl[j]] = k4[i][j];
    __syncthreads();
    // G += k^T q, KP += pmat k, VP += pmat v over the chunk's tokens
    for (int t = 0; t < nt; ++t) {
      float qv[3], kv[3], vv[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        qv[j] = Q[t * C + cl[j]];
        kv[j] = Kc[t * half + cl[j]];
        vv[j] = Q[t * C + half + cl[j]];
      }
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        const float kd = Kc[t * half + min(warp + 8 * i, half - 1)];
#pragma unroll
        for (int j = 0; j < 3; ++j) g[i][j] = fmaf(kd, qv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const float p = Pc[min(warp + 8 * i, lb - 1) * TC + t];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          kp[i][j] = fmaf(p, kv[j], kp[i][j]);
          vp[i][j] = fmaf(p, vv[j], vp[i][j]);
        }
      }
    }
  }
  float* dst = part + ((long long)win * D.nsplit + split) * D.part_floats;
  const auto put = [&](int r, float v) { dst[r] = D.nsplit == 1 ? finish_sum(a, D, r, v) : v; };
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = lane + 32 * j;
    if (c >= half) continue;
#pragma unroll
    for (int i = 0; i < GR; ++i)
      if (warp + 8 * i < half) put((warp + 8 * i) * half + c, g[i][j]);
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      const int r = warp + 8 * i;
      if (r >= lb) continue;
      put(half * half + r * half + c, kp[i][j]);
      put(half * half + lb * half + r * half + c, vp[i][j]);
    }
  }
}

// ---- bfloat16: A1 on the tensor cores -------------------------------------
// The same sums as scc_a1, every product a wmma 16x16x16 with
// float32 accumulators; qkv and k are bfloat16 as the products' inputs, as
// in the plain version.  16 warps share the 84 accumulator fragments of G,
// KP and VP, so that each keeps 6 at most under 128 registers.  Shapes:
// C/2 <= 96, l_base <= 64.

namespace tca {

constexpr int HP = 96;                 // C/2 padded to whole fragments
constexpr int KS = 2 * HP;             // qkv in split layout [q | 0 | v | 0]
constexpr int LBM = 64;                // l_base padded
constexpr int NTA = 512;               // threads of an A1 block
constexpr int NWARP = NTA / 32;
// row strides, padded so that the rows of a fragment start on different banks
constexpr int LDQ = KS + 8, LDW = HP + 8, LDK = HP + 8, LDF = HP + 4, LDPA = TC + 8;
constexpr int NK = (TC / 16) * (HP / 16);          // k fragments per chunk: 12
constexpr int NG = (HP / 16) * (HP / 16);          // G fragments: 36
constexpr int GPW = (NG + NWARP - 1) / NWARP;      // G fragments a warp keeps: 3
constexpr int PPW = 2 * (LBM / 16) * (HP / 16) / NWARP;   // KP and VP: 3
constexpr size_t W_B = sizeof(bf16) * KS * LDW;    // [w1; 0; w2; 0]
constexpr size_t Q_B = sizeof(bf16) * TC * LDQ;    // qkv of the chunk
constexpr size_t KF_B = sizeof(float) * TC * LDF;  // k before its bias
constexpr size_t KA_B = sizeof(bf16) * TC * LDK;   // k
constexpr size_t PA_B = sizeof(bf16) * LBM * LDPA; // pmat columns of the chunk
constexpr size_t LOOP_B = W_B + Q_B + KF_B + KA_B + PA_B;
constexpr size_t STAGE_B = sizeof(float) * (HP + 2 * LBM) * LDF;   // G, KP, VP
constexpr size_t SMEM = LOOP_B > STAGE_B ? LOOP_B : STAGE_B;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__global__ void __launch_bounds__(NTA) scc_a1_bf16(Args a, Dims D, const float* qkv,
                                                    float* part) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = (bf16*)smem;
  bf16* Qa = (bf16*)(smem + W_B);
  float* Kf = (float*)(smem + W_B + Q_B);
  bf16* Ka = (bf16*)(smem + W_B + Q_B + KF_B);
  bf16* Pa = (bf16*)(smem + W_B + Q_B + KF_B + KA_B);
  float* Gs = (float*)smem;            // after the loop: HP x LDF
  float* KPs = Gs + HP * LDF;          // LBM x LDF
  float* VPs = KPs + LBM * LDF;        // LBM x LDF

  const int half = D.half, lb = a.lb, L = D.L, C = a.C;
  const int win = blockIdx.x, split = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  const bf16* wkv = (const bf16*)a.wkv;
  const bf16* bb = (const bf16*)a.bb;
  const bf16* pmat = (const bf16*)a.pmat;
  const bf16 zero = __float2bfloat16(0.0f);
  const int npb = ((lb + 15) / 16) * (HP / 16);    // KP fragments in use (as many VP)

  // wkv rows [0, half) act on q, [half, C) on v: placed at [0, HP), [HP, KS)
  for (int e = tid; e < KS * HP; e += NTA) {
    const int r = e / HP, n = e % HP, c = r < HP ? r : r - HP;
    Ws[r * LDW + n] = (c < half && n < half) ? wkv[(r < HP ? c : half + c) * half + n] : zero;
  }

  FragC accG[GPW], accP[PPW];
#pragma unroll
  for (int i = 0; i < GPW; ++i) wmma::fill_fragment(accG[i], 0.0f);
#pragma unroll
  for (int i = 0; i < PPW; ++i) wmma::fill_fragment(accP[i], 0.0f);

  const int lbeg = split * TOK_A, lend = min(L, lbeg + TOK_A);
  for (int l0 = lbeg; l0 < lend; l0 += TC) {
    const int nt = min(TC, lend - l0);
    __syncthreads();  // Ws is written / the previous chunk's readers are done
    for (int e = tid; e < TC * KS; e += NTA) {
      const int t = e / KS, r = e % KS, c = r < HP ? r : r - HP;
      Qa[t * LDQ + r] =
          (t < nt && c < half)
              ? __float2bfloat16(qkv[pixel_of(a, D, win, l0 + t) * C + (r < HP ? c : half + c)])
              : zero;
    }
    for (int e = tid; e < LBM * TC; e += NTA) {
      const int j = e / TC, t = e % TC;
      Pa[j * LDPA + t] = (j < lb && t < nt) ? pmat[(long long)j * L + l0 + t] : zero;
    }
    __syncthreads();

    // k = qkv @ [w1; w2]
    for (int f = warp; f < NK; f += NWARP) {
      const int mt = f / (HP / 16), n = f % (HP / 16);
      FragC acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
      for (int k = 0; k < KS; k += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, Qa + mt * 16 * LDQ + k, LDQ);
        wmma::load_matrix_sync(fb, Ws + k * LDW + n * 16, LDW);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Kf + mt * 16 * LDF + n * 16, acc, LDF, wmma::mem_row_major);
    }
    __syncthreads();
    // + bb; zero past the chunk and in the padded channels
    for (int e = tid; e < TC * HP; e += NTA) {
      const int t = e / HP, n = e % HP;
      Ka[t * LDK + n] = (t < nt && n < half)
                            ? __float2bfloat16(Kf[t * LDF + n] + to_f<bf16>(bb[n])) : zero;
    }
    __syncthreads();

    // G += k^T q (k read column-major as k^T)
#pragma unroll
    for (int i = 0; i < GPW; ++i) {
      const int f = warp + i * NWARP;
      if (f < NG) {
        const int mt = f / (HP / 16), n = f % (HP / 16);
#pragma unroll
        for (int k = 0; k < TC; k += 16) {
          FragAT fa;
          FragB fb;
          wmma::load_matrix_sync(fa, Ka + mt * 16 + k * LDK, LDK);
          wmma::load_matrix_sync(fb, Qa + k * LDQ + n * 16, LDQ);
          wmma::mma_sync(accG[i], fa, fb, accG[i]);
        }
      }
    }
    // KP += pmat k, VP += pmat v
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      const int f = warp + i * NWARP;
      if (f < 2 * npb) {
        const int r = f % npb, mt = r / (HP / 16), n = r % (HP / 16);
        const bf16* bsrc = f < npb ? Ka + n * 16 : Qa + HP + n * 16;
        const int ldb = f < npb ? LDK : LDQ;
#pragma unroll
        for (int k = 0; k < TC; k += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, Pa + mt * 16 * LDPA + k, LDPA);
          wmma::load_matrix_sync(fb, bsrc + k * ldb, ldb);
          wmma::mma_sync(accP[i], fa, fb, accP[i]);
        }
      }
    }
  }
  __syncthreads();  // every read of the loop's buffers is done: stage over them
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    const int f = warp + i * NWARP;
    if (f < NG)
      wmma::store_matrix_sync(Gs + (f / (HP / 16)) * 16 * LDF + (f % (HP / 16)) * 16, accG[i],
                              LDF, wmma::mem_row_major);
  }
#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    const int f = warp + i * NWARP;
    if (f < 2 * npb) {
      const int r = f % npb;
      float* dst = (f < npb ? KPs : VPs) + (r / (HP / 16)) * 16 * LDF + (r % (HP / 16)) * 16;
      wmma::store_matrix_sync(dst, accP[i], LDF, wmma::mem_row_major);
    }
  }
  __syncthreads();
  float* dst = part + ((long long)win * D.nsplit + split) * D.part_floats;
  const auto put = [&](int r, float v) { dst[r] = D.nsplit == 1 ? finish_sum(a, D, r, v) : v; };
  for (int e = tid; e < half * half; e += NTA) put(e, Gs[(e / half) * LDF + e % half]);
  for (int e = tid; e < lb * half; e += NTA) {
    const int j = e / half, c = e % half;
    put(half * half + e, KPs[j * LDF + c]);
    put(half * half + lb * half + e, VPs[j * LDF + c]);
  }
}

}  // namespace tca

// A2 (windows of several splits): the totals of every window's partials,
// one element a thread, into tot
__global__ void __launch_bounds__(NT) scc_a2(Args a, Dims D, const float* part, float* tot) {
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  if (e >= (long long)D.nwin * D.part_floats) return;
  const long long win = e / D.part_floats;
  const int r = (int)(e % D.part_floats);
  const float* src = part + win * D.nsplit * D.part_floats + r;
  float s = 0.0f;
  for (int k = 0; k < D.nsplit; ++k) s += src[(long long)k * D.part_floats];
  tot[e] = finish_sum(a, D, r, s);
}

// M: per window, M's same-head blocks from the totals' KP and VP.  M is
// zero off its heads' d x d blocks: row c1 keeps only the d columns of its
// own head, M[c1][c1 / d * d + i] at c1 * d + i
__global__ void __launch_bounds__(NT) scc_m(Args a, Dims D, const float* tot, float* Mw) {
  extern __shared__ __align__(16) float sm[];
  const int half = D.half, lb = a.lb, d = D.d, win = blockIdx.x, tid = threadIdx.x;
  float* KP = sm;
  float* VP = sm + lb * half;
  const float* src = tot + (long long)win * D.part_floats + half * half;
  for (int e = tid; e < 2 * lb * half; e += NT) KP[e] = src[e];
  __syncthreads();
  const float invd = 1.0f / (float)d;
  for (int e = tid; e < half * d; e += NT) {
    const int c1 = e / d, c2 = (c1 / d) * d + e % d;
    float s = 0.0f;
    for (int j = 0; j < lb; ++j) s = fmaf(KP[j * half + c1], VP[j * half + c2], s);
    Mw[(long long)win * half * half + e] = s * invd;
  }
}

// B: per (token tile, window) [out_s | out_c] into out, over the tile's
// qkv.  Warp w takes tokens 4w..4w+3 of the tile, lane l the output
// channels l, l+32, l+64 of out_s and of out_c; q, v and the bias rows are
// kept channel-major (stride LDT) so one load reads a value of the warp's
// four tokens; q @ M runs over each channel's head only.  The bias rows stay
// in the storage type, so that the bfloat16 block fits twice on an SM.
// Needs C/2 <= 96.
template <typename T>
size_t smem_b(int C, int heads, int lb) {
  const int half = C / 2, d = half / heads;
  return sizeof(float) * ((size_t)C * LDT + up4(half * d) + up4(half * half) + up4(lb * half)) +
         sizeof(T) * (size_t)heads * lb * LDT;
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) scc_b(Args a, Dims D, const float* qkv,
                                               const float* tot, const float* Mw) {
  extern __shared__ __align__(16) float sm[];
  const int C = a.C, half = D.half, lb = a.lb, L = D.L, hl = a.heads * lb, d = D.d;
  float* Qt = sm;                                     // C x LDT: qkv, channel-major
  float* Ms = Qt + C * LDT;                           // half x d: M's same-head blocks
  float* Gs = Ms + up4(half * d);                     // half x half
  float* VPs = Gs + up4(half * half);                 // lb x half
  T* Bt = (T*)(VPs + up4(lb * half));                 // hl x LDT: bias rows, column-major
  const int win = blockIdx.x, l0 = blockIdx.y * TC, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nt = min(TC, L - l0);
  const T* bias = (const T*)a.bias;
  T* out = (T*)a.out;

  const float* M = Mw + (long long)win * half * half;
  const float* G = tot + (long long)win * D.part_floats;
  const float* VP = G + half * half + lb * half;
  for (int e = tid; e < half * d; e += NT) Ms[e] = M[e];
  for (int e = tid; e < half * half; e += NT) Gs[e] = G[e];
  for (int e = tid; e < lb * half; e += NT) VPs[e] = VP[e];
  for (int e = tid; e < TC * hl; e += NT) {
    const int t = e / hl, col = e % hl;
    Bt[col * LDT + t] = t < nt ? bias[(long long)(l0 + t) * hl + col] : from_f<T>(0.0f);
  }
  for (int e = tid; e < TC * C; e += NT) {
    const int t = e / C, c = e % C;
    Qt[c * LDT + t] = t < nt ? qkv[pixel_of(a, D, win, l0 + t) * C + c] : 0.0f;
  }
  __syncthreads();

  // the lane's channels, clamped for the loads; hd: their heads
  int cl[3], hd[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    cl[j] = min(lane + 32 * j, half - 1);
    hd[j] = cl[j] / d;
  }
  float os[4][3], oc[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) os[i][j] = oc[i][j] = 0.0f;
  const int t0 = 4 * warp;
  for (int k = 0; k < half; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(Qt + (half + k) * LDT + t0);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float g = Gs[k * half + cl[j]];
      oc[0][j] = fmaf(v.x, g, oc[0][j]);
      oc[1][j] = fmaf(v.y, g, oc[1][j]);
      oc[2][j] = fmaf(v.z, g, oc[2][j]);
      oc[3][j] = fmaf(v.w, g, oc[3][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int cj = cl[j] - hd[j] * d;  // the channel's column in its head
    for (int k = hd[j] * d; k < (hd[j] + 1) * d; ++k) {
      const float4 q = *reinterpret_cast<const float4*>(Qt + k * LDT + t0);
      const float m = Ms[k * d + cj];
      os[0][j] = fmaf(q.x, m, os[0][j]);
      os[1][j] = fmaf(q.y, m, os[1][j]);
      os[2][j] = fmaf(q.z, m, os[2][j]);
      os[3][j] = fmaf(q.w, m, os[3][j]);
    }
  }
  for (int jb = 0; jb < lb; ++jb) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float vp = VPs[jb * half + cl[j]];
      const float4 b = load4(Bt + (hd[j] * lb + jb) * LDT + t0);
      os[0][j] = fmaf(b.x, vp, os[0][j]);
      os[1][j] = fmaf(b.y, vp, os[1][j]);
      os[2][j] = fmaf(b.z, vp, os[2][j]);
      os[3][j] = fmaf(b.w, vp, os[3][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (t0 + i >= nt) continue;
    T* orow = out + pixel_of(a, D, win, l0 + t0 + i) * C;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int c = lane + 32 * j;
      if (c < half) {
        orow[c] = from_f<T>(os[i][j]);
        orow[half + c] = from_f<T>(oc[i][j]);
      }
    }
  }
}

// P on the FP32 pipes: rows [32 r, 32 r + 32) of out = out @ proj + projb,
// in place (a block reads all its rows before it writes them).  Warp w
// takes rows 4w..4w+3, lane l the columns l, l+32, ..; proj arrives in
// chunks of 32 rows.  Needs C <= 192.
template <typename T>
__global__ void __launch_bounds__(NT) scc_proj(T* out, const T* __restrict__ proj,
                                               const T* __restrict__ projb, long long npix,
                                               int C) {
  extern __shared__ __align__(16) float sm[];
  float* At = sm;                 // C x LDT: the rows, channel-major
  float* Pc = sm + C * LDT;       // TC x C: a chunk of proj
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long r0 = (long long)blockIdx.x * TC;
  for (int e = tid; e < TC * C; e += NT) {
    const int t = e / C, c = e % C;
    At[c * LDT + t] = r0 + t < npix ? to_f<T>(out[(r0 + t) * C + c]) : 0.0f;
  }
  float acc[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.0f;
  int cl[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) cl[j] = min(lane + 32 * j, C - 1);
  const int t0 = 4 * warp;
  for (int k0 = 0; k0 < C; k0 += TC) {
    const int nk = min(TC, C - k0);
    __syncthreads();  // the rows are staged / the previous chunk's readers are done
    for (int e = tid; e < nk * C; e += NT) Pc[e] = to_f<T>(proj[(long long)k0 * C + e]);
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      const float4 r = *reinterpret_cast<const float4*>(At + (k0 + k) * LDT + t0);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float p = Pc[k * C + cl[j]];
        acc[0][j] = fmaf(r.x, p, acc[0][j]);
        acc[1][j] = fmaf(r.y, p, acc[1][j]);
        acc[2][j] = fmaf(r.z, p, acc[2][j]);
        acc[3][j] = fmaf(r.w, p, acc[3][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + t0 + i;
    if (r >= npix) continue;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int c = lane + 32 * j;
      if (c < C) out[r * C + c] = from_f<T>(acc[i][j] + to_f<T>(projb[c]));
    }
  }
}

// ---- bfloat16: P on the tensor cores --------------------------------------
// A block takes 64 rows: the rows and all of proj (C padded to 192) arrive
// by cp.async, 4 x 12 output fragments (6 a warp) accumulate over 12 K
// steps, and go through shared memory for the bias.  Needs C % 4 == 0 and
// 8-byte aligned out and proj.

namespace tcp {

constexpr int KP = 192;                // C padded to the MMA depth
constexpr int BM = 64;
constexpr int LDA = KP + 8, LDB = KP + 8, LDC = KP + 4;
constexpr int MT = BM / 16, NTL = KP / 16;
constexpr int FR = MT * NTL / (NT / 32);          // fragments a warp keeps: 6
constexpr size_t A_B = sizeof(bf16) * BM * LDA;
constexpr size_t B_B = sizeof(bf16) * KP * LDB;
constexpr size_t C_B = sizeof(float) * BM * LDC;
constexpr size_t SMEM = A_B + B_B > C_B ? A_B + B_B : C_B;   // 100 KB: two blocks per SM
static_assert((NT / 32) % MT == 0, "warp split");

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__global__ void __launch_bounds__(NT, 2) scc_proj_bf16(bf16* out, const bf16* __restrict__ proj,
                                                       const bf16* __restrict__ projb,
                                                       long long npix, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = (bf16*)smem;
  bf16* Bs = (bf16*)(smem + A_B);
  float* Cs = (float*)smem;          // after the products
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * BM;
  for (int e = tid; e < BM * (KP / 4); e += NT) {
    const int r = e / (KP / 4), c = (e % (KP / 4)) * 4;
    const bool ok = r0 + r < npix && c < C;
    cp_async8(As + r * LDA + c, ok ? out + (r0 + r) * C + c : out, ok);
  }
  for (int e = tid; e < KP * (KP / 4); e += NT) {
    const int k = e / (KP / 4), c = (e % (KP / 4)) * 4;
    const bool ok = k < C && c < C;
    cp_async8(Bs + k * LDB + c, ok ? proj + (long long)k * C + c : proj, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int m = warp % MT, n0 = (warp / MT) * FR;
  FragC acc[FR];
#pragma unroll
  for (int i = 0; i < FR; ++i) wmma::fill_fragment(acc[i], 0.0f);
#pragma unroll 4
  for (int k = 0; k < KP; k += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, As + m * 16 * LDA + k, LDA);
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      FragB fb;
      wmma::load_matrix_sync(fb, Bs + k * LDB + (n0 + i) * 16, LDB);
      wmma::mma_sync(acc[i], fa, fb, acc[i]);
    }
  }
  __syncthreads();  // every product is done before Cs (over the tiles) is written
#pragma unroll
  for (int i = 0; i < FR; ++i)
    wmma::store_matrix_sync(Cs + m * 16 * LDC + (n0 + i) * 16, acc[i], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * C; e += NT) {
    const int r = e / C, c = e % C;
    if (r0 + r < npix)
      out[(r0 + r) * C + c] = __float2bfloat16(Cs[r * LDC + c] + __bfloat162float(projb[c]));
  }
}

}  // namespace tcp

// ---- bfloat16 at the model's shapes: wgmma ---------------------------------
// C = 180, 6 heads (d = 15), windows of L = 16 (l_base 16), L = 64 (l_base
// 64) or any L that is a multiple of 256 (l_base 64).  A half of the
// channels lies in 96 head-padded slots: channel c at 16 (c / 15) + c % 15,
// slot 16 h + 15 zero, so that every head is one 16-deep wgmma slice.
// Every operand is a K-major tile under the 128-byte swizzle (wgmma.cuh):
// SW(R, K) holds K / 64 blocks of R rows of 128 bytes.  The phases are in
// scc_wg.cuh (shared with htb_fused.cu); the kernels are here.

namespace wgs {

// Windows of 16 or 64 tokens, one launch: a block takes one 64-token tile
// (four 4x4 windows or one 8x8), computes qkv, k, the gram, KP, VP, M, the
// spatial and channel outputs and the projection on chip and writes out.
// Shared memory (every region 1024-byte aligned):
//   Xa | bias | pool | G (SCA weights first) | Ball (x rows first) | U | meta
// where U holds [w1; w2] (then KP, VP) and q^T, v^T, k^T, and at the end
// the projection.
template <int LB>
__global__ void __launch_bounds__(NTW, 1) scc_fused_wg(Args a, Dims D) {
  extern __shared__ unsigned char smem_raw[];
  Tile r;
  r.Xa = align1k(smem_raw);
  r.Bs = r.Xa + XA_B;
  r.Pm = r.Bs + bias_b(LB);
  r.Gi = r.Pm + PM_B;
  r.Ba = r.Gi + G_B;
  r.U = r.Ba + xs_ball_b(LB);
  r.Qt = r.U + KPVP_B;
  r.Vt = r.Qt + QT_B;
  r.Kt = r.Vt + VT_B;
  r.meta = (Meta*)(r.Kt + KT_B);
  attend_tile<LB>(a, D, r);
  stage_packed(r.U, a.projp, NPROJ, KX);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  proj_tile(a, r.Xa, saddr(r.U), r.meta);
}

// ---- windows of L >= 256 tokens: reduce, (totals), apply ---------------------
// The operands of a window (ops: the gram image, then Ball) pass through
// device memory, in the swizzled form the apply block copies as it is.

constexpr int SMEM_R = XA_B + QT_B + VT_B + KT_B + PM_B + WKV_B + SCA_B + 2 * XS_B + 2 * META_B + 1024;
constexpr int SMEM_F = P * P * 4 + KPVP_B + G_B + ball_b(64);
constexpr int SCA_R = (SCA_B + 1023) / 1024 * 1024;   // the SCA weights, then the x rows
constexpr int SMEM_A = PROJ_B + G_B + ball_b(64) + bias_b(64) + XA_B + META_B + 1024;
static_assert(SMEM_A <= 232448 && SCA_R + XS_B <= bias_b(64) && OPS_B <= XA_B + QT_B + VT_B + KT_B &&
                  KPVP_B <= WKV_B + SCA_B + XS_B,
              "split path regions");

// the window's operands from float32 totals in shared memory (G as [c][d]
// slots, KP / VP after + pb), into gimg / ball in shared memory
__device__ void finish_ops(const float* G, const float* kpvp, int L, unsigned char* gimg,
                           unsigned char* ball) {
  const float invl = 1.0f / (float)L;
  for (int e = threadIdx.x; e < P * P; e += NTW)
    put(gimg, P, e / P, e % P, rbf(G[e]) * invl);
  build_ball<64>(kpvp, kpvp + TT * P, ball);
}
__device__ __forceinline__ void store_flat(unsigned char* dst, const unsigned char* src, int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += NTW)
    reinterpret_cast<uint4*>(dst)[e] = reinterpret_cast<const uint4*>(src)[e];
}

// R: block (window, split of 256 tokens): qkv, k, and the gram, KP and VP
// summed over the split's 64-token tiles in the accumulators; a window of
// one split finishes its operands here, others write float32 partials.
__global__ void __launch_bounds__(NTW, 1) scc_reduce_wg(Args a, Dims D, unsigned char* ops,
                                                         float* part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Xa = align1k(smem_raw);
  unsigned char* Qt = Xa + XA_B;
  unsigned char* Vt = Qt + QT_B;
  unsigned char* Kt = Vt + VT_B;
  unsigned char* Pm = Kt + KT_B;
  unsigned char* Wk = Pm + PM_B;
  unsigned char* sca = Wk + WKV_B;
  unsigned char* xs = Wk + WKV_B + SCA_B;             // two buffers: the x rows of a tile
  Meta* meta = (Meta*)(xs + 2 * XS_B);                 // two: the tokens of a tile
  const int win = blockIdx.x, split = blockIdx.y, L = D.L, g = threadIdx.x >> 7;
  const int nsplit = (L + SPLIT - 1) / SPLIT;
  const int t0 = split * SPLIT, nt = (min(L, t0 + SPLIT) - t0) / TT;
  auto tokens = [&](int c) {
    tile_meta(a, [&](int t) -> long long { return pixel_of(a, D, win, t0 + c * TT + t); },
              meta + (c & 1));
  };

  stage_packed(Wk, a.wkvp, P, KX);
  tokens(0);
  __syncthreads();
  issue_x(a, meta, xs);
  issue_sca(a, meta, sca);   // one window: one image
  cp_async_commit();
  float gacc[48], pacc[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) gacc[i] = pacc[i] = 0.0f;
  // tile c's x rows arrive while tile c - 1 is computed
  for (int c = 0; c < nt; ++c) {
    stage_pool(Pm, (const bf16*)a.pmat, L, 64, t0 + c * TT);
    cp_async_commit();
    if (c + 1 < nt) tokens(c + 1);
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < nt) issue_x(a, meta + ((c + 1) & 1), xs + ((c + 1) & 1) * XS_B);
    cp_async_commit();
    qkv_tile(a, sca, meta + (c & 1), xs + (c & 1) * XS_B, Xa, Qt, Vt);
    k_tile(a, saddr(Xa), saddr(Wk), Kt);
    fence_proxy_async();
    __syncthreads();
    gram_tile(gacc, saddr(Qt), saddr(Kt), 0, TT / 16);
    pool_tile(pacc, saddr(Pm), saddr(Kt), saddr(Vt));
    __syncthreads();   // the tile's readers are done
  }
  __syncthreads();
  if (nsplit == 1) {
    // the gram image over Xa.., KP and VP over [w1; w2] and the SCA weights
    unsigned char* gimg = Xa;
    unsigned char* ball = Xa + G_B;
    float* kpvp = (float*)Wk;
    put_gram(gacc, gimg, L);
    put_pool(pacc, kpvp, *a.pb);
    __syncthreads();
    build_ball<64>(kpvp, kpvp + TT * P, ball);
    __syncthreads();
    store_flat(ops + (long long)win * OPS_B, gimg, OPS_B);
    return;
  }
  float* dst = part + ((long long)win * nsplit + split) * PART_F;
#pragma unroll
  for (int i = 0; i < 48; ++i) {
    const int r = 32 * g + acc_row(i);
    if (g == 0 ? r < 64 : r >= 64) dst[r * P + acc_col(i)] = gacc[i];
    dst[P * P + g * TT * P + acc_row(i) * P + acc_col(i)] = pacc[i];
  }
}

// F (windows of several splits): the totals of the partials, in split
// order, and the window's operands
__global__ void __launch_bounds__(NTW) scc_finish_wg(Args a, Dims D, const float* part,
                                                      unsigned char* ops) {
  extern __shared__ unsigned char smem_raw[];
  float* G = (float*)smem_raw;                      // 96 x 96
  float* kpvp = G + P * P;                          // 2 x 64 x 96
  unsigned char* gimg = (unsigned char*)(kpvp + 2 * TT * P);   // + Ball: 1024-aligned
  const int win = blockIdx.x, nsplit = (D.L + SPLIT - 1) / SPLIT;
  const float* src = part + (long long)win * nsplit * PART_F;
  const float pb = *a.pb;
  for (int e = threadIdx.x; e < PART_F; e += NTW) {
    float s = 0.0f;
    for (int k = 0; k < nsplit; ++k) s += src[(long long)k * PART_F + e];
    if (e < P * P)
      G[e] = s;
    else
      kpvp[e - P * P] = rbf(s) + pb;
  }
  __syncthreads();
  finish_ops(G, kpvp, D.L, gimg, gimg + G_B);
  __syncthreads();
  store_flat(ops + (long long)win * OPS_B, gimg, OPS_B);
}

// A: block (window, 64-token tile): qkv again from x, then out_s | out_c
// against the window's operands and the projection, written to out.
__global__ void __launch_bounds__(NTW, 1) scc_apply_wg(Args a, Dims D, const unsigned char* ops) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Pj = align1k(smem_raw);
  unsigned char* Gi = Pj + PROJ_B;
  unsigned char* Ba = Gi + G_B;
  unsigned char* Bs = Ba + ball_b(64);
  unsigned char* Xa = Bs + bias_b(64);
  Meta* meta = (Meta*)(Xa + XA_B);
  unsigned char* xs = Bs + SCA_R;    // the x rows and the SCA weights, then the bias tile
  const int win = blockIdx.x, l0 = blockIdx.y * TT;

  tile_meta(a, [&](int t) -> long long { return pixel_of(a, D, win, l0 + t); }, meta);
  __syncthreads();
  issue_x(a, meta, xs);
  issue_sca(a, meta, Bs);
  cp_async_commit();
  stage_packed(Pj, a.projp, NPROJ, KX);
  copy_flat(Gi, ops + (long long)win * OPS_B, OPS_B);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  qkv_tile(a, Bs, meta, xs, Xa, nullptr, nullptr);
  stage_bias(Bs, (const bf16*)a.bias, D.L, 64, l0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float acc[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = 0.0f;
  apply<64>(acc, saddr(Xa), saddr(Gi), saddr(Ba), saddr(Bs));
  __syncthreads();
  put_out(acc, Xa);
  fence_proxy_async();
  __syncthreads();
  proj_tile(a, Xa, saddr(Pj), meta);
}

// the shapes this path takes (ops/kernels/scc_block.py::wgmma_path repeats it)
__host__ __device__ inline bool takes(int C, int heads, int L, int lb) {
  return C == CC && heads == HEADS &&
         ((L == 16 && lb == 16) || (L == 64 && lb == 64) || (L % SPLIT == 0 && lb == 64));
}

long long scratch_bytes(const Dims& D) {
  if (D.L < SPLIT) return 0;
  const int nsplit = D.L / SPLIT;
  return (long long)D.nwin * OPS_B +
         (nsplit > 1 ? (long long)D.nwin * nsplit * PART_F * 4 : 0);
}

int launch(const Args& a, unsigned char* scratch, cudaStream_t stream) {
  const Dims D = dims_of(a.B, a.Hp, a.Wp, a.C, a.heads, a.wh, a.ww, a.lb);
  if (!takes(a.C, a.heads, D.L, a.lb) || a.wkvp == nullptr || a.projp == nullptr) return -1;
  if (D.L < SPLIT) {
    const unsigned units = (unsigned)((D.nwin * (long long)D.L + TT - 1) / TT);
    if (D.L == 16) {
      if (set_smem(scc_fused_wg<16>, smem_fused(16))) return -1;
      scc_fused_wg<16><<<units, NTW, smem_fused(16), stream>>>(a, D);
    } else {
      if (set_smem(scc_fused_wg<64>, smem_fused(64))) return -1;
      scc_fused_wg<64><<<units, NTW, smem_fused(64), stream>>>(a, D);
    }
    return (int)cudaGetLastError();
  }
  const int nsplit = D.L / SPLIT;
  unsigned char* ops = scratch;
  float* part = (float*)(scratch + (long long)D.nwin * OPS_B);
  if (set_smem(scc_reduce_wg, SMEM_R) || set_smem(scc_finish_wg, SMEM_F) ||
      set_smem(scc_apply_wg, SMEM_A))
    return -1;
  scc_reduce_wg<<<dim3(D.nwin, nsplit), NTW, SMEM_R, stream>>>(a, D, ops, part);
  if (nsplit > 1) scc_finish_wg<<<D.nwin, NTW, SMEM_F, stream>>>(a, D, part, ops);
  scc_apply_wg<<<dim3(D.nwin, D.L / TT), NTW, SMEM_A, stream>>>(a, D, ops);
  return (int)cudaGetLastError();
}

}  // namespace wgs

template <typename T>
int launch(const Args& a, float* scratch, cudaStream_t stream) {
  const Dims D = dims_of(a.B, a.Hp, a.Wp, a.C, a.heads, a.wh, a.ww, a.lb);
  constexpr bool is_bf16 = std::is_same<T, bf16>::value;
  // the register tiles of A1, B and P (and the tensor-core A1's padding)
  static_assert(tca::HP == 96 && tca::LBM == 64, "shape limits");
  if (D.half > 96 || a.C > 192 || a.lb > 64) return -1;
  // bfloat16 takes A1 on the tensor cores, and P where its copies fit
  const bool tc_p = is_bf16 && a.C % 4 == 0 && (uintptr_t)a.out % 8 == 0 &&
                    (uintptr_t)a.proj % 8 == 0;
  const size_t s0 = smem_q(a.C);
  const size_t s1 = is_bf16 ? tca::SMEM : smem_a1(a.C, a.lb);
  const size_t s2 = smem_m(a.C, a.lb), s3 = smem_b<T>(a.C, a.heads, a.lb);
  const size_t s4 = tc_p ? tcp::SMEM : sizeof(float) * ((size_t)a.C * LDT + (size_t)TC * a.C);
  int refused;
  if constexpr (is_bf16)
    refused = set_smem(tca::scc_a1_bf16, s1);
  else
    refused = set_smem(scc_a1<T>, s1);
  if (refused || set_smem(scc_qkv<T>, s0) || set_smem(scc_m, s2) || set_smem(scc_b<T>, s3) ||
      (tc_p ? set_smem(tcp::scc_proj_bf16, s4) : set_smem(scc_proj<T>, s4)))
    return -1;
  const int half = D.half;
  const long long hw = (long long)a.Hp * a.Wp, npix = a.B * hw;
  float* qkv = scratch;
  float* part = qkv + npix * a.C;
  float* Mw = part + (long long)D.nwin * D.nsplit * D.part_floats;
  // a window of one split has its totals in part already
  float* tot = D.nsplit == 1 ? part : Mw + (long long)D.nwin * half * half;
  // windows on gridDim.x (up to 2^31 - 1; a 1088x1920 map has 130,560 of
  // 4x4), splits and token tiles on gridDim.y (at most 32 and 128)
  scc_qkv<T><<<dim3((unsigned)((hw + TQ - 1) / TQ), a.B), NT, s0, stream>>>(a, qkv);
  if constexpr (is_bf16)
    tca::scc_a1_bf16<<<dim3(D.nwin, D.nsplit), tca::NTA, s1, stream>>>(a, D, qkv, part);
  else
    scc_a1<T><<<dim3(D.nwin, D.nsplit), NT, s1, stream>>>(a, D, qkv, part);
  if (D.nsplit > 1) {
    const long long nsum = (long long)D.nwin * D.part_floats;
    scc_a2<<<(unsigned)((nsum + NT - 1) / NT), NT, 0, stream>>>(a, D, part, tot);
  }
  scc_m<<<D.nwin, NT, s2, stream>>>(a, D, tot, Mw);
  scc_b<T><<<dim3(D.nwin, (D.L + TC - 1) / TC), NT, s3, stream>>>(a, D, qkv, tot, Mw);
  if (tc_p)
    tcp::scc_proj_bf16<<<(unsigned)((npix + tcp::BM - 1) / tcp::BM), NT, s4, stream>>>(
        (bf16*)a.out, (const bf16*)a.proj, (const bf16*)a.projb, npix, a.C);
  else
    scc_proj<T><<<(unsigned)((npix + TC - 1) / TC), NT, s4, stream>>>(
        (T*)a.out, (const T*)a.proj, (const T*)a.projb, npix, a.C);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch bytes the launch needs (the caller allocates it).  The wgmma
// path (packed != 0): for windows of L >= 256 each window's operands and,
// with several splits, their float32 partials; none for smaller windows.
// The other kernels: float32 qkv, the partials, M, and the totals where a
// window has several splits.
extern "C" long long scc_block_scratch_bytes(int packed, int B, int Hp, int Wp, int C, int heads,
                                             int wh, int ww, int lb) {
  const Dims D = dims_of(B, Hp, Wp, C, heads, wh, ww, lb);
  if (packed) return wgs::scratch_bytes(D);
  return 4 * ((long long)B * Hp * Wp * C +
              (long long)D.nwin * ((D.nsplit + (D.nsplit > 1)) * D.part_floats +
                                   (long long)D.half * D.half));
}
// dtype: 0 float32, 1 bfloat16.  x/out (B, Hp, Wp, C); patches (B, Hp, Wp,
// 18) or NULL (no SCA, then w9a..s2 are unused); w9a/w9m (9, C); b9a/b9m
// (C); s1/s2 (B, C); wkv (C, C/2); bb (C/2); pmat (lb, L); pb one float32 on
// the device; bias (L, heads*lb); proj (C, C) in (in, out) layout; projb
// (C); wkvp (96, 192) and projp (192, 192) the wgmma path's packed weights
// (ops/kernels/scc_block.py::pack_wkv, pack_proj) or NULL.  Returns
// cudaGetLastError() after the launches, or -1 for refused shapes (C > 192
// among them).
extern "C" int scc_block_launch(int dtype, const void* x, const void* patches, const void* w9a,
                                const void* b9a, const void* w9m, const void* b9m,
                                const void* s1, const void* s2, const void* wkv,
                                const void* bb, const void* pmat, const void* pb,
                                const void* bias, const void* proj, const void* projb,
                                const void* wkvp, const void* projp, void* out, void* scratch, int B, int Hp, int Wp, int C, int heads, int wh,
                                int ww, int lb, void* stream) {
  if (B <= 0 || C <= 0 || C % 2 || heads <= 0 || (C / 2) % heads || wh <= 0 || ww <= 0 ||
      Hp % wh || Wp % ww || lb <= 0)
    return -1;
  Args a{x,    patches, w9a,  b9a,   w9m,  b9m, s1, s2, wkv, bb, pmat, (const float*)pb,
         bias, proj,    projb, wkvp, projp, out, B,  Hp, Wp,  C,  heads, wh, ww, lb};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && wkvp != nullptr) return wgs::launch(a, (unsigned char*)scratch, s);
  if (dtype == 0) return launch<float>(a, (float*)scratch, s);
  if (dtype == 1) return launch<bf16>(a, (float*)scratch, s);
  return -1;
}

