// Device helpers shared by the flash geometric attention kernels:
// flash_geometric_bwd.cuh (the dense two-walk backward, built by
// flash_geometric_bwd.cu), and the pair walks of flash_pairwalk_fwd.cu
// (B1, B4, B5 and their bf16 forms), flash_pairwalk_fwd_compact.cu (B1c,
// B4c, B5c and their bf16 forms),
// flash_pairwalk_bwd.cu (B2 and B2's bf16 form),
// flash_pairwalk_biased_bwd.cu (B6, B7a, B7b and their bf16 forms),
// flash_pairwalk_biased_bwd_compact.cu (B6c, B7a c, B7b c and their bf16
// forms) and flash_pairwalk_bwd_compact.cu (B3a c, B3b c and their bf16
// forms), through flash_pairwalk.cuh.
//
// The metric scores, the dropout hash and the backward's recompute of one
// (64-query tile, 64-key tile) pair. Every kernel takes the folded layout
// [G, H, N, D] (G = snapshots x sequences), fp32, the true D and Dv, and
// masks the ragged edge of N itself.
//
// The bf16 forms (template flag kBf16; the TPU kernels' bf16=True) round
// every operand of a product to bf16 (`rd`) and keep the fp32 FMAs: a
// product of two bf16 values is exact in fp32, so this is the TPU's bf16
// contraction with an fp32 accumulator up to the order of the sum. Only
// the operands are rounded: the row norms, the squared-distance metrics'
// q and k terms, the sums of the chain weights and the softmax
// denominator take fp32 values, as the TPU kernels do. So the q and k
// tiles are rounded in shared memory in place once their row norms are
// taken (`tile_norms`), do and v (operands only) are rounded as they are
// staged, W is rounded as each product loads it, and the squared-distance
// metrics' q and k terms read the unrounded rows from global memory. No
// second copy of a tile is kept: at D = Dv = 128 the fp32 tiles alone take
// 166 KB of the 227 KB a block may have, and rounded copies of q and k
// would pass it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tagan_flash {

constexpr int BM = 64;            // query rows per tile
constexpr int BN = 64;            // keys per tile
constexpr int THREADS = 256;      // 16 row groups x 16 lanes
constexpr int MAX_D = 128;        // D, Dv <= 16 * 8 lanes
constexpr float NEG_INF = -1e30f;
constexpr float LSE_DEAD = 1e30f;

// Order of tagan_torch.ops.flash_geometric.MXU_METRICS.
enum Metric : int {
  SCALED_DOT = 0, DOT = 1, SQ_EUCLID = 2, EUCLID = 3,
  GAUSSIAN = 4, RBF = 5, COS_SIM = 6, COS_DIST = 7,
};

// ---------------------------------------------------------------------------
// Mask forms. DENSE: an int8 [N, N] mask per folded batch index, read per
// pair. The compact occupied-block store of the hybrid backend's band holds
// only the occupied 64 x 64 tiles, slot s of batch index g at (g * S + s),
// and the walk names each step's slot (jslot): COMPACT_I8 stores a tile as
// int8 [64][64], COMPACT_BITS as 64 uint64 words, bit c of word r for pair
// (r, c). The pair walks read the compact store through
// flash_pairwalk_slots.cuh; the tile kernels here take the dense mask
// alone.
// ---------------------------------------------------------------------------

enum MaskForm : int { DENSE_MASK = 0, COMPACT_I8 = 1, COMPACT_BITS = 2 };

// Whether pair (gr, gc) is on the dense mask mg [N, N]; false past N.
__device__ __forceinline__ bool pair_on(const uint8_t* __restrict__ mg,
                                        int N, int gr, int gc) {
  if (gr >= N || gc >= N) return false;
  return mg[(size_t)gr * N + gc] != 0;
}

// x rounded to the nearest bf16 (ties to even) under kBf16, else x.
template <bool kBf16>
__device__ __forceinline__ float rd(float x) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

__device__ __forceinline__ bool is_sq_metric(int metric) {
  return metric >= SQ_EUCLID && metric <= RBF;
}

__device__ __forceinline__ float score_of(int metric, float qk, float qn,
                                          float kn, float scale,
                                          float sqrt_d) {
  switch (metric) {
    case SCALED_DOT: return qk / sqrt_d;
    case DOT: return qk;
    case COS_SIM: return fminf(fmaxf(qk, -1.f), 1.f);
    case COS_DIST: return fminf(fmaxf(qk, -1.f), 1.f) - 1.f;
    default: break;
  }
  const float sq = fmaxf(qn + kn - 2.f * qk, 0.f);
  switch (metric) {
    case SQ_EUCLID: return -sq;
    case EUCLID: return -sqrtf(sq + 1e-8f);
    case GAUSSIAN: return expf(-sq / (2.f * scale * scale));
    default: return expf(-scale * sq);  // RBF
  }
}

// _keep_mask's hash: `mix` is seed ^ (head * 0xC2B2AE3D).
__device__ __forceinline__ uint32_t keep_hash(uint32_t mix, uint32_t r,
                                              uint32_t c) {
  uint32_t x = r * 0x9E3779B1u;
  x ^= c * 0x85EBCA77u;
  x += mix;
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

// d clip(x, -1, 1) / dx with JAX's tie rule: 0.5 at exactly +-1.
__device__ __forceinline__ float clip_grad(float x) {
  const float hi = x > 1.f ? 0.f : (x == 1.f ? 0.5f : 1.f);
  const float lo = x < -1.f ? 0.f : (x == -1.f ? 0.5f : 1.f);
  return hi * lo;
}

// The chain weight W of a pair from ds = dL/ds_ij: for every metric
//   dq_i = sum_j W_ij k_j,   dk_j = sum_i W_ij q_i,
// and the squared-distance metrics subtract (sum_j W_ij) q_i and
// (sum_i W_ij) k_j, since there W = -2 dL/dsq and dsq/dq_i = 2 (q_i - k_j).
// The clamp max(sq, 0) counts as the identity, as in the TPU kernel.
__device__ __forceinline__ float chain_weight(int metric, float ds, float s,
                                              float sq, float qk, float scale,
                                              float sqrt_d) {
  switch (metric) {
    case SCALED_DOT: return ds / sqrt_d;
    case DOT: return ds;
    case COS_SIM:
    case COS_DIST: return ds * clip_grad(qk);
    case SQ_EUCLID: return 2.f * ds;
    case EUCLID: return ds * rsqrtf(sq + 1e-8f);
    case GAUSSIAN: return ds * s / (scale * scale);
    default: return 2.f * ds * scale * s;  // RBF
  }
}

// The chain weight of the bf16 forms: W = u / c, with u the quantity the
// TPU kernel rounds before its dq and dk products (_chain_dq, _chain_dk:
// ds for the dot metrics, ds clip'(qk) for cosine, dsq = dL/dsq for the
// squared-distance metrics, computed as _dsq_from_ds does) and c = 1,
// sqrt(d) or -1/2. c = -1/2 is exact in any rounding, so W = -2 dsq is
// returned; the scaled dot's 1/sqrt(d) does not commute with rounding, so
// it returns ds and the kernels divide their dq and dk sums by sqrt(d).
__device__ __forceinline__ float chain_weight_bf16(int metric, float ds,
                                                   float s, float sq,
                                                   float qk, float scale) {
  switch (metric) {
    case SCALED_DOT:
    case DOT: return ds;
    case COS_SIM:
    case COS_DIST: return ds * clip_grad(qk);
    case SQ_EUCLID: return -2.f * -ds;
    case EUCLID: return -2.f * (ds * (-0.5f * rsqrtf(sq + 1e-8f)));
    case GAUSSIAN: return -2.f * (ds * s * (-1.f / (2.f * scale * scale)));
    default: return -2.f * (ds * (-scale * s));  // RBF
  }
}

// The factor of a bf16 form's dq and dk sums: 1 / sqrt(d) for the scaled
// dot (`chain_weight_bf16`), else 1; the fp32 forms fold it into W.
template <bool kBf16>
__device__ __forceinline__ float chain_finish(int metric, float x,
                                              float sqrt_d) {
  return kBf16 && metric == SCALED_DOT ? x / sqrt_d : x;
}

// ---------------------------------------------------------------------------
// Backward: shared-memory tiles of one (query tile, key tile) pair.
// Row strides are odd (D + 1, Dv + 1, BN + 1) so that a column read across
// the 16 lanes of a half warp hits 16 banks.
// ---------------------------------------------------------------------------

struct BwdTiles {
  float* Qs;     // [BM][D + 1] (rounded to bf16 after its norms: bf16 forms)
  float* dOs;    // [BM][Dv + 1]
  float* Ks;     // [BN][D + 1] (likewise)
  float* Vs;     // [BN][Dv + 1]
  float* Ws;     // [BM][BN + 1] chain weights W
  float* Ps;     // [BM][BN + 1] dropped probabilities (for dv)
  float* qn;     // [BM] |q|^2
  float* lse;    // [BM]
  float* delta;  // [BM] rowsum(do * out) - dlse
  float* kn;     // [BN] |k|^2
  float* red;    // [THREADS / 32] block reduction scratch
};

__host__ __device__ inline size_t bwd_smem_floats(int D, int Dv) {
  return (size_t)BM * (D + 1) + (size_t)BM * (Dv + 1) +
         (size_t)BN * (D + 1) + (size_t)BN * (Dv + 1) +
         2 * (size_t)BM * (BN + 1) + 3 * BM + BN + THREADS / 32;
}

__device__ __forceinline__ BwdTiles bwd_tiles(float* smem, int D, int Dv) {
  BwdTiles t;
  t.Qs = smem;
  t.dOs = t.Qs + BM * (D + 1);
  t.Ks = t.dOs + BM * (Dv + 1);
  t.Vs = t.Ks + BN * (D + 1);
  t.Ws = t.Vs + BN * (Dv + 1);
  t.Ps = t.Ws + BM * (BN + 1);
  t.qn = t.Ps + BM * (BN + 1);
  t.lse = t.qn + BM;
  t.delta = t.lse + BM;
  t.kn = t.delta + BM;
  t.red = t.kn + BN;
  return t;
}

// rows [row0, row0 + 64) of a [N, width] matrix into dst with row stride
// width + 1, rounded to bf16 with kRound; rows past N read as 0.
template <bool kRound = false>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int N, int width) {
  const int stride = width + 1;
  for (int idx = threadIdx.x; idx < 64 * width; idx += THREADS) {
    const int r = idx / width, d = idx - r * width, gr = row0 + r;
    dst[r * stride + d] = rd<kRound>(gr < N ? src[(size_t)gr * width + d]
                                            : 0.f);
  }
}

// Query-side tiles: Q, dO (rounded in the bf16 forms: an operand only),
// lse and delta of rows [row0, row0 + 64).
template <bool kBf16 = false>
__device__ __forceinline__ void load_query_side(
    const BwdTiles& t, const float* qg, const float* dog, const float* lseg,
    const float* deltag, int row0, int N, int D, int Dv) {
  load_rows(t.Qs, qg, row0, N, D);
  load_rows<kBf16>(t.dOs, dog, row0, N, Dv);
  const int tid = threadIdx.x;
  if (tid < BM) {
    const int gr = row0 + tid;
    t.lse[tid] = gr < N ? lseg[gr] : LSE_DEAD;
    t.delta[tid] = gr < N ? deltag[gr] : 0.f;
  }
}

// Row norms |q|^2 of the query tile (threads 0..63) and |k|^2 of the key
// tile (threads 64..127), after the tiles are in shared memory; the bf16
// forms then round each row in place, by the thread that took its norm.
template <bool kBf16 = false>
__device__ __forceinline__ void tile_norms(const BwdTiles& t, int D,
                                           bool queries, bool keys) {
  const int tid = threadIdx.x, DS = D + 1;
  if (queries && tid < BM) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = t.Qs[tid * DS + d];
      s += x * x;
      if (kBf16) t.Qs[tid * DS + d] = rd<true>(x);
    }
    t.qn[tid] = s;
  } else if (keys && tid >= BM && tid < BM + BN) {
    const int r = tid - BM;
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = t.Ks[r * DS + d];
      s += x * x;
      if (kBf16) t.Ks[r * DS + d] = rd<true>(x);
    }
    t.kn[r] = s;
  }
}

// Element d of tile row lr (global row gr < N) of q or k as the caller
// gave it: the tile's value in the fp32 forms, and in the bf16 forms, whose
// tile is rounded, the row in global memory x [N, D] (the squared-distance
// metrics' q and k terms are fp32).
template <bool kBf16>
__device__ __forceinline__ float unrounded(const float* tile, const float* x,
                                           int lr, int gr, int D, int d) {
  if constexpr (kBf16) return x[(size_t)gr * D + d];
  else return tile[lr * (D + 1) + d];
}

// The products of one pair of tiles for thread (rg, lane), which owns
// query rows 4*rg..4*rg+3 and keys lane + 16*b (b < 4):
// s[a][b] = q . k and dp[a][b] = do . v of those rows and keys (from the
// tiles Qs, Ks, dOs and Vs: rounded in the bf16 forms).
__device__ __forceinline__ void tile_products(const BwdTiles& t, int D, int Dv,
                                              float (&s)[4][4],
                                              float (&dp)[4][4]) {
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1, VS = Dv + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s[a][b] = 0.f;
      dp[a][b] = 0.f;
    }
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qv[a] = t.Qs[(rg * 4 + a) * DS + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) kv[b] = t.Ks[(lane + 16 * b) * DS + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
  }
  for (int e = 0; e < Dv; ++e) {
    float ov[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) ov[a] = t.dOs[(rg * 4 + a) * VS + e];
#pragma unroll
    for (int b = 0; b < 4; ++b) vv[b] = t.Vs[(lane + 16 * b) * VS + e];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dp[a][b] = fmaf(ov[a], vv[b], dp[a][b]);
  }
}

// The recompute of one pair of tiles. Thread (rg, lane) owns query rows
// 4*rg..4*rg+3 and keys lane + 16*b (b < 4). For each valid pair (mask
// set, both indices < N) it forms
//   p  = exp(s - lse_i),  dp = drop(do_i . v_j),  ds = p (dp - delta_i)
// and writes W_ij to Ws and, with kWantP, drop(p)_ij to Ps; invalid pairs
// write 0. p is formed only on valid pairs, where lse_i >= s_ij, so no
// exp of a large positive number is taken (dead rows have no valid pair).
// The pair test is `pair_on` over the dense mask mg: kForm is DENSE_MASK
// and `rows` nullptr (the dense B3a's kForm stays a template parameter:
// without it ptxas spilled).
// kBf16 (the tiles staged for it by load_rows, load_query_side and
// tile_norms): W is `chain_weight_bf16`'s (unrounded: the squared-distance
// metrics' row and column sums of W are fp32, and the product loops round
// W as they load it) and drop(p) is stored rounded, being only an operand
// of dv's product.
// Returns this thread's part of sum ds * s * sq (the dscale numerator).
template <bool kWantP, int kForm = DENSE_MASK, bool kBf16 = false>
__device__ __forceinline__ float pair_weights(
    const BwdTiles& t, const uint8_t* __restrict__ mg, const uint64_t* rows,
    int N, int D, int Dv, int row0, int col0, int metric, float sc,
    float sqrt_d, int use_dropout, uint32_t mix, uint32_t keep_thresh,
    float inv_keep) {
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int PS = BN + 1;
  float s[4][4], dp[4][4];
  tile_products(t, D, Dv, s, dp);
  float dsc = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int lr = rg * 4 + a, gr = row0 + lr;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int lc = lane + 16 * b, gc = col0 + lc;
      float w = 0.f, pd = 0.f;
      if (pair_on(mg, N, gr, gc)) {
        const float qk = s[a][b];
        const float qn = t.qn[lr], kn = t.kn[lc];
        const float sv = score_of(metric, qk, qn, kn, sc, sqrt_d);
        const float sq = fmaxf(qn + kn - 2.f * qk, 0.f);
        const float p = expf(sv - t.lse[lr]);
        float dpv = dp[a][b];
        pd = p;
        if (use_dropout) {
          const bool keep =
              keep_hash(mix, (uint32_t)gr, (uint32_t)gc) < keep_thresh;
          dpv = keep ? dpv * inv_keep : 0.f;
          pd = keep ? p * inv_keep : 0.f;
        }
        const float ds = p * (dpv - t.delta[lr]);
        w = kBf16 ? chain_weight_bf16(metric, ds, sv, sq, qk, sc)
                  : chain_weight(metric, ds, sv, sq, qk, sc, sqrt_d);
        dsc = fmaf(ds * sv, sq, dsc);
      }
      t.Ws[lr * PS + lc] = w;
      if (kWantP) t.Ps[lr * PS + lc] = rd<kBf16>(pd);
    }
  }
  return dsc;
}

// Sum of `v` over the block, valid in thread 0. Ends with a barrier-free
// read; callers write the result from thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int tid = threadIdx.x;
  __syncthreads();
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (tid == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// d(scale) factor: gaussian ds/dsigma = s sq / sigma^3, rbf ds/dgamma = -s sq.
__device__ __forceinline__ float dscale_factor(int metric, float sc) {
  return metric == GAUSSIAN ? 1.f / (sc * sc * sc) : -1.f;
}

__host__ inline int lanes_for(int width) {
  const int l = (width + 15) / 16;
  return l <= 1 ? 1 : l <= 2 ? 2 : l <= 4 ? 4 : 8;
}

}  // namespace tagan_flash
