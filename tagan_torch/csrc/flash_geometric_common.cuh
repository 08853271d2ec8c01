// Device helpers shared by the flash geometric attention kernels:
// flash_geometric_fwd.cu (forward), flash_geometric_bwd.cu (two-walk
// backward) and flash_geometric_bwd_fused.cu (single-walk backward).
//
// The metric scores, the dropout hash and the backward's recompute of one
// (64-query tile, 64-key tile) pair. Every kernel takes the folded layout
// [G, H, N, D] (G = snapshots x sequences), fp32, the true D and Dv, and
// masks the ragged edge of N itself.

#pragma once

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

// ---------------------------------------------------------------------------
// Backward: shared-memory tiles of one (query tile, key tile) pair.
// Row strides are odd (D + 1, Dv + 1, BN + 1) so that a column read across
// the 16 lanes of a half warp hits 16 banks.
// ---------------------------------------------------------------------------

struct BwdTiles {
  float* Qs;     // [BM][D + 1]
  float* dOs;    // [BM][Dv + 1]
  float* Ks;     // [BN][D + 1]
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
// width + 1; rows past N read as 0.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int N, int width) {
  const int stride = width + 1;
  for (int idx = threadIdx.x; idx < 64 * width; idx += THREADS) {
    const int r = idx / width, d = idx - r * width, gr = row0 + r;
    dst[r * stride + d] = gr < N ? src[(size_t)gr * width + d] : 0.f;
  }
}

// Query-side tiles: Q, dO, lse and delta of rows [row0, row0 + 64).
__device__ __forceinline__ void load_query_side(
    const BwdTiles& t, const float* qg, const float* dog, const float* lseg,
    const float* deltag, int row0, int N, int D, int Dv) {
  load_rows(t.Qs, qg, row0, N, D);
  load_rows(t.dOs, dog, row0, N, Dv);
  const int tid = threadIdx.x;
  if (tid < BM) {
    const int gr = row0 + tid;
    t.lse[tid] = gr < N ? lseg[gr] : LSE_DEAD;
    t.delta[tid] = gr < N ? deltag[gr] : 0.f;
  }
}

// Row norms |q|^2 of the query tile (threads 0..63) and |k|^2 of the key
// tile (threads 64..127), after the tiles are in shared memory.
__device__ __forceinline__ void tile_norms(const BwdTiles& t, int D,
                                           bool queries, bool keys) {
  const int tid = threadIdx.x, DS = D + 1;
  if (queries && tid < BM) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += t.Qs[tid * DS + d] * t.Qs[tid * DS + d];
    t.qn[tid] = s;
  } else if (keys && tid >= BM && tid < BM + BN) {
    const int r = tid - BM;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += t.Ks[r * DS + d] * t.Ks[r * DS + d];
    t.kn[r] = s;
  }
}

// The recompute of one pair of tiles. Thread (rg, lane) owns query rows
// 4*rg..4*rg+3 and keys lane + 16*b (b < 4). For each valid pair (mask
// set, both indices < N) it forms
//   p  = exp(s - lse_i),  dp = drop(do_i . v_j),  ds = p (dp - delta_i)
// and writes W_ij to Ws and, with kWantP, drop(p)_ij to Ps; invalid pairs
// write 0. p is formed only on valid pairs, where lse_i >= s_ij, so no
// exp of a large positive number is taken (dead rows have no valid pair).
// Returns this thread's part of sum ds * s * sq (the dscale numerator).
template <bool kWantP>
__device__ __forceinline__ float pair_weights(
    const BwdTiles& t, const uint8_t* __restrict__ mg, int N, int D, int Dv,
    int row0, int col0, int metric, float sc, float sqrt_d, int use_dropout,
    uint32_t mix, uint32_t keep_thresh, float inv_keep) {
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1, VS = Dv + 1, PS = BN + 1;
  float s[4][4], dp[4][4];
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
  float dsc = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int lr = rg * 4 + a, gr = row0 + lr;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int lc = lane + 16 * b, gc = col0 + lc;
      float w = 0.f, pd = 0.f;
      if (gr < N && gc < N && mg[(size_t)gr * N + gc] != 0) {
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
        w = chain_weight(metric, ds, sv, sq, qk, sc, sqrt_d);
        dsc = fmaf(ds * sv, sq, dsc);
      }
      t.Ws[lr * PS + lc] = w;
      if (kWantP) t.Ps[lr * PS + lc] = pd;
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
