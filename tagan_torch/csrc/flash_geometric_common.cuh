// Device helpers shared by the flash geometric attention kernels, the
// pair walks of flash_pairwalk_fwd.cu (B1, B4, B5 and their bf16 forms),
// flash_pairwalk_fwd_compact.cu (B1c, B4c, B5c and their bf16 forms),
// flash_pairwalk_bwd.cu (B2 and B2's bf16 form),
// flash_pairwalk_two_walk.cu (B3a, B3b and their bf16 forms),
// flash_pairwalk_biased_bwd.cu (B6, B7a, B7b and their bf16 forms),
// flash_pairwalk_biased_bwd_compact.cu (B6c, B7a c, B7b c and their bf16
// forms), flash_pairwalk_bwd_compact.cu (B3a c, B3b c and their bf16
// forms) and ring_flash.cu (B9 and its bf16 form), through
// flash_pairwalk.cuh.
//
// The tile, the metric scores, the dropout hash and a pair's chain
// weight. Every kernel takes the folded layout [G, H, N, D] (G =
// snapshots x sequences), fp32, the true D and Dv, and masks the ragged
// edge of N itself.
//
// The bf16 forms (template flag kBf16; the TPU kernels' bf16=True) round
// every operand of a product to bf16 (`rd`) and keep the fp32 FMAs: a
// product of two bf16 values is exact in fp32, so this is the TPU's bf16
// contraction with an fp32 accumulator up to the order of the sum. Only
// the operands are rounded: the row norms, the squared-distance metrics'
// q and k terms, the sums of the chain weights and the softmax
// denominator take fp32 values, as the TPU kernels do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tagan_flash {

constexpr int BM = 64;            // query rows per tile
constexpr int BN = 64;            // keys per tile
constexpr int MAX_D = 128;        // D, Dv at most
constexpr float NEG_INF = -1e30f;
constexpr float LSE_DEAD = 1e30f;

// Order of tagan_torch.ops.flash_geometric.MXU_METRICS.
enum Metric : int {
  SCALED_DOT = 0, DOT = 1, SQ_EUCLID = 2, EUCLID = 3,
  GAUSSIAN = 4, RBF = 5, COS_SIM = 6, COS_DIST = 7,
};

// The compact occupied-block store of the hybrid backend's band holds only
// the occupied 64 x 64 tiles, slot s of batch index g at (g * S + s), and
// the walk names each step's slot (jslot): COMPACT_I8 stores a tile as
// int8 [64][64], COMPACT_BITS as 64 uint64 words, bit c of word r for pair
// (r, c). The pair walks read it through flash_pairwalk_slots.cuh.
enum MaskForm : int { COMPACT_I8 = 1, COMPACT_BITS = 2 };

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

// d(scale) factor: gaussian ds/dsigma = s sq / sigma^3, rbf ds/dgamma = -s sq.
__device__ __forceinline__ float dscale_factor(int metric, float sc) {
  return metric == GAUSSIAN ? 1.f / (sc * sc * sc) : -1.f;
}

}  // namespace tagan_flash
