// The edge-biased compact backward's tile kernels (B6c: delta1 and dB, B7a
// c: dq, B7b c: dk and dv), their launchers and their entry templates, for
// both compact store forms, for Hopper (sm_90a). Only their bf16 forms are
// built, by flash_biased_bwd_compact_bf16.cu (the TPU kernels' bf16=True).
// The fp32 forms of B6c, B7a c and B7b c are the compact row and key pair
// walks of flash_pairwalk_biased_bwd_compact.cu, and the dense forms B6,
// B7a and B7b those of flash_pairwalk_biased_bwd.cu.
//
// They port the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// that differentiate the dense path's double softmax, in their compact
// occupied-block form (the hybrid backend's band, host side
// tagan_tpu/ops/pallas/hybrid_biased.py _band_bwd_pre and
// _band_bwd_dq_dkv). The forward (B4c, B5c in flash_biased_fwd.cu)
// computed, per query row i, head h and valid key j (the store's bit at
// (i, j)), with s_ij the metric score:
//
//   w1 = exp(s - lse1),  w1d = drop1(w1),  z = w1d + B,
//   w2 = exp(z - lse2),  out_i = sum_j drop2(w2)_ij v_j.
//
// Each kernel recomputes these per pair (_bwd_biased_common) and, with
// dp2 = drop2(do_i . v_j), dz = w2 (dp2 - delta2_i), dw1 = drop1(dz) and
// ds = w1 (dw1 - delta1_i):
//
//   B6c   _biased_bwd_pre_kernel  delta1_i = sum_j w1 dw1  (per head)
//                                 dB_ij = sum_h dz         (head-shared B)
//   B7a c _biased_bwd_dq_kernel   dq_i = sum_j W_ij k_j, and d(scale)
//   B7b c _biased_bwd_dkv_kernel  dk_j = sum_i W_ij q_i,
//                                 dv_j = sum_i drop2(w2)_ij do_i
//
// where W is the metric's chain weight of ds (flash_geometric_common.cuh:
// chain_weight; the squared-distance metrics also subtract (sum_j W_ij) q_i
// and (sum_i W_ij) k_j). A dropped w1 is not a masked pair: z = B there, so dz
// and dB are non-zero while dw1 = 0. lse1, lse2, delta2 = rowsum(do * out) and
// (for B7a c, B7b c) delta1 are inputs, as in the TPU kernels: the hybrid
// backend passes statistics of a union of walks. Rows with lse = 1e30 (no
// valid key) give 0.
//
// Design. B6c keeps the TPU's order with the heads innermost: one thread
// block per (64-row query tile, folded batch index g) walks jlist[g, tile,
// :jcount] and, at each walked tile, loops over the H heads. Each thread
// sums its 4x4 pairs' dz over the heads in registers and writes its part of
// the dB slot once: no atomics. delta1 is summed per (row, head) in shared
// memory across the walk and written at the end; it is deterministic. B7a c
// and B7b c are B3a c and B3b c (flash_geometric_bwd.cuh) with this
// recompute: one block per (tile, head, g) on the forward walk (dq, and a
// d(scale) partial per block summed by the caller) or on the transposed walk
// (dk, dv), accumulators in registers, templated on the 16-wide feature
// lanes. Thread (rg, lane) owns query rows 4*rg..4*rg+3 and keys lane + 16*b
// (b < 4), as in every kernel here.
//
// Each step loads its store tile (slot g * S + jslot, or islot for B7b c:
// the same tile, row = query, column = key; there is no transposed store)
// into 64 row words in dynamic shared memory past the tiles, and reads the
// bias from the same slot of the bias store, [G, S, 64, 64]. B6c writes dB
// into the slots of the walked tiles, every pair (0 off the mask); slots no
// walk visits are left as they were, so the caller passes dB zeroed. Slot
// offsets are size_t: S * 64 * 64 passes 2^31 past ~130K slots.
//
// The bf16 forms (kBf16; the TPU kernels' bf16=True) round the operands of
// every product as B3a c's and B3b c's bf16 forms do
// (flash_geometric_common.cuh): q.k from tiles rounded in place after their
// norms, do.v from do and v rounded as staged, the chain's W k and W q with
// W = chain_weight_bf16 rounded as each product loads it (dq and dk sums
// finished by chain_finish), and dv = drop2(w2)^T do with drop2(w2) stored
// rounded. w1, z, w2, dz, delta1, dB and the squared-distance metrics' sums
// of W and their q and k terms (read unrounded from global memory) stay
// fp32. The backward normalises by lse1 and lse2, so no walk order enters.
//
// What bounds it on the H100. The work the data needs is ~2 to 6 products of
// head dim per valid pair and head; what must move is q, k, v, do, the row
// statistics, the store, the f32 bias and dB slots and the outputs. The
// walks visit only the band's occupied tiles: at one 131K hybrid snapshot
// ~35K tiles per head with ~1/60 of their pairs valid, and dB is written at
// 16 KB per walked tile. fp32 issue on the CUDA cores per walked pair sets
// the pace, far above that bound.

#pragma once

#include "flash_geometric_common.cuh"

namespace {

using namespace tagan_flash;

enum Mode : int { PRE = 0, DQ = 1, DKV = 2 };

// Shared floats: BwdTiles (t.lse holds lse1, t.delta delta1), then lse2 and
// delta2 of the query rows, then for B6c the delta1 sums [H][BM]. The 64
// mask-tile row words follow (an even count of floats before them, so they
// are 8-byte aligned).
__host__ __device__ inline size_t biased_smem_floats(int D, int Dv, int H,
                                                     bool pre) {
  return bwd_smem_floats(D, Dv) + 2 * BM + (pre ? (size_t)H * BM : 0);
}

size_t smem_bytes(int D, int Dv, int H, bool pre) {
  return sizeof(float) * biased_smem_floats(D, Dv, H, pre) +
         sizeof(uint64_t) * BM;
}

// One walk step's mask and bias tile: loads the store tile of `slot` into
// `rows` (all threads, between barriers); returns the bias tile's origin,
// slot * 64 * 64, row stride 64.
template <int kForm>
__device__ __forceinline__ const float* step_tile(uint64_t* rows,
                                                  const void* mask,
                                                  const float* bias,
                                                  size_t slot) {
  __syncthreads();  // every thread is done with the previous step's rows
  load_mask_tile<kForm>(rows, mask, slot);
  __syncthreads();
  return bias + slot * (BM * BN);
}

// The valid bits of this thread's 4 x 4 pairs of the step's tile: bit
// 4a + b for query row 4*rg + a and key lane + 16*b.
template <int kForm>
__device__ __forceinline__ unsigned valid_bits(const uint64_t* rows, int N,
                                               int row0, int col0) {
  const int rg = threadIdx.x >> 4, lane = threadIdx.x & 15;
  unsigned bits = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int lr = rg * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int lc = lane + 16 * b;
      if (pair_on<kForm>(nullptr, rows, N, row0 + lr, col0 + lc, lr, lc))
        bits |= 1u << (4 * a + b);
    }
  }
  return bits;
}

// lse1 (t.lse), lse2, delta2 and, where given, delta1 (t.delta) of rows
// [row0, row0 + 64): LSE_DEAD and 0 past N.
__device__ __forceinline__ void load_row_stats(
    const BwdTiles& t, float* lse2_s, float* delta2_s, const float* lse1g,
    const float* lse2g, const float* delta2g, const float* delta1g, int row0,
    int N) {
  const int tid = threadIdx.x;
  if (tid < BM) {
    const int gr = row0 + tid;
    const bool in = gr < N;
    t.lse[tid] = in ? lse1g[gr] : LSE_DEAD;
    lse2_s[tid] = in ? lse2g[gr] : LSE_DEAD;
    delta2_s[tid] = in ? delta2g[gr] : 0.f;
    if (delta1g != nullptr) t.delta[tid] = in ? delta1g[gr] : 0.f;
  }
}

// The recompute of one pair of tiles, for the pairs set in `valid`; the bias
// of pair (lr, lc) is bt[lr * 64 + lc]. PRE adds dz to db and w1 * dw1
// to this thread's row sums d1; DQ and DKV write the chain weight W of
// ds = w1 (dw1 - delta1) to Ws (0 on other pairs), DKV also drop2(w2) to Ps,
// and both return this thread's part of sum ds * s * sq. kBf16: W is
// `chain_weight_bf16`'s and drop2(w2) is stored rounded (an operand of dv's
// product only).
template <int kMode, bool kBf16>
__device__ __forceinline__ float biased_pairs(
    const BwdTiles& t, const float* lse2_s, const float* delta2_s,
    const float* __restrict__ bt, unsigned valid, int D, int Dv,
    int row0, int col0, int metric, float sc, float sqrt_d, int use_dropout,
    uint32_t mix1, uint32_t mix2, uint32_t keep_thresh, float inv_keep,
    float (&db)[4][4], float (&d1)[4]) {
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
      if (valid & (1u << (4 * a + b))) {
        const float qk = s[a][b];
        const float qn = t.qn[lr], kn = t.kn[lc];
        const float sv = score_of(metric, qk, qn, kn, sc, sqrt_d);
        const float w1 = expf(sv - t.lse[lr]);   // lse1 >= s: w1 <= 1
        float w1d = w1, dpv = dp[a][b];
        bool keep1 = true, keep2 = true;
        if (use_dropout) {
          keep1 = keep_hash(mix1, (uint32_t)gr, (uint32_t)gc) < keep_thresh;
          keep2 = keep_hash(mix2, (uint32_t)gr, (uint32_t)gc) < keep_thresh;
          w1d = keep1 ? w1 * inv_keep : 0.f;
          dpv = keep2 ? dpv * inv_keep : 0.f;
        }
        const float w2 =
            expf(w1d + bt[lr * BN + lc] - lse2_s[lr]);
        const float dz = w2 * (dpv - delta2_s[lr]);
        const float dw1 = use_dropout ? (keep1 ? dz * inv_keep : 0.f) : dz;
        if constexpr (kMode == PRE) {
          db[a][b] += dz;
          d1[a] = fmaf(w1, dw1, d1[a]);
        } else {
          const float ds = w1 * (dw1 - t.delta[lr]);
          const float sq = fmaxf(qn + kn - 2.f * qk, 0.f);
          w = kBf16 ? chain_weight_bf16(metric, ds, sv, sq, qk, sc)
                    : chain_weight(metric, ds, sv, sq, qk, sc, sqrt_d);
          dsc = fmaf(ds * sv, sq, dsc);
          pd = use_dropout ? (keep2 ? w2 * inv_keep : 0.f) : w2;
        }
      }
      if constexpr (kMode != PRE) t.Ws[lr * PS + lc] = w;
      if constexpr (kMode == DKV) t.Ps[lr * PS + lc] = rd<kBf16>(pd);
    }
  }
  return dsc;
}

// B6c: one block per (query tile, g); heads innermost at each walked
// block.
template <int kForm, bool kBf16>
__global__ void __launch_bounds__(THREADS)
biased_bwd_pre_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const void* __restrict__ mask,
                      const float* __restrict__ bias,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse1,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta2,
                      const int* __restrict__ jlist,
                      const int* __restrict__ jcount,
                      const int* __restrict__ jslot,
                      const float* __restrict__ scale,
                      const int* __restrict__ seeds,
                      float* __restrict__ delta1, float* __restrict__ dbias,
                      int H, int N, int D, int Dv, int n_i, int W, int S,
                      int metric, float sqrt_d, int use_dropout,
                      uint32_t keep_thresh, float inv_keep) {
  const int ib = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  extern __shared__ float smem[];
  const BwdTiles t = bwd_tiles(smem, D, Dv);
  float* lse2_s = smem + bwd_smem_floats(D, Dv);
  float* delta2_s = lse2_s + BM;
  float* d1_s = delta2_s + BM;                    // [H][BM]
  uint64_t* rows =
      reinterpret_cast<uint64_t*>(smem + biased_smem_floats(D, Dv, H, true));
  for (int idx = tid; idx < H * BM; idx += THREADS) d1_s[idx] = 0.f;

  const int row0 = ib * BM;
  const uint32_t s1 = (uint32_t)seeds[2 * g], s2 = (uint32_t)seeds[2 * g + 1];
  const size_t walk = (size_t)g * n_i + ib;
  const int cnt = jcount[walk];
  const int* jl = jlist + walk * W;
  const int* js = jslot + walk * W;
  for (int step = 0; step < cnt; ++step) {
    const int col0 = jl[step] * BN;
    const size_t slot = (size_t)g * S + (size_t)js[step];
    const float* bt = step_tile<kForm>(rows, mask, bias, slot);
    const unsigned valid = valid_bits<kForm>(rows, N, row0, col0);
    float db[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) db[a][b] = 0.f;
    for (int h = 0; h < H; ++h) {
      const size_t gh = (size_t)g * H + h;
      __syncthreads();  // the previous head is done with the tiles
      load_rows(t.Qs, q + gh * N * D, row0, N, D);
      load_rows<kBf16>(t.dOs, dout + gh * N * Dv, row0, N, Dv);
      load_rows(t.Ks, k + gh * N * D, col0, N, D);
      load_rows<kBf16>(t.Vs, v + gh * N * Dv, col0, N, Dv);
      load_row_stats(t, lse2_s, delta2_s, lse1 + gh * N, lse2 + gh * N,
                     delta2 + gh * N, nullptr, row0, N);
      __syncthreads();
      tile_norms<kBf16>(t, D, true, true);
      __syncthreads();
      const uint32_t hmix = (uint32_t)h * 0xC2B2AE3Du;
      float d1[4] = {0.f, 0.f, 0.f, 0.f};
      biased_pairs<PRE, kBf16>(t, lse2_s, delta2_s, bt, valid, D, Dv, row0,
                               col0, metric, scale[h], sqrt_d, use_dropout,
                               s1 ^ hmix, s2 ^ hmix, keep_thresh, inv_keep,
                               db, d1);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          d1[a] += __shfl_xor_sync(0xffffffffu, d1[a], o);
        // one writer per (row, head): the row group's lane 0
        if (lane == 0) d1_s[h * BM + rg * 4 + a] += d1[a];
      }
    }
    // the whole slot, every pair: dz is 0 off the mask
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* o = dbias + slot * (BM * BN) + (size_t)(rg * 4 + a) * BN;
#pragma unroll
      for (int b = 0; b < 4; ++b) o[lane + 16 * b] = db[a][b];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < H * BM; idx += THREADS) {
    const int h = idx / BM, gr = row0 + idx - h * BM;
    if (gr < N) delta1[((size_t)g * H + h) * N + gr] = d1_s[idx];
  }
}

// B7a c: dq and the d(scale) partials over the forward walk.
template <int LANES, int kForm, bool kBf16>
__global__ void __launch_bounds__(THREADS)
biased_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const void* __restrict__ mask,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse1,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta2,
                     const float* __restrict__ delta1,
                     const int* __restrict__ jlist,
                     const int* __restrict__ jcount,
                     const int* __restrict__ jslot,
                     const float* __restrict__ scale,
                     const int* __restrict__ seeds, float* __restrict__ dq,
                     float* __restrict__ dscale_part, int H, int N, int D,
                     int Dv, int n_i, int W, int S, int metric, float sqrt_d,
                     int use_dropout, uint32_t keep_thresh, float inv_keep,
                     int need_dscale) {
  const int ib = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1, PS = BN + 1;
  extern __shared__ float smem[];
  const BwdTiles t = bwd_tiles(smem, D, Dv);
  float* lse2_s = smem + bwd_smem_floats(D, Dv);
  float* delta2_s = lse2_s + BM;
  uint64_t* rows =
      reinterpret_cast<uint64_t*>(smem + biased_smem_floats(D, Dv, H, false));

  const size_t gh = (size_t)g * H + h;
  const float* qg = q + gh * N * D;
  const float* kg = k + gh * N * D;
  const float* vg = v + gh * N * Dv;
  const int row0 = ib * BM;
  load_rows(t.Qs, qg, row0, N, D);
  load_rows<kBf16>(t.dOs, dout + gh * N * Dv, row0, N, Dv);
  load_row_stats(t, lse2_s, delta2_s, lse1 + gh * N, lse2 + gh * N,
                 delta2 + gh * N, delta1 + gh * N, row0, N);
  __syncthreads();
  tile_norms<kBf16>(t, D, true, false);

  const float sc = scale[h];
  const uint32_t hmix = (uint32_t)h * 0xC2B2AE3Du;
  const uint32_t mix1 = (uint32_t)seeds[2 * g] ^ hmix;
  const uint32_t mix2 = (uint32_t)seeds[2 * g + 1] ^ hmix;
  float acc[4][LANES], wsum[4], db[4][4], d1[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    wsum[a] = 0.f;
#pragma unroll
    for (int jj = 0; jj < LANES; ++jj) acc[a][jj] = 0.f;
  }
  float dsc = 0.f;

  const size_t walk = (size_t)g * n_i + ib;
  const int cnt = jcount[walk];
  const int* jl = jlist + walk * W;
  const int* js = jslot + walk * W;
  for (int step = 0; step < cnt; ++step) {
    const int col0 = jl[step] * BN;
    const size_t slot = (size_t)g * S + (size_t)js[step];
    const float* bt = step_tile<kForm>(rows, mask, bias, slot);
    const unsigned valid = valid_bits<kForm>(rows, N, row0, col0);
    __syncthreads();  // the previous step is done with Ks, Vs and Ws
    load_rows(t.Ks, kg, col0, N, D);
    load_rows<kBf16>(t.Vs, vg, col0, N, Dv);
    __syncthreads();
    tile_norms<kBf16>(t, D, false, true);
    __syncthreads();
    dsc += biased_pairs<DQ, kBf16>(t, lse2_s, delta2_s, bt, valid, D, Dv,
                                   row0, col0, metric, sc, sqrt_d,
                                   use_dropout, mix1, mix2, keep_thresh,
                                   inv_keep, db, d1);
    __syncthreads();
    for (int j = 0; j < BN; ++j) {
      float w[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float wf = t.Ws[(rg * 4 + a) * PS + j];
        wsum[a] += wf;
        w[a] = rd<kBf16>(wf);
      }
#pragma unroll
      for (int jj = 0; jj < LANES; ++jj) {
        const int d = lane + 16 * jj;
        if (d < D) {
          const float kv = t.Ks[j * DS + d];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][jj] = fmaf(w[a], kv, acc[a][jj]);
        }
      }
    }
  }

  const bool sqm = is_sq_metric(metric);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int lr = rg * 4 + a, gr = row0 + lr;
    if (gr >= N) continue;
    float* o = dq + (gh * N + gr) * D;
#pragma unroll
    for (int jj = 0; jj < LANES; ++jj) {
      const int d = lane + 16 * jj;
      if (d < D)
        o[d] = sqm ? acc[a][jj] - wsum[a] * unrounded<kBf16>(t.Qs, qg, lr,
                                                             gr, D, d)
                   : chain_finish<kBf16>(metric, acc[a][jj], sqrt_d);
    }
  }
  if (need_dscale) {
    const float s = block_sum(dsc, t.red);
    if (tid == 0) dscale_part[gh * n_i + ib] = s * dscale_factor(metric, sc);
  }
}

// B7b c: dk and dv over the transposed walk.
template <int LANES, int kForm, bool kBf16>
__global__ void __launch_bounds__(THREADS)
biased_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const void* __restrict__ mask,
                      const float* __restrict__ bias,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse1,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta2,
                      const float* __restrict__ delta1,
                      const int* __restrict__ ilist,
                      const int* __restrict__ icount,
                      const int* __restrict__ islot,
                      const float* __restrict__ scale,
                      const int* __restrict__ seeds, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int N, int D, int Dv,
                      int n_j, int W, int S, int metric, float sqrt_d,
                      int use_dropout, uint32_t keep_thresh, float inv_keep) {
  const int jb = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1, VS = Dv + 1, PS = BN + 1;
  extern __shared__ float smem[];
  const BwdTiles t = bwd_tiles(smem, D, Dv);
  float* lse2_s = smem + bwd_smem_floats(D, Dv);
  float* delta2_s = lse2_s + BM;
  uint64_t* rows =
      reinterpret_cast<uint64_t*>(smem + biased_smem_floats(D, Dv, H, false));

  const size_t gh = (size_t)g * H + h;
  const float* qg = q + gh * N * D;
  const float* dog = dout + gh * N * Dv;
  const float* kg = k + gh * N * D;
  const int col0 = jb * BN;
  load_rows(t.Ks, kg, col0, N, D);
  load_rows<kBf16>(t.Vs, v + gh * N * Dv, col0, N, Dv);
  __syncthreads();
  tile_norms<kBf16>(t, D, false, true);

  const float sc = scale[h];
  const uint32_t hmix = (uint32_t)h * 0xC2B2AE3Du;
  const uint32_t mix1 = (uint32_t)seeds[2 * g] ^ hmix;
  const uint32_t mix2 = (uint32_t)seeds[2 * g + 1] ^ hmix;
  float dka[4][LANES], dva[4][LANES], wsum[4], db[4][4], d1[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    wsum[a] = 0.f;
#pragma unroll
    for (int jj = 0; jj < LANES; ++jj) dka[a][jj] = dva[a][jj] = 0.f;
  }

  const size_t walk = (size_t)g * n_j + jb;
  const int cnt = icount[walk];
  const int* il = ilist + walk * W;
  const int* is = islot + walk * W;
  for (int step = 0; step < cnt; ++step) {
    const int row0 = il[step] * BM;
    const size_t slot = (size_t)g * S + (size_t)is[step];
    const float* bt = step_tile<kForm>(rows, mask, bias, slot);
    const unsigned valid = valid_bits<kForm>(rows, N, row0, col0);
    __syncthreads();  // the previous step is done with the query side
    load_rows(t.Qs, qg, row0, N, D);
    load_rows<kBf16>(t.dOs, dog, row0, N, Dv);
    load_row_stats(t, lse2_s, delta2_s, lse1 + gh * N, lse2 + gh * N,
                   delta2 + gh * N, delta1 + gh * N, row0, N);
    __syncthreads();
    tile_norms<kBf16>(t, D, true, false);
    __syncthreads();
    biased_pairs<DKV, kBf16>(t, lse2_s, delta2_s, bt, valid, D, Dv, row0,
                             col0, metric, sc, sqrt_d, use_dropout, mix1,
                             mix2, keep_thresh, inv_keep, db, d1);
    __syncthreads();
    for (int i = 0; i < BM; ++i) {
      float w[4], p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float wf = t.Ws[i * PS + rg * 4 + a];
        wsum[a] += wf;
        w[a] = rd<kBf16>(wf);
        p[a] = t.Ps[i * PS + rg * 4 + a];
      }
#pragma unroll
      for (int jj = 0; jj < LANES; ++jj) {
        const int d = lane + 16 * jj;
        if (d < D) {
          const float qv = t.Qs[i * DS + d];
#pragma unroll
          for (int a = 0; a < 4; ++a) dka[a][jj] = fmaf(w[a], qv, dka[a][jj]);
        }
        if (d < Dv) {
          const float ov = t.dOs[i * VS + d];
#pragma unroll
          for (int a = 0; a < 4; ++a) dva[a][jj] = fmaf(p[a], ov, dva[a][jj]);
        }
      }
    }
  }

  const bool sqm = is_sq_metric(metric);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int lc = rg * 4 + a, gc = col0 + lc;
    if (gc >= N) continue;
    float* ok = dk + (gh * N + gc) * D;
    float* ov = dv + (gh * N + gc) * Dv;
#pragma unroll
    for (int jj = 0; jj < LANES; ++jj) {
      const int d = lane + 16 * jj;
      if (d < D)
        ok[d] = sqm ? dka[a][jj] - wsum[a] * unrounded<kBf16>(t.Ks, kg, lc,
                                                              gc, D, d)
                    : chain_finish<kBf16>(metric, dka[a][jj], sqrt_d);
      if (d < Dv) ov[d] = dva[a][jj];
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool bad_args(int G, int H, int N, int D, int Dv, int n_tiles, int W,
              int S, int metric) {
  return G < 0 || H < 0 || N < 0 || D < 1 || D > MAX_D || Dv < 1 ||
         Dv > MAX_D || metric < 0 || metric > COS_DIST ||
         n_tiles != (N + BM - 1) / BM || W < 0 || S < 1;
}

template <int kForm, bool kBf16 = false>
int pre_entry(const void* q, const void* k, const void* v, const void* mask,
              const void* bias, const void* dout, const void* lse1,
              const void* lse2, const void* delta2, const void* jlist,
              const void* jcount, const void* jslot, const void* scale,
              const void* seeds, void* delta1, void* dbias, int G, int H,
              int N, int D, int Dv, int n_i, int W, int S, int metric,
              float sqrt_d, int use_dropout, unsigned int keep_thresh,
              float inv_keep, void* stream) {
  if (bad_args(G, H, N, D, Dv, n_i, W, S, metric))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const size_t smem = smem_bytes(D, Dv, H, true);
  const cudaError_t e = prepare(biased_bwd_pre_kernel<kForm, kBf16>, smem);
  if (e != cudaSuccess) return (int)e;
  biased_bwd_pre_kernel<kForm, kBf16><<<dim3(n_i, G), THREADS, smem,
                                        (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, mask,
      (const float*)bias, (const float*)dout, (const float*)lse1,
      (const float*)lse2, (const float*)delta2, (const int*)jlist,
      (const int*)jcount, (const int*)jslot, (const float*)scale,
      (const int*)seeds, (float*)delta1, (float*)dbias, H, N, D, Dv, n_i, W,
      S, metric, sqrt_d, use_dropout, keep_thresh, inv_keep);
  return (int)cudaGetLastError();
}

template <int kForm, bool kBf16 = false>
int dq_entry(const void* q, const void* k, const void* v, const void* mask,
             const void* bias, const void* dout, const void* lse1,
             const void* lse2, const void* delta2, const void* delta1,
             const void* jlist, const void* jcount, const void* jslot,
             const void* scale, const void* seeds, void* dq,
             void* dscale_part, int G, int H, int N, int D, int Dv, int n_i,
             int W, int S, int metric, float sqrt_d, int use_dropout,
             unsigned int keep_thresh, float inv_keep, int need_dscale,
             void* stream) {
  if (bad_args(G, H, N, D, Dv, n_i, W, S, metric))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const size_t smem = smem_bytes(D, Dv, H, false);
  const dim3 grid(n_i, H, G);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_for(D)) {
#define TAGAN_BDQ(L)                                                         \
  case L: {                                                                  \
    const cudaError_t e =                                                    \
        prepare(biased_bwd_dq_kernel<L, kForm, kBf16>, smem);                \
    if (e != cudaSuccess) return (int)e;                                     \
    biased_bwd_dq_kernel<L, kForm, kBf16><<<grid, THREADS, smem, s>>>(       \
        (const float*)q, (const float*)k, (const float*)v, mask,             \
        (const float*)bias, (const float*)dout, (const float*)lse1,          \
        (const float*)lse2, (const float*)delta2, (const float*)delta1,      \
        (const int*)jlist, (const int*)jcount, (const int*)jslot,            \
        (const float*)scale, (const int*)seeds, (float*)dq,                  \
        (float*)dscale_part, H, N, D, Dv, n_i, W, S, metric, sqrt_d,         \
        use_dropout, keep_thresh, inv_keep, need_dscale);                    \
    return (int)cudaGetLastError();                                          \
  }
    TAGAN_BDQ(1) TAGAN_BDQ(2) TAGAN_BDQ(4) TAGAN_BDQ(8)
#undef TAGAN_BDQ
  }
  return (int)cudaErrorInvalidValue;
}

template <int kForm, bool kBf16 = false>
int dkv_entry(const void* q, const void* k, const void* v, const void* mask,
              const void* bias, const void* dout, const void* lse1,
              const void* lse2, const void* delta2, const void* delta1,
              const void* ilist, const void* icount, const void* islot,
              const void* scale, const void* seeds, void* dk, void* dv,
              int G, int H, int N, int D, int Dv, int n_j, int W, int S,
              int metric, float sqrt_d, int use_dropout,
              unsigned int keep_thresh, float inv_keep, void* stream) {
  if (bad_args(G, H, N, D, Dv, n_j, W, S, metric))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const size_t smem = smem_bytes(D, Dv, H, false);
  const dim3 grid(n_j, H, G);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_for(D > Dv ? D : Dv)) {
#define TAGAN_BDKV(L)                                                        \
  case L: {                                                                  \
    const cudaError_t e =                                                    \
        prepare(biased_bwd_dkv_kernel<L, kForm, kBf16>, smem);               \
    if (e != cudaSuccess) return (int)e;                                     \
    biased_bwd_dkv_kernel<L, kForm, kBf16><<<grid, THREADS, smem, s>>>(      \
        (const float*)q, (const float*)k, (const float*)v, mask,             \
        (const float*)bias, (const float*)dout, (const float*)lse1,          \
        (const float*)lse2, (const float*)delta2, (const float*)delta1,      \
        (const int*)ilist, (const int*)icount, (const int*)islot,            \
        (const float*)scale, (const int*)seeds, (float*)dk, (float*)dv, H,   \
        N, D, Dv, n_j, W, S, metric, sqrt_d, use_dropout, keep_thresh,       \
        inv_keep);                                                           \
    return (int)cudaGetLastError();                                          \
  }
    TAGAN_BDKV(1) TAGAN_BDKV(2) TAGAN_BDKV(4) TAGAN_BDKV(8)
#undef TAGAN_BDKV
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
