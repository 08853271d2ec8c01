// Edge-biased geometric attention, forward, for Hopper (sm_90a): two kernels.
//
// Replaces the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// that serve the dense path's double softmax (host side
// _flash_biased_forward), in their dense-mask form (B4, B5), their compact
// occupied-block form (B4c, B5c: hybrid_biased.py _band_lse1 and
// _band_biased_main) and the bf16 form (bf16=True) of B4c and B5c (B4's
// and B5's bf16 forms are the pair walks of flash_pairwalk_fwd.cu). For
// each query row i and head h, over the valid keys j (mask[i, j] != 0),
// with s_ij the metric score:
//
//   B4  _lse1_kernel          lse1_i = logsumexp_j s_ij
//   B5  _flash_biased_kernel  w1_ij  = exp(s_ij - lse1_i)
//                             w1d_ij = keep1_ij ? w1_ij / (1 - p) : 0
//                             z_ij   = w1d_ij + bias[i, j]
//                             out_i  = sum_j drop2(softmax_j z_ij) v_j
//                             lse2_i = logsumexp_j z_ij
//
// with out = 0 and lse = 1e30 on rows that have no valid key. A dropped w1 is
// not a masked pair: it enters the second softmax as z = bias. The
// denominator of the second softmax is the un-dropped sum. keep1 and keep2
// are the JAX package's coordinate hash (_keep_mask) with the snapshot's two
// seeds, bit for bit. The bias is shared by the heads. lse1 is an input of
// B5, not recomputed inside it: the hybrid backend passes a logsumexp over a
// superset of the walked pairs.
//
// Design. As B1 (flash_geometric_fwd.cu), whose layout both share: one
// thread block per (64-row query tile, head, folded batch index g) walks
// jlist[g, tile, :jcount[g, tile]], staging K (and for B5 V) tiles in shared
// memory, with the running max and sum (and for B5 the output accumulator)
// in registers. One template serves both: B4 keeps only the max and sum; B5
// turns each valid score into z before the same online softmax and adds the
// dropped weights times V. 256 threads: thread (rg, c) owns query rows
// 4*rg..4*rg+3, keys c + 16*b (b < 4) of each step and output columns
// c + 16*jj.
//
// What bounds it on the H100. The least traffic is the int8 mask (N^2 bytes
// per snapshot), read once, and, for B5, the fp32 bias at the valid pairs
// only (4 bytes each): the result depends on no other bias entry.
// The walk reads a mask byte per walked pair and head, and, like B1, spends
// fp32 issue on nearly every one of the N^2 pairs per head when the edges
// are spread over all 64x64 blocks; the bias is read only on valid pairs,
// but once per head. Reading each bias tile once, with the heads innermost
// in one block, is the first thing a later redesign changes.
//
// The bf16 forms (kBf16, the compact mask forms; the TPU kernels'
// bf16=True) round the operands of q.k and of P@V as B1's bf16 form does:
// the q and k tiles in place once their norms are taken, v as staged, and
// B5c's dropped p2 as it is stored for P@V. The norms, w1, z, the running
// max and the un-dropped sum l stay fp32. B5c's p2 is rounded relative to
// the running max after each key tile, so its result depends on the walk,
// as the TPU kernel's does on its block size; B4c's does not.
//
// The compact form reads the mask tile from the store slot of each walk step
// (flash_geometric_common.cuh) and the bias from the same slot of a bias
// store f32[G, S, 64, 64]: a contiguous 16 KB tile, not strided [N, N] rows.
// At the hybrid band lse1 is the union of the band's and the residual's.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_geometric_common.cuh"

namespace {

using namespace tagan_flash;

constexpr int ROWS = BM / 16;     // query rows per thread
constexpr int COLS = BN / 16;     // keys per thread and step
constexpr int MAX_DV_LANES = 8;   // output columns per thread: Dv <= 128

// Shared floats of one block: Q, K, |q|^2, |k|^2, and for B5 lse1, V and the
// dropped weights.
__host__ inline size_t smem_floats(bool main_walk, int D, int Dv) {
  size_t n = (size_t)(BM + BN) * (D + 1) + BM + BN;
  if (main_walk) n += BM + (size_t)BN * Dv + (size_t)BM * (BN + 1);
  return n;
}

template <bool kMain, int kForm, bool kBf16>
__global__ void __launch_bounds__(THREADS)
biased_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const void* __restrict__ mask,
                  const float* __restrict__ bias,
                  const float* __restrict__ lse1,
                  const int* __restrict__ jlist,
                  const int* __restrict__ jcount,
                  const int* __restrict__ jslot,
                  const float* __restrict__ scale,
                  const int* __restrict__ seeds, float* __restrict__ out,
                  float* __restrict__ lse_out, int H, int N, int D, int Dv,
                  int n_i, int W, int S, int metric, float sqrt_d,
                  int use_dropout, uint32_t keep_thresh, float inv_keep) {
  const int ib = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1;        // odd row stride: no bank conflicts on K
  const int PS = BN + 1;

  extern __shared__ float smem[];
  float* Qs = smem;            // [BM][DS]
  float* Ks = Qs + BM * DS;    // [BN][DS]
  float* qn_s = Ks + BN * DS;  // [BM]
  float* kn_s = qn_s + BM;     // [BN]
  float* l1_s = kn_s + BN;     // [BM]      B5 only
  float* Vs = l1_s + BM;       // [BN][Dv]  B5 only
  float* Ps = Vs + BN * Dv;    // [BM][PS]  B5 only
  __shared__ uint64_t mrow[BM];  // the compact forms' mask tile

  const size_t gh = (size_t)g * H + h;
  const float* qg = q + gh * N * D;
  const float* kg = k + gh * N * D;
  constexpr bool dense = kForm == DENSE_MASK;
  const uint8_t* mg =
      static_cast<const uint8_t*>(mask) + (dense ? (size_t)g * N * N : 0);
  const int row0 = ib * BM;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D, gr = row0 + r;
    Qs[r * DS + d] = gr < N ? qg[(size_t)gr * D + d] : 0.f;
  }
  if constexpr (kMain) {
    if (tid < BM) {
      const int gr = row0 + tid;
      l1_s[tid] = gr < N ? lse1[gh * N + gr] : LSE_DEAD;
    }
  }
  __syncthreads();
  if (tid < BM) {    // the norm of row tid, then (bf16) the row rounded
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = Qs[tid * DS + d];
      s += x * x;
      if (kBf16) Qs[tid * DS + d] = rd<true>(x);
    }
    qn_s[tid] = s;
  }

  const float sc = scale[h];
  const uint32_t hmix = (uint32_t)h * 0xC2B2AE3Du;
  uint32_t mix1 = 0, mix2 = 0;
  const float* bg = nullptr;
  if constexpr (kMain) {
    mix1 = (uint32_t)seeds[2 * g] ^ hmix;
    mix2 = (uint32_t)seeds[2 * g + 1] ^ hmix;
    if (dense) bg = bias + (size_t)g * N * N;
  }
  const int n_lanes = (Dv + 15) / 16;

  float m_i[ROWS], l_i[ROWS], acc[ROWS][MAX_DV_LANES];
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    m_i[a] = NEG_INF;
    l_i[a] = 0.f;
#pragma unroll
    for (int jj = 0; jj < MAX_DV_LANES; ++jj) acc[a][jj] = 0.f;
  }

  const int cnt = jcount[(size_t)g * n_i + ib];
  const int* jl = jlist + ((size_t)g * n_i + ib) * W;
  const int* js = jslot + ((size_t)g * n_i + ib) * W;
  for (int t = 0; t < cnt; ++t) {
    const int col0 = jl[t] * BN;
    __syncthreads();  // the previous step is done with Ks, Vs, Ps and mrow
    if constexpr (!dense) {
      const size_t slot = (size_t)g * S + js[t];
      load_mask_tile<kForm>(mrow, mask, slot);
      if constexpr (kMain) bg = bias + slot * (BM * BN);
    }
    for (int idx = tid; idx < BN * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D, gc = col0 + r;
      Ks[r * DS + d] = gc < N ? kg[(size_t)gc * D + d] : 0.f;
    }
    if constexpr (kMain) {
      const float* vg = v + gh * N * Dv;
      for (int idx = tid; idx < BN * Dv; idx += THREADS) {
        const int r = idx / Dv, d = idx - r * Dv, gc = col0 + r;
        Vs[idx] = rd<kBf16>(gc < N ? vg[(size_t)gc * Dv + d] : 0.f);
      }
    }
    __syncthreads();
    if (tid < BN) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) {
        const float x = Ks[tid * DS + d];
        s += x * x;
        if (kBf16) Ks[tid * DS + d] = rd<true>(x);
      }
      kn_s[tid] = s;
    }
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int a = 0; a < ROWS; ++a)
#pragma unroll
      for (int b = 0; b < COLS; ++b) s[a][b] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int a = 0; a < ROWS; ++a) qv[a] = Qs[(rg * ROWS + a) * DS + d];
#pragma unroll
      for (int b = 0; b < COLS; ++b) kv[b] = Ks[(lane + 16 * b) * DS + d];
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int b = 0; b < COLS; ++b) s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int lr = rg * ROWS + a, gr = row0 + lr;
      float mx = NEG_INF;
#pragma unroll
      for (int b = 0; b < COLS; ++b) {
        const int lc = lane + 16 * b, gc = col0 + lc;
        float val = NEG_INF;
        if (pair_on<kForm>(mg, mrow, N, gr, gc, lr, lc)) {
          val = score_of(metric, s[a][b], qn_s[lr], kn_s[lc], sc, sqrt_d);
          if constexpr (kMain) {
            // lse1 >= the row's valid scores, so w1 <= 1
            float w1 = expf(val - l1_s[lr]);
            if (use_dropout) {
              const bool keep =
                  keep_hash(mix1, (uint32_t)gr, (uint32_t)gc) < keep_thresh;
              w1 = keep ? w1 * inv_keep : 0.f;
            }
            val = w1 + (dense ? bg[(size_t)gr * N + gc] : bg[lr * BN + lc]);
          }
        }
        s[a][b] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // A row that has seen no valid key yet keeps m == NEG_INF and
      // accumulates p == 1 garbage, washed out by alpha == 0 once a valid
      // key arrives; a row that stays dead is zeroed at the end.
      const float m_new = fmaxf(m_i[a], mx);
      const float alpha = expf(m_i[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < COLS; ++b) {
        float p = expf(s[a][b] - m_new);
        rs += p;
        if constexpr (kMain) {
          const int lc = lane + 16 * b;
          if (use_dropout) {
            const bool keep = keep_hash(mix2, (uint32_t)gr,
                                        (uint32_t)(col0 + lc)) < keep_thresh;
            p = keep ? p * inv_keep : 0.f;
          }
          Ps[lr * PS + lc] = rd<kBf16>(p);
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_i[a] = l_i[a] * alpha + rs;
      m_i[a] = m_new;
      if constexpr (kMain) {
#pragma unroll
        for (int jj = 0; jj < MAX_DV_LANES; ++jj) acc[a][jj] *= alpha;
      }
    }

    if constexpr (kMain) {
      __syncthreads();
      for (int j = 0; j < BN; ++j) {
        float pv[ROWS];
#pragma unroll
        for (int a = 0; a < ROWS; ++a) pv[a] = Ps[(rg * ROWS + a) * PS + j];
#pragma unroll
        for (int jj = 0; jj < MAX_DV_LANES; ++jj) {
          const int dv = lane + 16 * jj;
          if (jj < n_lanes && dv < Dv) {
            const float vv = Vs[j * Dv + dv];
#pragma unroll
            for (int a = 0; a < ROWS; ++a)
              acc[a][jj] = fmaf(pv[a], vv, acc[a][jj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    const int gr = row0 + rg * ROWS + a;
    if (gr >= N) continue;
    const bool dead = m_i[a] <= NEG_INF;
    const float l = dead ? 1.f : l_i[a];
    if constexpr (kMain) {
      float* og = out + (gh * N + gr) * Dv;
#pragma unroll
      for (int jj = 0; jj < MAX_DV_LANES; ++jj) {
        const int dv = lane + 16 * jj;
        if (jj < n_lanes && dv < Dv) og[dv] = dead ? 0.f : acc[a][jj] / l;
      }
    }
    if (lane == 0) lse_out[gh * N + gr] = dead ? LSE_DEAD : m_i[a] + logf(l);
  }
}

template <bool kMain, int kForm, bool kBf16 = false>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* bias, const void* lse1, const void* jlist,
           const void* jcount, const void* jslot, const void* scale,
           const void* seeds, void* out, void* lse_out, int G, int H, int N,
           int D, int Dv, int n_i, int W, int S, int metric, float sqrt_d,
           int use_dropout, unsigned int keep_thresh, float inv_keep,
           void* stream) {
  if (G < 0 || H < 0 || N < 0 || D < 1 || D > MAX_D ||
      (kMain && (Dv < 1 || Dv > 16 * MAX_DV_LANES)) || metric < 0 ||
      metric > COS_DIST || n_i != (N + BM - 1) / BM || W < 0 ||
      (kForm != DENSE_MASK && S < 1))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const size_t smem = sizeof(float) * smem_floats(kMain, D, kMain ? Dv : 0);
  if (smem > 48 * 1024 - sizeof(uint64_t) * BM) {
    const cudaError_t e = cudaFuncSetAttribute(
        biased_fwd_kernel<kMain, kForm, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_i, H, G);
  biased_fwd_kernel<kMain, kForm, kBf16>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
          (const float*)q, (const float*)k, (const float*)v, mask,
          (const float*)bias, (const float*)lse1, (const int*)jlist,
          (const int*)jcount, (const int*)jslot, (const float*)scale,
          (const int*)seeds, (float*)out, (float*)lse_out, H, N, D,
          kMain ? Dv : 0, n_i, W, S, metric, sqrt_d, use_dropout,
          keep_thresh, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// B4: lse1 [G, H, N] of the forward walk.
extern "C" int tagan_flash_lse1(const void* q, const void* k,
                                const void* mask, const void* jlist,
                                const void* jcount, const void* scale,
                                void* lse1, int G, int H, int N, int D,
                                int n_i, int W, int metric, float sqrt_d,
                                void* stream) {
  using namespace tagan_flash;
  return launch<false, DENSE_MASK>(q, k, nullptr, mask, nullptr, nullptr,
                                   jlist, jcount, jlist, scale, nullptr,
                                   nullptr, lse1, G, H, N, D, 0, n_i, W, 0,
                                   metric, sqrt_d, 0, 0u, 1.f, stream);
}

// B5: out [G, H, N, Dv] and lse2 [G, H, N] of the second softmax, given
// lse1 [G, H, N], the bias [G, N, N] and two seeds per g, [G, 2].
extern "C" int tagan_flash_biased_fwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* lse1, const void* jlist, const void* jcount,
    const void* scale, const void* seeds, void* out, void* lse2, int G, int H,
    int N, int D, int Dv, int n_i, int W, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep, void* stream) {
  using namespace tagan_flash;
  return launch<true, DENSE_MASK>(q, k, v, mask, bias, lse1, jlist, jcount,
                                  jlist, scale, seeds, out, lse2, G, H, N, D,
                                  Dv, n_i, W, 0, metric, sqrt_d, use_dropout,
                                  keep_thresh, inv_keep, stream);
}

// B4c: lse1 over the compact store (bits i64[G, S, 64] when packed, else
// int8 [G, S, 64, 64]) with the slot of each walk step, jslot [G, n_i, W].
extern "C" int tagan_flash_lse1_compact(
    const void* q, const void* k, const void* store, const void* jlist,
    const void* jcount, const void* jslot, const void* scale, void* lse1,
    int G, int H, int N, int D, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, void* stream) {
  using namespace tagan_flash;
  return (packed ? launch<false, COMPACT_BITS> : launch<false, COMPACT_I8>)(
      q, k, nullptr, store, nullptr, nullptr, jlist, jcount, jslot, scale,
      nullptr, nullptr, lse1, G, H, N, D, 0, n_i, W, S, metric, sqrt_d, 0, 0u,
      1.f, stream);
}

// B5c: B5 over the compact store, the bias in the same slots,
// f32[G, S, 64, 64].
extern "C" int tagan_flash_biased_fwd_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* lse1, const void* jlist, const void* jcount,
    const void* jslot, const void* scale, const void* seeds, void* out,
    void* lse2, int G, int H, int N, int D, int Dv, int n_i, int W, int S,
    int packed, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
  using namespace tagan_flash;
  return (packed ? launch<true, COMPACT_BITS> : launch<true, COMPACT_I8>)(
      q, k, v, store, bias, lse1, jlist, jcount, jslot, scale, seeds, out,
      lse2, G, H, N, D, Dv, n_i, W, S, metric, sqrt_d, use_dropout,
      keep_thresh, inv_keep, stream);
}

// B4c's bf16 form: the same arguments.
extern "C" int tagan_flash_lse1_compact_bf16(
    const void* q, const void* k, const void* store, const void* jlist,
    const void* jcount, const void* jslot, const void* scale, void* lse1,
    int G, int H, int N, int D, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, void* stream) {
  using namespace tagan_flash;
  return (packed ? launch<false, COMPACT_BITS, true>
                 : launch<false, COMPACT_I8, true>)(
      q, k, nullptr, store, nullptr, nullptr, jlist, jcount, jslot, scale,
      nullptr, nullptr, lse1, G, H, N, D, 0, n_i, W, S, metric, sqrt_d, 0, 0u,
      1.f, stream);
}

// B5c's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_fwd_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* lse1, const void* jlist, const void* jcount,
    const void* jslot, const void* scale, const void* seeds, void* out,
    void* lse2, int G, int H, int N, int D, int Dv, int n_i, int W, int S,
    int packed, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
  using namespace tagan_flash;
  return (packed ? launch<true, COMPACT_BITS, true>
                 : launch<true, COMPACT_I8, true>)(
      q, k, v, store, bias, lse1, jlist, jcount, jslot, scale, seeds, out,
      lse2, G, H, N, D, Dv, n_i, W, S, metric, sqrt_d, use_dropout,
      keep_thresh, inv_keep, stream);
}
