// Edge-biased geometric attention, the first softmax's logsumexp, over the
// compact occupied-block store, for Hopper (sm_90a): one tile kernel.
//
// Replaces the Pallas TPU kernel of tagan_tpu/ops/pallas/flash_geometric.py
// that serves the double softmax's first walk (_lse1_kernel, host side
// _flash_biased_forward) in its compact occupied-block form (B4c:
// hybrid_biased.py _band_lse1) and its bf16 form (bf16=True). For each
// query row i and head h, over the valid keys j (mask[i, j] != 0), with
// s_ij the metric score:
//
//   B4c  _band_lse1          lse1_i = logsumexp_j s_ij
//
// with lse = 1e30 on rows that have no valid key. The dense-mask form, B4
// in both precisions, and the second walk, B5 and its compact form B5c,
// are pair walks (flash_pairwalk_fwd.cu, flash_pairwalk_fwd_compact.cu).
//
// Design. One thread block per (64-row query tile, head, folded batch
// index g) walks jlist[g, tile, :jcount[g, tile]]: it stages its Q tile
// once and each step's K tile in shared memory (odd row stride, so the
// 16 lanes of a row group read K without bank conflicts), loads the
// step's mask tile from its store slot as 64 row words, and keeps each
// row's running max and sum in registers. 256 threads: thread (rg, c)
// owns query rows 4*rg..4*rg+3 and keys c + 16*b (b < 4) of each step;
// a row's max and sum reduce over its 16 lanes by shuffles.
//
// What bounds it on the H100. The least traffic is the store's occupied
// tiles, read once, with q and k. The walk spends fp32 instructions on
// every pair of every walked 64x64 tile, once per head, and reads the mask
// tile once per head: at the band's ~61 valid pairs a walked tile, 68
// times the valid work. The compact forward pair walk keeps a mode for it (its LSE
// mode), not built yet.
//
// The bf16 form (kBf16; the TPU kernel's bf16=True) rounds the q and k
// tiles in place once their norms are taken, as the pair walks' bf16
// forms round q and k after theirs. The
// norms, the running max and the sum stay fp32; the result depends on no
// walk.
//
// The walk reads the mask tile from the store slot of each walk step
// (flash_geometric_common.cuh). At the hybrid band this is the band's own
// lse1, which the host merges with the residual's.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_geometric_common.cuh"

namespace {

using namespace tagan_flash;

constexpr int ROWS = BM / 16;     // query rows per thread
constexpr int COLS = BN / 16;     // keys per thread and step

// Shared floats of one block: Q, K, |q|^2 and |k|^2.
__host__ inline size_t smem_floats(int D) {
  return (size_t)(BM + BN) * (D + 1) + BM + BN;
}

template <int kForm, bool kBf16>
__global__ void __launch_bounds__(THREADS)
lse1_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const void* __restrict__ mask, const int* __restrict__ jlist,
            const int* __restrict__ jcount, const int* __restrict__ jslot,
            const float* __restrict__ scale, float* __restrict__ lse_out,
            int H, int N, int D, int n_i, int W, int S, int metric,
            float sqrt_d) {
  const int ib = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1;        // odd row stride: no bank conflicts on K

  extern __shared__ float smem[];
  float* Qs = smem;            // [BM][DS]
  float* Ks = Qs + BM * DS;    // [BN][DS]
  float* qn_s = Ks + BN * DS;  // [BM]
  float* kn_s = qn_s + BM;     // [BN]
  __shared__ uint64_t mrow[BM];  // the step's mask tile

  const size_t gh = (size_t)g * H + h;
  const float* qg = q + gh * N * D;
  const float* kg = k + gh * N * D;
  const int row0 = ib * BM;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D, gr = row0 + r;
    Qs[r * DS + d] = gr < N ? qg[(size_t)gr * D + d] : 0.f;
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
  float m_i[ROWS], l_i[ROWS];
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    m_i[a] = NEG_INF;
    l_i[a] = 0.f;
  }

  const int cnt = jcount[(size_t)g * n_i + ib];
  const int* jl = jlist + ((size_t)g * n_i + ib) * W;
  const int* js = jslot + ((size_t)g * n_i + ib) * W;
  for (int t = 0; t < cnt; ++t) {
    const int col0 = jl[t] * BN;
    __syncthreads();  // the previous step is done with Ks and mrow
    load_mask_tile<kForm>(mrow, mask, (size_t)g * S + js[t]);
    for (int idx = tid; idx < BN * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D, gc = col0 + r;
      Ks[r * DS + d] = gc < N ? kg[(size_t)gc * D + d] : 0.f;
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
        if (pair_on<kForm>(nullptr, mrow, N, gr, gc, lr, lc))
          val = score_of(metric, s[a][b], qn_s[lr], kn_s[lc], sc, sqrt_d);
        s[a][b] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // A row that has seen no valid key yet keeps m == NEG_INF and sums
      // p == 1 garbage, washed out by alpha == 0 once a valid key arrives;
      // a row that stays dead is written LSE_DEAD at the end.
      const float m_new = fmaxf(m_i[a], mx);
      const float alpha = expf(m_i[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < COLS; ++b) rs += expf(s[a][b] - m_new);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_i[a] = l_i[a] * alpha + rs;
      m_i[a] = m_new;
    }
  }

#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    const int gr = row0 + rg * ROWS + a;
    if (gr >= N) continue;
    const bool dead = m_i[a] <= NEG_INF;
    if (lane == 0)
      lse_out[gh * N + gr] = dead ? LSE_DEAD : m_i[a] + logf(l_i[a]);
  }
}

template <int kForm, bool kBf16 = false>
int launch(const void* q, const void* k, const void* mask, const void* jlist,
           const void* jcount, const void* jslot, const void* scale,
           void* lse_out, int G, int H, int N, int D, int n_i, int W, int S,
           int metric, float sqrt_d, void* stream) {
  if (G < 0 || H < 0 || N < 0 || D < 1 || D > MAX_D || metric < 0 ||
      metric > COS_DIST || n_i != (N + BM - 1) / BM || W < 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const size_t smem = sizeof(float) * smem_floats(D);
  if (smem > 48 * 1024 - sizeof(uint64_t) * BM) {
    const cudaError_t e = cudaFuncSetAttribute(
        lse1_kernel<kForm, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_i, H, G);
  lse1_kernel<kForm, kBf16><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, mask, (const int*)jlist,
      (const int*)jcount, (const int*)jslot, (const float*)scale,
      (float*)lse_out, H, N, D, n_i, W, S, metric, sqrt_d);
  return (int)cudaGetLastError();
}

}  // namespace

// B4c: lse1 over the compact store (bits i64[G, S, 64] when packed, else
// int8 [G, S, 64, 64]) with the slot of each walk step, jslot [G, n_i, W].
extern "C" int tagan_flash_lse1_compact(
    const void* q, const void* k, const void* store, const void* jlist,
    const void* jcount, const void* jslot, const void* scale, void* lse1,
    int G, int H, int N, int D, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, void* stream) {
  using namespace tagan_flash;
  return (packed ? launch<COMPACT_BITS> : launch<COMPACT_I8>)(
      q, k, store, jlist, jcount, jslot, scale, lse1, G, H, N, D, n_i, W, S,
      metric, sqrt_d, stream);
}

// B4c's bf16 form: the same arguments.
extern "C" int tagan_flash_lse1_compact_bf16(
    const void* q, const void* k, const void* store, const void* jlist,
    const void* jcount, const void* jslot, const void* scale, void* lse1,
    int G, int H, int N, int D, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, void* stream) {
  using namespace tagan_flash;
  return (packed ? launch<COMPACT_BITS, true> : launch<COMPACT_I8, true>)(
      q, k, store, jlist, jcount, jslot, scale, lse1, G, H, N, D, n_i, W, S,
      metric, sqrt_d, stream);
}
