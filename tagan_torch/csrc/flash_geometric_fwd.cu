// Block-sparse edge-masked geometric attention, forward, over the compact
// occupied-block store, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tagan_tpu/ops/pallas/flash_geometric.py::
// _flash_kernel (host side _flash_forward) in its compact occupied-block
// form (B1c, _flash_forward with a 3-tuple plan) and B1c's bf16 form
// (bf16=True). The dense-mask forms, B1 and B1 bf16, are the pair walks
// of flash_pairwalk_fwd.cu:
// for each query row i and head h,
//
//     s_ij  = metric score from q_i.k_j and the row norms (8 metrics)
//     w_ij  = softmax_j over {j : mask[i, j] != 0} of s_ij
//     out_i = sum_j drop(w_ij) v_j,   lse_i = logsumexp_j s_ij
//
// with out = 0 and lse = 1e30 on rows that have no valid key. The dropout keep
// mask is the JAX package's coordinate hash (_keep_mask), bit for bit, and
// the softmax denominator is the un-dropped sum.
//
// Design. One thread block per (64-row query tile, head, folded batch index
// g); the model folds snapshots and sequences into g, so one launch serves a
// whole attention layer. The block walks jlist[g, tile, :jcount[g, tile]],
// the occupied 64-key blocks of its query tile (the mask tile read from the
// store slot jslot[g, tile, t]), staging K and V tiles in
// shared memory and keeping the running max, sum and output accumulator in
// registers (the online-softmax recurrence of the TPU kernel's VMEM
// scratch). 256 threads: thread (rg, c) owns query rows 4*rg..4*rg+3, keys
// c + 16*b (b < 4) of each step, and output columns c + 16*jj. Row max and
// sum reduce across the 16 lanes of a half warp with shuffles.
//
// What differs from the TPU kernel, and why:
//  - No padding. The TPU kernel pads N to its block size and the feature
//    dims to 128 lanes (its layout rule); here q/k keep their true D and v
//    its Dv (they differ under mahalanobis), and the ragged edge of N is
//    masked in the kernel, so the [N, N] mask is never copied.
//  - The repeat-last padding of jlist exists for the TPU pipeline's DMA
//    dedup; here jcount bounds the loop.
//  - Scores and P@V run in fp32 on the CUDA cores, not the tensor cores.
//  - The bf16 form (kBf16) rounds the q and k tiles in shared memory once
//    their row norms are taken (nothing else reads them), v as its tile is
//    staged (v enters nothing but P@V), and the dropped p as it is stored
//    for P@V; the running max, the un-dropped sum and the norms stay fp32,
//    as in the TPU kernel. p is rounded relative to the running
//    max after each key tile, so the result depends on the walk, as the
//    TPU kernel's does on its block size.
//  - The mask tile of each step is read from the store slot
//    jslot[g, tile, t] (flash_geometric_common.cuh: int8 tiles or 64 uint64
//    row words; the TPU's interleaved byte packing is a pltpu.repeat rule
//    and is not carried over).
//
// The compact form at the hybrid band (131,072 nodes, a band of +-512 slots):
// ~18 of 2,048 key tiles per row tile are occupied, and all of a walked
// tile's pairs are near-diagonal band pairs or empty, so the walk visits
// ~37K tiles per head where the valid pairs fill ~1/2 of them; the store
// (512 bytes a tile as bits) is read once per head.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_geometric_common.cuh"

namespace {

using namespace tagan_flash;

constexpr int ROWS = BM / 16;     // query rows per thread
constexpr int COLS = BN / 16;     // keys per thread and step
constexpr int MAX_DV_LANES = 8;   // output columns per thread: Dv <= 128

template <int kForm, bool kBf16>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const void* __restrict__ mask,
                 const int* __restrict__ jlist,
                 const int* __restrict__ jcount,
                 const int* __restrict__ jslot,
                 const float* __restrict__ scale,
                 const int* __restrict__ seed,
                 float* __restrict__ out, float* __restrict__ lse,
                 int H, int N, int D, int Dv, int n_i, int W, int S,
                 int metric, float sqrt_d, int use_dropout,
                 uint32_t keep_thresh, float inv_keep) {
  const int ib = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1;        // odd row stride: no bank conflicts on K
  const int PS = BN + 1;

  extern __shared__ float smem[];
  float* Qs = smem;            // [BM][DS]
  float* Ks = Qs + BM * DS;    // [BN][DS]
  float* Vs = Ks + BN * DS;    // [BN][Dv]
  float* Ps = Vs + BN * Dv;    // [BM][PS]
  float* qn_s = Ps + BM * PS;  // [BM]
  float* kn_s = qn_s + BM;     // [BN]
  __shared__ uint64_t mrow[BM];  // the step's mask tile

  const size_t gh = (size_t)g * H + h;
  const float* qg = q + gh * N * D;
  const float* kg = k + gh * N * D;
  const float* vg = v + gh * N * Dv;
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
  const uint32_t mix = (uint32_t)seed[g] ^ ((uint32_t)h * 0xC2B2AE3Du);
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
    load_mask_tile<kForm>(mrow, mask, (size_t)g * S + js[t]);
    for (int idx = tid; idx < BN * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D, gc = col0 + r;
      Ks[r * DS + d] = gc < N ? kg[(size_t)gc * D + d] : 0.f;
    }
    for (int idx = tid; idx < BN * Dv; idx += THREADS) {
      const int r = idx / Dv, d = idx - r * Dv, gc = col0 + r;
      Vs[idx] = rd<kBf16>(gc < N ? vg[(size_t)gc * Dv + d] : 0.f);
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
        const bool ok = pair_on<kForm>(nullptr, mrow, N, gr, gc, lr, lc);
        const float val = ok ? score_of(metric, s[a][b], qn_s[lr], kn_s[lc],
                                        sc, sqrt_d)
                             : NEG_INF;
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
        const int lc = lane + 16 * b;
        float p = expf(s[a][b] - m_new);
        rs += p;
        if (use_dropout) {
          const bool keep =
              keep_hash(mix, (uint32_t)gr, (uint32_t)(col0 + lc)) < keep_thresh;
          p = keep ? p * inv_keep : 0.f;
        }
        Ps[lr * PS + lc] = rd<kBf16>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_i[a] = l_i[a] * alpha + rs;
      m_i[a] = m_new;
#pragma unroll
      for (int jj = 0; jj < MAX_DV_LANES; ++jj) acc[a][jj] *= alpha;
    }
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
          for (int a = 0; a < ROWS; ++a) acc[a][jj] = fmaf(pv[a], vv, acc[a][jj]);
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
    float* og = out + (gh * N + gr) * Dv;
#pragma unroll
    for (int jj = 0; jj < MAX_DV_LANES; ++jj) {
      const int dv = lane + 16 * jj;
      if (jj < n_lanes && dv < Dv) og[dv] = dead ? 0.f : acc[a][jj] / l;
    }
    if (lane == 0) lse[gh * N + gr] = dead ? LSE_DEAD : m_i[a] + logf(l);
  }
}

template <int kForm, bool kBf16 = false>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* jlist, const void* jcount, const void* jslot,
           const void* scale, const void* seed, void* out, void* lse, int G,
           int H, int N, int D, int Dv, int n_i, int W, int S, int metric,
           float sqrt_d, int use_dropout, unsigned int keep_thresh,
           float inv_keep, void* stream) {
  if (G < 0 || H < 0 || N < 0 || D < 1 || D > MAX_D || Dv < 1 ||
      Dv > 16 * MAX_DV_LANES || metric < 0 || metric > COS_DIST ||
      n_i != (N + BM - 1) / BM || W < 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const size_t smem =
      sizeof(float) * ((size_t)(BM + BN) * (D + 1) + (size_t)BN * Dv +
                       (size_t)BM * (BN + 1) + BM + BN);
  if (smem > 48 * 1024 - sizeof(uint64_t) * BM) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<kForm, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_i, H, G);
  flash_fwd_kernel<kForm, kBf16>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, mask,
      (const int*)jlist, (const int*)jcount, (const int*)jslot,
      (const float*)scale, (const int*)seed, (float*)out, (float*)lse, H, N,
      D, Dv, n_i, W, S, metric, sqrt_d, use_dropout, keep_thresh, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// B1c: the compact store of S slots per g, bits i64[G, S, 64] (packed) or
// int8 [G, S, 64, 64], and the slot of each walk step, jslot [G, n_i, W].
extern "C" int tagan_flash_geometric_fwd_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* jlist, const void* jcount, const void* jslot,
    const void* scale, const void* seed, void* out, void* lse, int G, int H,
    int N, int D, int Dv, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  using namespace tagan_flash;
  return (packed ? launch<COMPACT_BITS> : launch<COMPACT_I8>)(
      q, k, v, store, jlist, jcount, jslot, scale, seed, out, lse, G, H, N,
      D, Dv, n_i, W, S, metric, sqrt_d, use_dropout, keep_thresh, inv_keep,
      stream);
}

// B1c's bf16 form: the same arguments.
extern "C" int tagan_flash_geometric_fwd_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* jlist, const void* jcount, const void* jslot,
    const void* scale, const void* seed, void* out, void* lse, int G, int H,
    int N, int D, int Dv, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  using namespace tagan_flash;
  return (packed ? launch<COMPACT_BITS, true> : launch<COMPACT_I8, true>)(
      q, k, v, store, jlist, jcount, jslot, scale, seed, out, lse, G, H, N,
      D, Dv, n_i, W, S, metric, sqrt_d, use_dropout, keep_thresh, inv_keep,
      stream);
}
