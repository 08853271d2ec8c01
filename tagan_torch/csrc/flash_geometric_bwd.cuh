// The two-walk backward's kernels over the dense mask (B3a: dq; B3b: dk
// and dv), their launchers and their entry templates, in both precisions
// (documented in flash_geometric_bwd.cu, which includes this file). The
// compact forms B3a c and B3b c are the pair walks of
// flash_pairwalk_bwd_compact.cu. The dq kernel keeps its mask-form
// parameter and the compact forms' arguments (jslot, S), instantiated for
// DENSE_MASK alone: without them ptxas spilled its LANES = 8 forms.

#pragma once

#include "flash_geometric_common.cuh"

namespace {

using namespace tagan_flash;

// The mask of batch index g: the dense [N, N] bytes.
template <int kForm>
__device__ __forceinline__ const uint8_t* dense_mask(const void* mask, int g,
                                                     int N) {
  static_assert(kForm == DENSE_MASK, "the dense mask alone");
  return static_cast<const uint8_t*>(mask) + (size_t)g * N * N;
}

template <int LANES, int kForm, bool kBf16>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const void* __restrict__ mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ jlist,
                    const int* __restrict__ jcount,
                    const int* __restrict__ jslot,
                    const float* __restrict__ scale,
                    const int* __restrict__ seed, float* __restrict__ dq,
                    float* __restrict__ dscale_part, int H, int N, int D,
                    int Dv, int n_i, int W, int S, int metric, float sqrt_d,
                    int use_dropout, uint32_t keep_thresh, float inv_keep,
                    int need_dscale) {
  const int ib = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1, PS = BN + 1;
  extern __shared__ float smem[];
  const BwdTiles t = bwd_tiles(smem, D, Dv);

  const size_t gh = (size_t)g * H + h;
  const float* qg = q + gh * N * D;
  const float* kg = k + gh * N * D;
  const float* vg = v + gh * N * Dv;
  const uint8_t* mg = dense_mask<kForm>(mask, g, N);
  const int row0 = ib * BM;
  load_query_side<kBf16>(t, qg, dout + gh * N * Dv, lse + gh * N,
                         delta + gh * N, row0, N, D, Dv);
  __syncthreads();
  tile_norms<kBf16>(t, D, true, false);

  const float sc = scale[h];
  const uint32_t mix = (uint32_t)seed[g] ^ ((uint32_t)h * 0xC2B2AE3Du);
  float acc[4][LANES], wsum[4];
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
  for (int step = 0; step < cnt; ++step) {
    const int col0 = jl[step] * BN;
    __syncthreads();  // the previous step is done with Ks, Vs and Ws
    load_rows(t.Ks, kg, col0, N, D);
    load_rows<kBf16>(t.Vs, vg, col0, N, Dv);
    __syncthreads();
    tile_norms<kBf16>(t, D, false, true);
    __syncthreads();
    dsc += pair_weights<false, kForm, kBf16>(t, mg, nullptr, N, D, Dv, row0,
                                             col0, metric, sc, sqrt_d,
                                             use_dropout, mix, keep_thresh,
                                             inv_keep);
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
    if (tid == 0)
      dscale_part[gh * n_i + ib] = s * dscale_factor(metric, sc);
  }
}

template <int LANES, bool kBf16>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ ilist,
                     const int* __restrict__ icount,
                     const float* __restrict__ scale,
                     const int* __restrict__ seed, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int N, int D, int Dv,
                     int n_j, int W, int metric, float sqrt_d,
                     int use_dropout, uint32_t keep_thresh, float inv_keep) {
  const int jb = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1, VS = Dv + 1, PS = BN + 1;
  extern __shared__ float smem[];
  const BwdTiles t = bwd_tiles(smem, D, Dv);

  const size_t gh = (size_t)g * H + h;
  const float* qg = q + gh * N * D;
  const float* dog = dout + gh * N * Dv;
  const float* kg = k + gh * N * D;
  const uint8_t* mg = mask + (size_t)g * N * N;
  const int col0 = jb * BN;
  load_rows(t.Ks, kg, col0, N, D);
  load_rows<kBf16>(t.Vs, v + gh * N * Dv, col0, N, Dv);
  __syncthreads();
  tile_norms<kBf16>(t, D, false, true);

  const float sc = scale[h];
  const uint32_t mix = (uint32_t)seed[g] ^ ((uint32_t)h * 0xC2B2AE3Du);
  float dka[4][LANES], dva[4][LANES], wsum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    wsum[a] = 0.f;
#pragma unroll
    for (int jj = 0; jj < LANES; ++jj) dka[a][jj] = dva[a][jj] = 0.f;
  }

  const size_t walk = (size_t)g * n_j + jb;
  const int cnt = icount[walk];
  const int* il = ilist + walk * W;
  for (int step = 0; step < cnt; ++step) {
    const int row0 = il[step] * BM;
    __syncthreads();  // the previous step is done with Qs, dOs, Ws and Ps
    load_query_side<kBf16>(t, qg, dog, lse + gh * N, delta + gh * N, row0, N,
                           D, Dv);
    __syncthreads();
    tile_norms<kBf16>(t, D, true, false);
    __syncthreads();
    pair_weights<true, DENSE_MASK, kBf16>(t, mg, nullptr, N, D, Dv, row0,
                                          col0, metric, sc, sqrt_d,
                                          use_dropout, mix, keep_thresh,
                                          inv_keep);
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
              int metric) {
  return G < 0 || H < 0 || N < 0 || D < 1 || D > MAX_D || Dv < 1 ||
         Dv > MAX_D || metric < 0 || metric > COS_DIST ||
         n_tiles != (N + BM - 1) / BM || W < 0;
}

// Dynamic shared memory: the tiles.
template <int kForm, bool kBf16>
size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * bwd_smem_floats(D, Dv);
}

template <int LANES, int kForm, bool kBf16>
cudaError_t launch_dq(const dim3& grid, cudaStream_t stream, const void* q,
                      const void* k, const void* v, const void* mask,
                      const void* dout, const void* lse, const void* delta,
                      const void* jlist, const void* jcount,
                      const void* jslot, const void* scale, const void* seed,
                      void* dq, void* dscale_part, int H, int N, int D,
                      int Dv, int n_i, int W, int S, int metric, float sqrt_d,
                      int use_dropout, unsigned int thresh, float inv_keep,
                      int need_dscale) {
  const size_t smem = smem_bytes<kForm, kBf16>(D, Dv);
  const cudaError_t e =
      prepare(flash_bwd_dq_kernel<LANES, kForm, kBf16>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<LANES, kForm, kBf16><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, mask,
      (const float*)dout, (const float*)lse, (const float*)delta,
      (const int*)jlist, (const int*)jcount, (const int*)jslot,
      (const float*)scale, (const int*)seed, (float*)dq,
      (float*)dscale_part, H, N, D, Dv, n_i, W, S, metric, sqrt_d,
      use_dropout, thresh, inv_keep, need_dscale);
  return cudaGetLastError();
}

template <int LANES, bool kBf16>
cudaError_t launch_dkv(const dim3& grid, cudaStream_t stream, const void* q,
                       const void* k, const void* v, const void* mask,
                       const void* dout, const void* lse, const void* delta,
                       const void* ilist, const void* icount,
                       const void* scale, const void* seed, void* dk,
                       void* dv, int H, int N, int D, int Dv, int n_j, int W,
                       int metric, float sqrt_d, int use_dropout,
                       unsigned int thresh, float inv_keep) {
  const size_t smem = smem_bytes<DENSE_MASK, kBf16>(D, Dv);
  const cudaError_t e = prepare(flash_bwd_dkv_kernel<LANES, kBf16>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<LANES, kBf16><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (const float*)dout, (const float*)lse,
      (const float*)delta, (const int*)ilist, (const int*)icount,
      (const float*)scale, (const int*)seed, (float*)dk, (float*)dv, H, N,
      D, Dv, n_j, W, metric, sqrt_d, use_dropout, thresh, inv_keep);
  return cudaGetLastError();
}

template <int kForm, bool kBf16 = false>
int dq_entry(const void* q, const void* k, const void* v, const void* mask,
             const void* dout, const void* lse, const void* delta,
             const void* jlist, const void* jcount, const void* jslot,
             const void* scale, const void* seed, void* dq,
             void* dscale_part, int G, int H, int N, int D, int Dv, int n_i,
             int W, int S, int metric, float sqrt_d, int use_dropout,
             unsigned int keep_thresh, float inv_keep, int need_dscale,
             void* stream) {
  if (bad_args(G, H, N, D, Dv, n_i, W, metric))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const dim3 grid(n_i, H, G);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_for(D)) {
#define TAGAN_DQ(L)                                                           \
  case L:                                                                     \
    return (int)launch_dq<L, kForm, kBf16>(                                   \
        grid, s, q, k, v, mask, dout, lse, delta, jlist, jcount, jslot,       \
        scale, seed, dq, dscale_part, H, N, D, Dv, n_i, W, S, metric, sqrt_d, \
        use_dropout, keep_thresh, inv_keep, need_dscale);
    TAGAN_DQ(1) TAGAN_DQ(2) TAGAN_DQ(4) TAGAN_DQ(8)
#undef TAGAN_DQ
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kBf16 = false>
int dkv_entry(const void* q, const void* k, const void* v, const void* mask,
              const void* dout, const void* lse, const void* delta,
              const void* ilist, const void* icount, const void* scale,
              const void* seed, void* dk, void* dv, int G, int H, int N,
              int D, int Dv, int n_j, int W, int metric, float sqrt_d,
              int use_dropout, unsigned int keep_thresh, float inv_keep,
              void* stream) {
  if (bad_args(G, H, N, D, Dv, n_j, W, metric))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const dim3 grid(n_j, H, G);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_for(D > Dv ? D : Dv)) {
#define TAGAN_DKV(L)                                                       \
  case L:                                                                  \
    return (int)launch_dkv<L, kBf16>(                                      \
        grid, s, q, k, v, mask, dout, lse, delta, ilist, icount, scale,    \
        seed, dk, dv, H, N, D, Dv, n_j, W, metric, sqrt_d, use_dropout,    \
        keep_thresh, inv_keep);
    TAGAN_DKV(1) TAGAN_DKV(2) TAGAN_DKV(4) TAGAN_DKV(8)
#undef TAGAN_DKV
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
