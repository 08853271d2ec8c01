// Block-sparse edge-masked geometric attention, two-walk backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels tagan_tpu/ops/pallas/flash_geometric.py::
// _flash_bwd_dq_kernel (B3a) and _flash_bwd_dkv_kernel (B3b), host side
// flash_geometric_attention_bwd with fused=False. For query row i, key j,
// head h, with p_ij = exp(s_ij - lse_i) on the mask,
//
//     dp_ij = drop(do_i . v_j),   ds_ij = p_ij (dp_ij - delta_i)
//     dq_i  = sum_j W_ij k_j,     dk_j = sum_i W_ij q_i,
//     dv_j  = sum_i drop(p_ij) do_i
//
// where W is the metric's chain weight (flash_geometric_common.cuh:
// chain_weight; the squared-distance metrics also subtract
// (sum_j W_ij) q_i and (sum_i W_ij) k_j) and delta_i = do_i . out_i - dlse_i
// comes from the caller. The dropout keep bits are the forward's hash on
// global (row, col, head) coordinates, so both walks see the forward's mask.
//
// Design. B3a: one thread block per (64-row query tile, head, folded index
// g), walking jlist[g, tile, :jcount] as the forward does; the query tile,
// its dO, lse and delta stay in shared memory, dq accumulates in registers,
// and a d(scale) partial per block goes to [G, H, n_i] (summed by the
// caller). B3b: one block per (64-key tile, head, g), walking the
// transposed plan ilist[g, tile, :icount]; dk and dv accumulate in
// registers. Both are deterministic: every output element is written by
// one block in a fixed order. A key strip or query tile with an empty walk
// writes zeros. Thread (rg, lane) recomputes the 4 x 4 pairs of B1's
// layout; the accumulators are templated on the 16-wide feature lanes
// (D, Dv <= 16, 32, 64 or 128) so head dim 16 holds one lane.
//
// What bounds it on the H100. The work the data needs is ~5 products of
// head dim per valid pair; what must move is q, k, v, do, lse, delta, the
// dense int8 [N, N] mask and dq, dk, dv, so the least time is the mask's
// bytes over the memory rate. With uniformly random edges nearly every
// 64 x 64 block is occupied and both walks visit ~N^2 pairs per head, so
// like B1 the kernels are bound by fp32 issue on the CUDA cores, far above
// that bound. At the model's shape (one snapshot, H=4, N=10,000, head dim
// 16) the bound is 0.034 ms for each kernel (~113-116 MB at 3.35 TB/s);
// chip_smoke.py phase 5 times both kernels against it. Tensor cores, TMA
// and a walk over edges are later steps.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_geometric_common.cuh"

namespace {

using namespace tagan_flash;

template <int LANES>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ jlist,
                    const int* __restrict__ jcount,
                    const float* __restrict__ scale,
                    const int* __restrict__ seed, float* __restrict__ dq,
                    float* __restrict__ dscale_part, int H, int N, int D,
                    int Dv, int n_i, int W, int metric, float sqrt_d,
                    int use_dropout, uint32_t keep_thresh, float inv_keep,
                    int need_dscale) {
  const int ib = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1, PS = BN + 1;
  extern __shared__ float smem[];
  const BwdTiles t = bwd_tiles(smem, D, Dv);

  const size_t gh = (size_t)g * H + h;
  const float* kg = k + gh * N * D;
  const float* vg = v + gh * N * Dv;
  const uint8_t* mg = mask + (size_t)g * N * N;
  const int row0 = ib * BM;
  load_query_side(t, q + gh * N * D, dout + gh * N * Dv, lse + gh * N,
                  delta + gh * N, row0, N, D, Dv);
  __syncthreads();
  tile_norms(t, D, true, false);

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

  const int cnt = jcount[(size_t)g * n_i + ib];
  const int* jl = jlist + ((size_t)g * n_i + ib) * W;
  for (int step = 0; step < cnt; ++step) {
    const int col0 = jl[step] * BN;
    __syncthreads();  // the previous step is done with Ks, Vs and Ws
    load_rows(t.Ks, kg, col0, N, D);
    load_rows(t.Vs, vg, col0, N, Dv);
    __syncthreads();
    tile_norms(t, D, false, true);
    __syncthreads();
    dsc += pair_weights<false>(t, mg, N, D, Dv, row0, col0, metric, sc,
                               sqrt_d, use_dropout, mix, keep_thresh,
                               inv_keep);
    __syncthreads();
    for (int j = 0; j < BN; ++j) {
      float w[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        w[a] = t.Ws[(rg * 4 + a) * PS + j];
        wsum[a] += w[a];
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
        o[d] = sqm ? acc[a][jj] - wsum[a] * t.Qs[lr * DS + d] : acc[a][jj];
    }
  }
  if (need_dscale) {
    const float s = block_sum(dsc, t.red);
    if (tid == 0)
      dscale_part[gh * n_i + ib] = s * dscale_factor(metric, sc);
  }
}

template <int LANES>
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
  const uint8_t* mg = mask + (size_t)g * N * N;
  const int col0 = jb * BN;
  load_rows(t.Ks, k + gh * N * D, col0, N, D);
  load_rows(t.Vs, v + gh * N * Dv, col0, N, Dv);
  __syncthreads();
  tile_norms(t, D, false, true);

  const float sc = scale[h];
  const uint32_t mix = (uint32_t)seed[g] ^ ((uint32_t)h * 0xC2B2AE3Du);
  float dka[4][LANES], dva[4][LANES], wsum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    wsum[a] = 0.f;
#pragma unroll
    for (int jj = 0; jj < LANES; ++jj) dka[a][jj] = dva[a][jj] = 0.f;
  }

  const int cnt = icount[(size_t)g * n_j + jb];
  const int* il = ilist + ((size_t)g * n_j + jb) * W;
  for (int step = 0; step < cnt; ++step) {
    const int row0 = il[step] * BM;
    __syncthreads();  // the previous step is done with Qs, dOs, Ws and Ps
    load_query_side(t, qg, dog, lse + gh * N, delta + gh * N, row0, N, D,
                    Dv);
    __syncthreads();
    tile_norms(t, D, true, false);
    __syncthreads();
    pair_weights<true>(t, mg, N, D, Dv, row0, col0, metric, sc, sqrt_d,
                       use_dropout, mix, keep_thresh, inv_keep);
    __syncthreads();
    for (int i = 0; i < BM; ++i) {
      float w[4], p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        w[a] = t.Ws[i * PS + rg * 4 + a];
        p[a] = t.Ps[i * PS + rg * 4 + a];
        wsum[a] += w[a];
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
        ok[d] = sqm ? dka[a][jj] - wsum[a] * t.Ks[lc * DS + d] : dka[a][jj];
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

template <int LANES>
cudaError_t launch_dq(const dim3& grid, size_t smem, cudaStream_t stream,
                      const void* q, const void* k, const void* v,
                      const void* mask, const void* dout, const void* lse,
                      const void* delta, const void* jlist,
                      const void* jcount, const void* scale,
                      const void* seed, void* dq, void* dscale_part, int H,
                      int N, int D, int Dv, int n_i, int W, int metric,
                      float sqrt_d, int use_dropout, unsigned int thresh,
                      float inv_keep, int need_dscale) {
  const cudaError_t e = prepare(flash_bwd_dq_kernel<LANES>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<LANES><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (const float*)dout, (const float*)lse,
      (const float*)delta, (const int*)jlist, (const int*)jcount,
      (const float*)scale, (const int*)seed, (float*)dq,
      (float*)dscale_part, H, N, D, Dv, n_i, W, metric, sqrt_d,
      use_dropout, thresh, inv_keep, need_dscale);
  return cudaGetLastError();
}

template <int LANES>
cudaError_t launch_dkv(const dim3& grid, size_t smem, cudaStream_t stream,
                       const void* q, const void* k, const void* v,
                       const void* mask, const void* dout, const void* lse,
                       const void* delta, const void* ilist,
                       const void* icount, const void* scale,
                       const void* seed, void* dk, void* dv, int H, int N,
                       int D, int Dv, int n_j, int W, int metric,
                       float sqrt_d, int use_dropout, unsigned int thresh,
                       float inv_keep) {
  const cudaError_t e = prepare(flash_bwd_dkv_kernel<LANES>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<LANES><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (const float*)dout, (const float*)lse,
      (const float*)delta, (const int*)ilist, (const int*)icount,
      (const float*)scale, (const int*)seed, (float*)dk, (float*)dv, H, N,
      D, Dv, n_j, W, metric, sqrt_d, use_dropout, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// dq [G, H, N, D] and, with need_dscale, the d(scale) partials
// [G, H, n_i] of the forward walk (jlist, jcount).
extern "C" int tagan_flash_geometric_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* scale, const void* seed, void* dq,
    void* dscale_part, int G, int H, int N, int D, int Dv, int n_i, int W,
    int metric, float sqrt_d, int use_dropout, unsigned int keep_thresh,
    float inv_keep, int need_dscale, void* stream) {
  if (bad_args(G, H, N, D, Dv, n_i, W, metric))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const size_t smem = sizeof(float) * bwd_smem_floats(D, Dv);
  const dim3 grid(n_i, H, G);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_for(D)) {
#define TAGAN_DQ(L)                                                          \
  case L:                                                                    \
    return (int)launch_dq<L>(grid, smem, s, q, k, v, mask, dout, lse, delta, \
                             jlist, jcount, scale, seed, dq, dscale_part, H, \
                             N, D, Dv, n_i, W, metric, sqrt_d, use_dropout,  \
                             keep_thresh, inv_keep, need_dscale);
    TAGAN_DQ(1) TAGAN_DQ(2) TAGAN_DQ(4) TAGAN_DQ(8)
#undef TAGAN_DQ
  }
  return (int)cudaErrorInvalidValue;
}

// dk [G, H, N, D] and dv [G, H, N, Dv] over the transposed walk
// (ilist, icount).
extern "C" int tagan_flash_geometric_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* ilist,
    const void* icount, const void* scale, const void* seed, void* dk,
    void* dv, int G, int H, int N, int D, int Dv, int n_j, int W, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  if (bad_args(G, H, N, D, Dv, n_j, W, metric))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const size_t smem = sizeof(float) * bwd_smem_floats(D, Dv);
  const dim3 grid(n_j, H, G);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_for(D > Dv ? D : Dv)) {
#define TAGAN_DKV(L)                                                          \
  case L:                                                                     \
    return (int)launch_dkv<L>(grid, smem, s, q, k, v, mask, dout, lse, delta, \
                              ilist, icount, scale, seed, dk, dv, H, N, D,    \
                              Dv, n_j, W, metric, sqrt_d, use_dropout,        \
                              keep_thresh, inv_keep);
    TAGAN_DKV(1) TAGAN_DKV(2) TAGAN_DKV(4) TAGAN_DKV(8)
#undef TAGAN_DKV
  }
  return (int)cudaErrorInvalidValue;
}
