// Block-sparse edge-masked geometric attention, fused single-walk backward,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tagan_tpu/ops/pallas/flash_geometric.py::
// _flash_bwd_fused_kernel (B2; host side _bwd_fused_call): dq, dk, dv and
// d(scale) from one walk over the transposed plan, so each (query tile, key
// tile) pair is recomputed once instead of twice (the two-walk B3a + B3b in
// flash_geometric_bwd.cu). The math per pair is that of
// flash_geometric_common.cuh: pair_weights and chain_weight. B2's bf16 form
// (bf16=True) is the pair walk of flash_pairwalk_bwd.cu.
//
// Design. One thread block per (64-key tile, head, folded index g), walking
// ilist[g, tile, :icount], the query tiles of its key strip. dk and dv
// accumulate in registers over the walk, as in B3b. dq of a query tile gets
// contributions from every key strip that walks it. The TPU kernel writes
// one dq partial per key strip into an [n_j, H, Np, Dp] buffer, because a
// TPU output block cannot be revisited; at 10,000 nodes that buffer would
// be ~6 GB per layer launch. Here each block adds its partial into a zeroed
// fp32 dq [G, H, N, D] with atomicAdd (four floats at a time where D is a
// multiple of 4), skipping rows whose partial is exactly zero. The order of
// those additions varies from run to run, so dq varies in its last bits;
// dk, dv and the d(scale) partials [G, H, n_j] are deterministic. A key
// strip with an empty walk writes dk = dv = 0.
//
// What bounds it on the H100: as for B3a/B3b (flash_geometric_bwd.cu), the
// dense int8 mask's bytes bound the least time, and the ~N^2 recomputed
// pairs per head of a walk over nearly every block keep the fp32 CUDA
// cores busy far above that bound: 0.035 ms (118 MB at 3.35 TB/s) at the
// model's shape (one snapshot, H=4, N=10,000, head dim 16), which
// chip_smoke.py phase 5 times the kernel against. Against the two walks
// it saves one recompute of s and dp per pair and pays the atomics.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing (dq must be zeroed by the caller), returns the
// cudaError_t of the launch.

#include "flash_geometric_common.cuh"

#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 ||    \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 2))
#define TAGAN_VEC4_ATOMICS 1
#else
#define TAGAN_VEC4_ATOMICS 0
#endif

namespace {

using namespace tagan_flash;

// dq[row0 + r, :] += sum_j W_rj k_j (- (sum_j W_rj) q_r), VEC columns per
// atomic; thread slots cover the 64 x D tile.
template <int VEC>
__device__ __forceinline__ void add_dq_partial(const BwdTiles& t,
                                               float* __restrict__ dqg,
                                               int row0, int N, int D,
                                               int metric) {
  const bool sqm = is_sq_metric(metric);
  const int DS = D + 1, PS = BN + 1, per_row = D / VEC;
  for (int slot = threadIdx.x; slot < BM * per_row; slot += THREADS) {
    const int r = slot / per_row, d0 = (slot - r * per_row) * VEC;
    const int gr = row0 + r;
    float acc[VEC], ws = 0.f;
#pragma unroll
    for (int x = 0; x < VEC; ++x) acc[x] = 0.f;
    for (int j = 0; j < BN; ++j) {
      const float w = t.Ws[r * PS + j];
      ws += w;
#pragma unroll
      for (int x = 0; x < VEC; ++x)
        acc[x] = fmaf(w, t.Ks[j * DS + d0 + x], acc[x]);
    }
    if (gr >= N) continue;
    bool any = false;
#pragma unroll
    for (int x = 0; x < VEC; ++x) {
      acc[x] = sqm ? acc[x] - ws * t.Qs[r * DS + d0 + x] : acc[x];
      any |= acc[x] != 0.f;
    }
    if (!any) continue;
    float* dst = dqg + (size_t)gr * D + d0;
#if TAGAN_VEC4_ATOMICS
    if constexpr (VEC == 4) {
      atomicAdd(reinterpret_cast<float4*>(dst),
                make_float4(acc[0], acc[1], acc[2], acc[3]));
    } else
#endif
    {
#pragma unroll
      for (int x = 0; x < VEC; ++x) atomicAdd(dst + x, acc[x]);
    }
  }
}

template <int LANES, int VEC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_fused_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ ilist,
                       const int* __restrict__ icount,
                       const float* __restrict__ scale,
                       const int* __restrict__ seed, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dscale_part, int H, int N, int D,
                       int Dv, int n_j, int W, int metric, float sqrt_d,
                       int use_dropout, uint32_t keep_thresh, float inv_keep,
                       int need_dscale) {
  const int jb = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1, VS = Dv + 1, PS = BN + 1;
  extern __shared__ float smem[];
  const BwdTiles t = bwd_tiles(smem, D, Dv);

  const size_t gh = (size_t)g * H + h;
  const float* qg = q + gh * N * D;
  const float* dog = dout + gh * N * Dv;
  float* dqg = dq + gh * N * D;
  const uint8_t* mg = mask + (size_t)g * N * N;
  const float* kg = k + gh * N * D;
  const int col0 = jb * BN;
  load_rows(t.Ks, kg, col0, N, D);
  load_rows(t.Vs, v + gh * N * Dv, col0, N, Dv);
  __syncthreads();
  tile_norms(t, D, false, true);

  const float sc = scale[h];
  const uint32_t mix = (uint32_t)seed[g] ^ ((uint32_t)h * 0xC2B2AE3Du);
  const bool sqm = is_sq_metric(metric);
  float dka[4][LANES], dva[4][LANES], wsum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    wsum[a] = 0.f;
#pragma unroll
    for (int jj = 0; jj < LANES; ++jj) dka[a][jj] = dva[a][jj] = 0.f;
  }
  float dsc = 0.f;

  const int cnt = icount[(size_t)g * n_j + jb];
  const int* il = ilist + ((size_t)g * n_j + jb) * W;
  for (int step = 0; step < cnt; ++step) {
    const int row0 = il[step] * BM;
    __syncthreads();  // the previous step is done with every query tile
    load_query_side(t, qg, dog, lse + gh * N, delta + gh * N, row0, N, D,
                    Dv);
    __syncthreads();
    tile_norms(t, D, true, false);
    __syncthreads();
    dsc += pair_weights<true>(
        t, mg, nullptr, N, D, Dv, row0, col0, metric, sc, sqrt_d, use_dropout,
        mix, keep_thresh, inv_keep);
    __syncthreads();
    for (int i = 0; i < BM; ++i) {
      float w[4], p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        w[a] = t.Ws[i * PS + rg * 4 + a];
        wsum[a] += w[a];
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
    add_dq_partial<VEC>(t, dqg, row0, N, D, metric);
  }

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
        ok[d] = sqm ? dka[a][jj] - wsum[a] * t.Ks[lc * DS + d]
                    : dka[a][jj];
      if (d < Dv) ov[d] = dva[a][jj];
    }
  }
  if (need_dscale) {
    const float s = block_sum(dsc, t.red);
    if (tid == 0)
      dscale_part[gh * n_j + jb] = s * dscale_factor(metric, sc);
  }
}

template <int LANES, int VEC>
cudaError_t launch_fused(const dim3& grid, size_t smem, cudaStream_t stream,
                         const void* q, const void* k, const void* v,
                         const void* mask, const void* dout, const void* lse,
                         const void* delta, const void* ilist,
                         const void* icount, const void* scale,
                         const void* seed, void* dq, void* dk, void* dv,
                         void* dscale_part, int H, int N, int D, int Dv,
                         int n_j, int W, int metric, float sqrt_d,
                         int use_dropout, unsigned int thresh, float inv_keep,
                         int need_dscale) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_fused_kernel<LANES, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  flash_bwd_fused_kernel<LANES, VEC><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (const float*)dout, (const float*)lse,
      (const float*)delta, (const int*)ilist, (const int*)icount,
      (const float*)scale, (const int*)seed, (float*)dq, (float*)dk,
      (float*)dv, (float*)dscale_part, H, N, D, Dv, n_j, W, metric, sqrt_d,
      use_dropout, thresh, inv_keep, need_dscale);
  return cudaGetLastError();
}

}  // namespace

// dq (accumulated into the caller's zeroed [G, H, N, D]), dk [G, H, N, D],
// dv [G, H, N, Dv] and, with need_dscale, the d(scale) partials [G, H, n_j]
// over the transposed walk (ilist, icount).
extern "C" int tagan_flash_geometric_bwd_fused(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* ilist,
    const void* icount, const void* scale, const void* seed, void* dq,
    void* dk, void* dv, void* dscale_part, int G, int H, int N, int D,
    int Dv, int n_j, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, int need_dscale,
    void* stream) {
  if (G < 0 || H < 0 || N < 0 || D < 1 || D > MAX_D || Dv < 1 ||
      Dv > MAX_D || metric < 0 || metric > COS_DIST ||
      n_j != (N + BN - 1) / BN || W < 0)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || H == 0 || N == 0) return 0;
  const size_t smem = sizeof(float) * bwd_smem_floats(D, Dv);
  const dim3 grid(n_j, H, G);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = D % 4 == 0;
  switch (lanes_for(D > Dv ? D : Dv) * 2 + (vec4 ? 1 : 0)) {
#define TAGAN_FUSED(L, V4)                                                 \
  case L * 2 + V4:                                                         \
    return (int)launch_fused<L, V4 ? 4 : 1>(                               \
        grid, smem, s, q, k, v, mask, dout, lse, delta, ilist, icount,     \
        scale, seed, dq, dk, dv, dscale_part, H, N, D, Dv, n_j, W, metric, \
        sqrt_d, use_dropout, keep_thresh, inv_keep, need_dscale);
    TAGAN_FUSED(1, 0) TAGAN_FUSED(1, 1) TAGAN_FUSED(2, 0) TAGAN_FUSED(2, 1)
    TAGAN_FUSED(4, 0) TAGAN_FUSED(4, 1) TAGAN_FUSED(8, 0) TAGAN_FUSED(8, 1)
#undef TAGAN_FUSED
  }
  return (int)cudaErrorInvalidValue;
}
