// The ring flash attention's fold kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tagan_tpu/ops/pallas/ring_flash.py::
// _ring_flash_kernel (B9), in fp32 and in its bf16 form (bf16=True). Rank
// `my` of a ring of g ranks holds the query rows [my*per, (my+1)*per) of
// q, their mask rows [per, N] and one K/V chunk [H, per, D]; at hop s it
// holds the chunk of rank src = (my - s) mod g and folds it into an online
// softmax over the mask's column block [src*per, (src+1)*per):
//
//     sc    = metric score of q_i . k_j and the row norms (MXU_METRICS),
//             NEG_INF where mask[i, src*per + j] == 0
//     m_new = max(m, rowmax sc),  p = exp(sc - m_new),  a = exp(m - m_new)
//     l     = l a + rowsum p,     acc = acc a + p v,     m = m_new
//
// and after the last hop out = acc / l, 0 on rows that no key reaches.
// Cosine inputs come L2-normalised, as the TPU wrapper normalises them.
//
// What differs from the TPU kernel, and why:
//  - The TPU kernel runs grid (H, g) per rank: one head's [per, D] rows sit
//    in VMEM, and hop s's remote DMA of the next K/V chunk to the right
//    neighbour is started before the fold and waited after it. Here one
//    launch folds one hop for every head of one rank: a block per (64-row
//    query tile, head) walks the resident chunk in 64-key tiles, with the
//    running max, sum and output accumulator in registers, stored to
//    global memory (m, l, acc [H, per(, D)]) between hops. The chunk for
//    hop s + 1 moves with the ring all-gather's copy kernel
//    (ring_gather.cu) on the rank's copy stream while the fold runs on its
//    compute stream; CUDA events order them (tagan_torch/ops/ring_flash.py).
//  - The first hop starts from m = NEG_INF, l = acc = 0 without reading
//    the state, and the last writes out instead of the state: the TPU's
//    separate _seed and _fin steps.
//  - No padding of D to 128 lanes; the ragged edge of per is masked here.
//  - The fp32 form updates m after every 64-key tile, which changes only
//    the order of fp32 sums. The bf16 form rounds p = exp(sc - m_new) with
//    m_new the max after the whole chunk (the TPU kernel takes the chunk
//    at once), and its rounding depends on that max, so the bf16 form first
//    walks the chunk's tiles for the row max, then again for p. q and k
//    are rounded to bf16 after their row norms are taken (fp32, as the TPU
//    kernel's _qk_sq), v as staged, p as stored for P@V; l sums fp32 p.
//
// What bounds it on the H100. The fold walks every pair of the [per, per]
// block of every hop (the TPU kernel is block-dense by design), so a ring
// scores all N^2 pairs per head: 2 H N^2 (D + D) flops, in fp32 on the CUDA
// cores here, above the bytes (the int8 mask, N^2, dominates). At g virtual
// ranks on one card the ranks' folds run at the same time on their
// streams; each launch alone has only ceil(per/64) * H blocks.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_geometric_common.cuh"

namespace {

using namespace tagan_flash;

constexpr int ROWS = BM / 16;     // query rows per thread
constexpr int COLS = BN / 16;     // keys per thread and tile
constexpr int MAX_LANES = 8;      // output columns per thread: D <= 128

struct Tiles {
  float* Qs;    // [BM][D + 1]
  float* Ks;    // [BN][D + 1]
  float* Vs;    // [BN][D]
  float* Ps;    // [BM][BN + 1]
  float* qn;    // [BM]
  float* kn;    // [BN]
};

__host__ __device__ inline size_t fold_smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BM + BN) * (D + 1) + (size_t)BN * D +
                          (size_t)BM * (BN + 1) + BM + BN);
}

// Keys [c0, c0 + 64) of the chunk into Ks (and v into Vs with kWithV),
// their norms into kn; the bf16 form rounds k after its norm and v as
// staged. Rows past per read as 0. Ends with a barrier.
template <bool kBf16, bool kWithV>
__device__ __forceinline__ void load_keys(const Tiles& t, const float* kg,
                                          const float* vg, int c0, int per,
                                          int D) {
  const int tid = threadIdx.x, DS = D + 1;
  __syncthreads();    // the previous tile is done with Ks, Vs and Ps
  for (int idx = tid; idx < BN * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D, gc = c0 + r;
    t.Ks[r * DS + d] = gc < per ? kg[(size_t)gc * D + d] : 0.f;
    if (kWithV)
      t.Vs[idx] = rd<kBf16>(gc < per ? vg[(size_t)gc * D + d] : 0.f);
  }
  __syncthreads();
  if (tid < BN) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = t.Ks[tid * DS + d];
      s += x * x;
      if (kBf16) t.Ks[tid * DS + d] = rd<true>(x);
    }
    t.kn[tid] = s;
  }
  __syncthreads();
}

// Masked scores of this thread's rows and keys of the staged key tile.
__device__ __forceinline__ void tile_scores(
    const Tiles& t, const uint8_t* __restrict__ mrow, int row0, int c0,
    int per, int N, int D, int metric, float sc, float sqrt_d,
    float (&s)[ROWS][COLS]) {
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15, DS = D + 1;
#pragma unroll
  for (int a = 0; a < ROWS; ++a)
#pragma unroll
    for (int b = 0; b < COLS; ++b) s[a][b] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[ROWS], kv[COLS];
#pragma unroll
    for (int a = 0; a < ROWS; ++a) qv[a] = t.Qs[(rg * ROWS + a) * DS + d];
#pragma unroll
    for (int b = 0; b < COLS; ++b) kv[b] = t.Ks[(lane + 16 * b) * DS + d];
#pragma unroll
    for (int a = 0; a < ROWS; ++a)
#pragma unroll
      for (int b = 0; b < COLS; ++b) s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
  }
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    const int lr = rg * ROWS + a, gr = row0 + lr;
#pragma unroll
    for (int b = 0; b < COLS; ++b) {
      const int lc = lane + 16 * b, gc = c0 + lc;
      const bool ok = gr < per && gc < per && mrow[(size_t)gr * N + gc] != 0;
      s[a][b] = ok ? score_of(metric, s[a][b], t.qn[lr], t.kn[lc], sc, sqrt_d)
                   : NEG_INF;
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool kBf16>
__global__ void __launch_bounds__(THREADS)
ring_fold_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 const float* __restrict__ scale, float* __restrict__ m_g,
                 float* __restrict__ l_g, float* __restrict__ acc_g,
                 float* __restrict__ out, int per, int N, int D, int col0,
                 int metric, float sqrt_d, int first, int last) {
  const int ib = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, rg = tid >> 4, lane = tid & 15;
  const int DS = D + 1, PS = BN + 1;

  extern __shared__ float smem[];
  Tiles t;
  t.Qs = smem;
  t.Ks = t.Qs + BM * DS;
  t.Vs = t.Ks + BN * DS;
  t.Ps = t.Vs + BN * D;
  t.qn = t.Ps + BM * PS;
  t.kn = t.qn + BM;

  const size_t hp = (size_t)h * per;
  const float* qg = q + hp * D;
  const float* kg = k + hp * D;
  const float* vg = v + hp * D;
  const uint8_t* mrow = mask + col0;   // mask[i, col0 + j] = mrow[i*N + j]
  const int row0 = ib * BM;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D, gr = row0 + r;
    t.Qs[r * DS + d] = gr < per ? qg[(size_t)gr * D + d] : 0.f;
  }
  __syncthreads();
  if (tid < BM) {    // the norm of row tid, then (bf16) the row rounded
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = t.Qs[tid * DS + d];
      s += x * x;
      if (kBf16) t.Qs[tid * DS + d] = rd<true>(x);
    }
    t.qn[tid] = s;
  }

  const float sc = scale[h];
  const int n_lanes = (D + 15) / 16;
  float m_i[ROWS], l_i[ROWS], acc[ROWS][MAX_LANES];
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    const int gr = row0 + rg * ROWS + a;
    const bool load = !first && gr < per;
    m_i[a] = load ? m_g[hp + gr] : NEG_INF;
    l_i[a] = load ? l_g[hp + gr] : 0.f;
#pragma unroll
    for (int jj = 0; jj < MAX_LANES; ++jj) {
      const int dv = lane + 16 * jj;
      acc[a][jj] = load && jj < n_lanes && dv < D
                       ? acc_g[(hp + gr) * D + dv] : 0.f;
    }
  }

  const int n_tiles = (per + BN - 1) / BN;
  float s[ROWS][COLS];
  if (kBf16) {
    // the chunk's row max first: p is rounded against it
    float mx[ROWS];
#pragma unroll
    for (int a = 0; a < ROWS; ++a) mx[a] = NEG_INF;
    for (int tile = 0; tile < n_tiles; ++tile) {
      load_keys<true, false>(t, kg, vg, tile * BN, per, D);
      tile_scores(t, mrow, row0, tile * BN, per, N, D, metric, sc, sqrt_d, s);
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int b = 0; b < COLS; ++b) mx[a] = fmaxf(mx[a], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const float m_new = fmaxf(m_i[a], half_warp_max(mx[a]));
      const float alpha = expf(m_i[a] - m_new);
      l_i[a] *= alpha;
#pragma unroll
      for (int jj = 0; jj < MAX_LANES; ++jj) acc[a][jj] *= alpha;
      m_i[a] = m_new;
    }
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    load_keys<kBf16, true>(t, kg, vg, tile * BN, per, D);
    tile_scores(t, mrow, row0, tile * BN, per, N, D, metric, sc, sqrt_d, s);
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int lr = rg * ROWS + a;
      // fp32: the online max of the tiles so far. A row that has seen no
      // valid key keeps m == NEG_INF and accumulates p == 1 garbage,
      // washed out by alpha == 0 once a valid key arrives, or zeroed at
      // the end; the bf16 form's max is the chunk's, taken above.
      float m_new = m_i[a];
      if (!kBf16) {
        float mx = NEG_INF;
#pragma unroll
        for (int b = 0; b < COLS; ++b) mx = fmaxf(mx, s[a][b]);
        m_new = fmaxf(m_i[a], half_warp_max(mx));
        const float alpha = expf(m_i[a] - m_new);
        l_i[a] *= alpha;
#pragma unroll
        for (int jj = 0; jj < MAX_LANES; ++jj) acc[a][jj] *= alpha;
        m_i[a] = m_new;
      }
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < COLS; ++b) {
        const float p = expf(s[a][b] - m_new);
        rs += p;
        t.Ps[lr * PS + lane + 16 * b] = rd<kBf16>(p);
      }
      l_i[a] += half_warp_sum(rs);
    }
    __syncthreads();
    for (int j = 0; j < BN; ++j) {
      float pv[ROWS];
#pragma unroll
      for (int a = 0; a < ROWS; ++a) pv[a] = t.Ps[(rg * ROWS + a) * PS + j];
#pragma unroll
      for (int jj = 0; jj < MAX_LANES; ++jj) {
        const int dv = lane + 16 * jj;
        if (jj < n_lanes && dv < D) {
          const float vv = t.Vs[j * D + dv];
#pragma unroll
          for (int a = 0; a < ROWS; ++a)
            acc[a][jj] = fmaf(pv[a], vv, acc[a][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    const int gr = row0 + rg * ROWS + a;
    if (gr >= per) continue;
    const bool dead = m_i[a] <= NEG_INF;
    const float l = dead ? 1.f : l_i[a];
#pragma unroll
    for (int jj = 0; jj < MAX_LANES; ++jj) {
      const int dv = lane + 16 * jj;
      if (jj < n_lanes && dv < D) {
        if (last) out[(hp + gr) * D + dv] = dead ? 0.f : acc[a][jj] / l;
        else acc_g[(hp + gr) * D + dv] = acc[a][jj];
      }
    }
    if (!last && lane == 0) {
      m_g[hp + gr] = m_i[a];
      l_g[hp + gr] = l_i[a];
    }
  }
}

template <bool kBf16>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* scale, void* m, void* l, void* acc, void* out, int H,
           int per, int N, int D, int col0, int metric, float sqrt_d,
           int first, int last, void* stream) {
  if (H < 0 || per < 0 || D < 1 || D > 16 * MAX_LANES || metric < 0 ||
      metric > COS_DIST || col0 < 0 || col0 + per > N ||
      (!(first && last) && (!m || !l || !acc)) || (last && !out))
    return (int)cudaErrorInvalidValue;
  if (H == 0 || per == 0) return 0;
  const size_t smem = fold_smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_fold_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((per + BM - 1) / BM, H);
  ring_fold_kernel<kBf16><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (const float*)scale, (float*)m, (float*)l,
      (float*)acc, (float*)out, per, N, D, col0, metric, sqrt_d, first, last);
  return (int)cudaGetLastError();
}

}  // namespace

// One hop of one rank: q, k, v [H, per, D] f32 (k, v the resident chunk),
// mask [per, N] bytes (the rank's rows; column block col0), scale f32[H],
// the state m, l [H, per] and acc [H, per, D] (read unless first, written
// unless last; may be null when both), out [H, per, D] (written if last).
extern "C" int tagan_ring_flash_fold(
    const void* q, const void* k, const void* v, const void* mask,
    const void* scale, void* m, void* l, void* acc, void* out, int H,
    int per, int N, int D, int col0, int metric, float sqrt_d, int first,
    int last, void* stream) {
  return launch<false>(q, k, v, mask, scale, m, l, acc, out, H, per, N, D,
                       col0, metric, sqrt_d, first, last, stream);
}

// The bf16 form: the same arguments.
extern "C" int tagan_ring_flash_fold_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* scale, void* m, void* l, void* acc, void* out, int H,
    int per, int N, int D, int col0, int metric, float sqrt_d, int first,
    int last, void* stream) {
  return launch<true>(q, k, v, mask, scale, m, l, acc, out, H, per, N, D,
                      col0, metric, sqrt_d, first, last, stream);
}
