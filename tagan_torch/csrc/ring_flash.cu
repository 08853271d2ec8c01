// The ring flash attention's fold kernel, for Hopper (sm_90a): a pair walk
// over one hop's column block.
//
// Replaces the Pallas TPU kernel tagan_tpu/ops/pallas/ring_flash.py::
// _ring_flash_kernel (B9), in fp32 and in its bf16 form (bf16=True). Rank
// `my` of a ring of g ranks holds the query rows [my*per, (my+1)*per) of
// q, their mask rows [per, N] and one K/V chunk [H, per, D]; at hop s it
// holds the chunk of rank src = (my - s) mod g and folds it into an online
// softmax over the mask's column block [col0, col0 + per), col0 = src*per:
//
//     z     = metric score of q_i . k_j and the row norms (MXU_METRICS),
//             on the valid pairs mask[i, col0 + j] != 0 only
//     m_new = max(m, rowmax z),  p = exp(z - m_new),  a = exp(m - m_new)
//     l     = l a + rowsum p,    acc = acc a + p v,     m = m_new
//
// and after the last hop out = acc / l, 0 on rows that no key reaches.
// Cosine inputs come L2-normalised, as the TPU wrapper normalises them.
//
// What differs from the TPU kernel, and why:
//  - The TPU kernel runs grid (H, g) per rank: one head's [per, D] rows sit
//    in VMEM, every pair of the [per, per] block is scored on the MXU, and
//    hop s's remote DMA of the next K/V chunk to the right neighbour is
//    started before the fold and waited after it. Here one launch folds one
//    hop for every head of one rank, and computes the valid pairs only: at
//    the model's graphs a 10K snapshot has ~17 valid keys a row, so scoring
//    the whole block would do ~180x the work the function needs. The
//    state (m, l, acc [H, per(, D)]) stays in global memory between hops.
//    The chunk for hop s + 1 moves with the ring all-gather's copy kernel
//    (ring_gather.cu) on the rank's copy stream while the fold runs on its
//    compute stream; CUDA events order them (tagan_torch/ops/ring_flash.py).
//  - The first hop starts from m = NEG_INF, l = acc = 0 without reading
//    the state, and the last writes out instead of the state: the TPU's
//    separate _seed and _fin steps.
//  - The fp32 form updates m after every 64-key tile of the mask (the
//    flush's online softmax), which changes only the order of fp32 sums.
//  - The bf16 form rounds p = exp(z - m_new) with m_new the max after the
//    whole chunk, as the TPU kernel (which takes the chunk at once) and the
//    plain version do. A row's hop can span several flushes, so the launch
//    walks the block twice: first for the hop's row max alone (the flush's
//    LSE mode), then with the item's m set to max(m, that max), so that
//    every flush step of the second walk has m_new = m and rounds p against
//    the chunk max. q and k are rounded to bf16 after their fp32 row norms,
//    v as it is loaded, p as it multiplies v; l sums fp32 p.
//
// Design: the pair walks' machinery (flash_pairwalk.cuh,
// flash_pairwalk_fwd.cuh). One warp is one block: R rows of the rank's
// mask rows for a group of HG heads (all H where H <= 32), one lane a
// (row, head) item.
//  1. The warp walks the 64-column tiles of the mask rows that overlap the
//     hop's block, at absolute multiples of 64 (col0 is not aligned at
//     the ring's shapes: per = 5,000, 2,500, 1,250 for a 10K snapshot over
//     2, 4, 8 ranks), by `walk_mask` over a `ColumnWindow`: the rows past
//     per read as 0, the bits outside [col0, col0 + per) are dropped, the
//     row stride stays N. There is no plan: every tile of the block is
//     walked, and one whose chunks are all 0 costs almost nothing.
//  2. A list entry is the mask column; `ChunkPairs` maps it to the
//     chunk's key entry - col0, whose k and v rows the flush gathers from
//     the resident chunk [H, per, D].
//  3. The per-pair code and the flush are the dense forward walk's
//     (`pair_z`, `flush<OUT>` of flash_pairwalk_fwd.cuh): the ring has no
//     bias and no dropout.
//
// What bounds it on the H100: the mask's N^2 bytes, read once over the
// ring (each hop reads its rows' block), above q, k, v and out; the valid
// pairs' products are small beside them.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_pairwalk_fwd.cuh"

namespace {

using namespace tagan_pairwalk;

// The hop's list entries are mask columns; the key is column - col0 of the
// resident chunk. The ring has no bias, so no `bias` as the other walks'
// policies have.
struct ChunkPairs {
  int col0;
  __device__ __forceinline__ int index(int x) const { return x - col0; }
};

// The hop's walk steps: the mask's 64-column tiles t0, t0 + 1, ...
struct TileRun {
  int t0;
  __device__ __forceinline__ int operator[](int t) const { return t0 + t; }
};

// One hop of one rank. In `a`, N is per (the chunk's rows, the rows of
// q and of the state), Dv = D, and mask is the rank's rows, `stride` bytes
// apart.
struct Fold {
  Walk a;
  float* m;       // [H, per]: read unless first, written unless last
  float* l;       // [H, per]
  float* acc;     // [H, per, D]
  int stride, col0, first, last;
};

__host__ __device__ inline size_t fold_bytes(int R, int D) {
  return walk_bytes(R) + item_bytes(D, D);
}

// At least 8 warps an SM, as the compact walks: without a minimum, ptxas
// held a one-warp-block walk to 64-72 registers and spilled.
template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(WARP, 8)
ring_fold_kernel(const Fold f) {
  const Walk& a = f.a;
  const int lane = threadIdx.x;
  const int R = a.R, per = a.N;
  const int hg = (int)(blockIdx.x % a.n_hg), sub = (int)(blockIdx.x / a.n_hg);
  const int row0 = sub * R;

  extern __shared__ __align__(16) uint8_t smem[];
  const WalkSmem sm = walk_smem(smem, R);
  float* q_s = reinterpret_cast<float*>(sm.rest);
  float* acc_s = q_s + WARP * a.D;
  float* zbuf = acc_s + WARP * a.D + lane;

  // the lane's item: its row of q (rounded after its norm in bf16), its
  // scale, and the state (m, l and acc into the warp's accumulator)
  Item it;
  const int rl = lane / a.HG, h = hg * a.HG + lane % a.HG;
  it.gr = row0 + rl;
  it.g = 0;
  it.on = lane < R * a.HG && h < a.H && it.gr < per;
  it.gh = (size_t)(it.on ? h : 0);
  it.qs = q_s + lane;
  it.acc = acc_s + lane;
  it.m = NEG_INF;
  it.l = 0.f;
  it.qn = 0.f;
  it.l1 = 0.f;
  it.sc = 1.f;
  it.mix1 = it.mix2 = 0u;
  const size_t row = it.gh * per + it.gr;
  if (it.on) {
    const float* qr = a.q + row * a.D;
    for (int d = 0; d < a.D; ++d) {
      const float x = qr[d];
      it.qn += x * x;
      q_s[d * WARP + lane] = rd<kBf16>(x);
    }
    it.sc = a.scale[h];
    if (!f.first) {
      it.m = f.m[row];
      it.l = f.l[row];
    }
    for (int x = 0; x < a.D; ++x)
      acc_s[x * WARP + lane] = f.first ? 0.f : f.acc[row * a.D + x];
  }

  const ChunkPairs pairs{f.col0};
  const TileRun tiles{f.col0 / BN};
  const int cnt = (f.col0 + per - 1) / BN - f.col0 / BN + 1;
  const ColumnWindow win{per, f.col0, f.col0 + per};
  const int* list = sm.lists + (rl < R ? rl : 0) * CAPR;

  if constexpr (kBf16) {
    // the hop's row max first: p is rounded against max(m, it)
    const float m0 = it.m, l0 = it.l;
    it.m = NEG_INF;
    it.l = 0.f;
    walk_mask<kVec16>(sm, f.a.mask, f.stride, row0, R, tiles, cnt, lane,
                      [&]() {
                        flush<LSE, true>(a, it, pairs, list,
                                         it.on ? sm.rowcnt[rl] : 0, zbuf);
                      }, win);
    const float m_new = fmaxf(m0, it.m);
    const float alpha = expf(m0 - m_new);
    it.m = m_new;
    it.l = l0 * alpha;
    for (int x = 0; x < a.D; ++x) acc_s[x * WARP + lane] *= alpha;
  }
  walk_mask<kVec16>(sm, f.a.mask, f.stride, row0, R, tiles, cnt, lane,
                    [&]() {
                      flush<OUT, kBf16>(a, it, pairs, list,
                                        it.on ? sm.rowcnt[rl] : 0, zbuf);
                    }, win);

  if (it.on) {
    if (f.last) {       // every row once: 0 on a row no key reached
      const bool dead = it.m <= NEG_INF;
      const float l = dead ? 1.f : it.l;
      float* og = a.out + row * a.D;
      for (int x = 0; x < a.D; ++x)
        og[x] = dead ? 0.f : acc_s[x * WARP + lane] / l;
    } else {
      f.m[row] = it.m;
      f.l[row] = it.l;
      for (int x = 0; x < a.D; ++x)
        f.acc[row * a.D + x] = acc_s[x * WARP + lane];
    }
  }
}

template <bool kBf16>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* scale, void* m, void* l, void* acc, void* out, int H,
           int per, int N, int D, int col0, int metric, float sqrt_d,
           int first, int last, void* stream) {
  if (H < 0 || per < 0 || D < 1 || D > MAX_D || metric < 0 ||
      metric > COS_DIST || col0 < 0 || col0 + per > N ||
      (!(first && last) && (!m || !l || !acc)) || (last && !out))
    return (int)cudaErrorInvalidValue;
  if (H == 0 || per == 0) return 0;
  Fold f{};
  f.a.q = (const float*)q;
  f.a.k = (const float*)k;
  f.a.v = (const float*)v;
  f.a.mask = (const uint8_t*)mask;
  f.a.scale = (const float*)scale;
  f.a.out = (float*)out;
  f.a.H = H;
  f.a.N = per;
  f.a.D = f.a.Dv = D;
  f.a.metric = metric;
  f.a.sqrt_d = sqrt_d;
  f.a.inv_keep = 1.f;
  warp_items(H, &f.a.HG, &f.a.R);
  f.a.n_hg = (H + f.a.HG - 1) / f.a.HG;
  f.m = (float*)m;
  f.l = (float*)l;
  f.acc = (float*)acc;
  f.stride = N;
  f.col0 = col0;
  f.first = first;
  f.last = last;
  const size_t smem = fold_bytes(f.a.R, D);
  const bool vec16 =
      N % 16 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  const auto kern = vec16 ? ring_fold_kernel<kBf16, true>
                          : ring_fold_kernel<kBf16, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((per + f.a.R - 1) / f.a.R) * f.a.n_hg;
  kern<<<blocks, WARP, smem, (cudaStream_t)stream>>>(f);
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
