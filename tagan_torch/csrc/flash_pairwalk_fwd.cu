// Edge-masked geometric attention forwards as mask-driven pair walks, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// in their dense-mask forms:
//
//   B1       _flash_kernel         (host side _flash_forward), bf16=False
//   B1 bf16  _flash_kernel         bf16=True
//   B4       _lse1_kernel          (host side _flash_biased_forward)
//   B4 bf16  _lse1_kernel          bf16=True
//   B5       _flash_biased_kernel  (host side _flash_biased_forward)
//   B5 bf16  _flash_biased_kernel  bf16=True
//
// For each query row i and head h the walk takes the key tiles
// jlist[g, tile, :jcount[g, tile]] in that order: an online softmax whose
// running max is updated once per 64-key tile, the un-dropped denominator,
// the coordinate-hash dropout (keep_hash; B5's two seeds), out = 0 and
// lse = 1e30 on rows with no valid key. The squared-distance metrics use
// the norm expansion, the cosine metrics take q and k L2-normalised by the
// caller, gaussian and rbf a per-head scale (score_of). The precision is
// the template flag kBf16:
//  - fp32 (B1, B4, B5, bf16=False): q and k stay unrounded, q.k is an fp32
//    sum, B5's w1 = exp(s - lse1) is not rounded, p is not rounded and
//    multiplies unrounded v. This is the CPU's fp32 function up to the
//    order of the sums.
//  - bf16 (bf16=True): q.k from q and k rounded to bf16 after their fp32
//    norms, drop(p) rounded to bf16 relative to the tile's running max and
//    multiplied by v rounded to bf16, fp32 sums.
// B5 takes lse1 as an input, forms z = drop1(exp(s - lse1)) +
// bias[g, i, j] on valid pairs only (a dropped w1 enters as z = bias), and
// runs the same online softmax over z. B4 keeps only the running max and
// the un-dropped sum of exp(s) and writes lse1 (1e30 on rows with no
// valid key); its result depends on no walk, so a flush folds its pairs
// into (m, l) at once.
//
// What bounds it on the H100. Each snapshot's int8 mask is N^2 bytes (100
// MB at N = 10,000), more than the 50 MB L2, and the function needs it read
// once; q, k, v, out (and B5's bias at the valid pairs) are small beside it.
// So the least time is the mask's bytes over the memory rate. A dense tile
// walk computes every pair of every walked 64 x 64 tile, once per head, and
// reads the mask once per head: at 16 edges a row over 10,000 nodes each
// tile holds ~6.5 valid pairs of its 4,096.
//
// Design. One warp is one block and one unit of work: R rows of one
// 64-row query tile of one folded snapshot g, for a group of HG heads
// (all H where H <= 32), R * HG <= 32, each lane one (row, head) item. No
// block barrier is taken. (Blocks of 4 independent warps measured up to
// 10% slower: shared memory is then granted 4 warps at a time.)
//  1. The mask is read once for all the group's heads, and each row's
//     valid columns are listed in shared memory (`walk_mask`,
//     flash_pairwalk.cuh, shared with B2's walk).
//  2. When a row's list could overflow, and at the end, the warp flushes,
//     computing only the valid pairs, in three passes (`flush`): the
//     scores of all listed pairs (q.k over D from q in shared memory and
//     k gathered from global memory: one snapshot's K and V stay in L2;
//     score_of; for B5 w1, drop1 and the bias at that pair), then the
//     online softmax tile by tile in shared memory, then drop(p) v into
//     the row's accumulator. The gathering passes step through the entries
//     together across the warp, 2 entries a lane at a time, so that the
//     gathers of all lanes are in flight at once: a lane walking its own
//     list alone left the warp's rows to diverge and their gathers to
//     follow one another. Rows with no pair in a tile are not touched,
//     which is exact (m unchanged, alpha = 1), so the dense template's
//     "p = 1 garbage" before a row's first valid key does not arise. B4
//     takes the first pass only. The flush lives in
//     flash_pairwalk_fwd.cuh, shared with B1c's, B4c's and B5c's compact
//     walk (flash_pairwalk_fwd_compact.cu), a list entry being the key
//     itself here (`DenseRowPairs`).
//  3. Units are sub-tiles of R rows (8 at H = 4), so one 10K snapshot
//     gives 1,250 warps: every SM is busy at G = 1 as at G = 16.
// The fp32 form stages q and the accumulators in fp32 slots as the bf16
// form does (the bf16 form keeps its rounded values as floats), so both
// take the same shared memory: 57 KB a warp at D = Dv = 128 and H = 1.
//
// What it does not do: tensor cores. A tile whose rows hold many pairs is
// walked pair by pair on the CUDA cores, each pair's k and v rows gathered
// for each of its heads; it is correct at any density and its speed there
// is recorded, not targeted. For the fp32 form TF32's 10-bit mantissa
// would also break the fp32 contract (the 1e-4 gate against the CPU).
//
// Interface: plain C, loaded with ctypes; the same entry points and
// arguments as the dense templates had. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_pairwalk_fwd.cuh"

namespace {

using namespace tagan_pairwalk;

// Bytes of one warp's (one block's) shared memory: the mask ring, the
// rows' lists and counts, then the items' part (`item_bytes`).
__host__ __device__ inline size_t warp_bytes(int R, int D, int Dv) {
  return walk_bytes(R) + item_bytes(D, Dv);
}

template <int kMode, bool kBf16, bool kVec16>
__global__ void __launch_bounds__(WARP)
pairwalk_fwd_kernel(const Walk a) {
  const int lane = threadIdx.x;
  const int R = a.R;
  // hg innermost, so that the head groups of one sub-tile read its mask
  // together
  const int hg = (int)(blockIdx.x % a.n_hg), sub = (int)(blockIdx.x / a.n_hg);
  const int g = blockIdx.y;
  const int ib = sub / (BM / R), row0 = sub * R;

  extern __shared__ __align__(16) uint8_t smem[];
  const WalkSmem sm = walk_smem(smem, R);
  float* q_s = reinterpret_cast<float*>(sm.rest);
  float* acc_s = q_s + WARP * a.D;
  float* zbuf = acc_s + WARP * a.Dv + lane;

  Item it;
  const int rl = lane / a.HG, h = hg * a.HG + lane % a.HG;
  it.gr = row0 + rl;
  it.g = g;
  it.on = lane < R * a.HG && h < a.H && it.gr < a.N;
  it.gh = (size_t)g * a.H + (it.on ? h : 0);
  it.qs = q_s + lane;
  it.acc = acc_s + lane;
  it.m = NEG_INF;
  it.l = 0.f;
  it.qn = 0.f;
  it.l1 = 0.f;
  it.sc = 1.f;
  it.mix1 = it.mix2 = 0u;
  if (it.on) {
    const float* qr = a.q + (it.gh * a.N + it.gr) * a.D;
    for (int d = 0; d < a.D; ++d) {   // the norm, then the row (rounded)
      const float x = qr[d];
      it.qn += x * x;
      q_s[d * WARP + lane] = rd<kBf16>(x);
    }
    for (int x = 0; x < a.Dv; ++x) acc_s[x * WARP + lane] = 0.f;
    it.sc = a.scale[h];
    const uint32_t hmix = (uint32_t)h * 0xC2B2AE3Du;
    if constexpr (kMode == BIASED) {
      it.l1 = a.lse1[it.gh * a.N + it.gr];
      it.mix1 = (uint32_t)a.seeds[2 * g] ^ hmix;
      it.mix2 = (uint32_t)a.seeds[2 * g + 1] ^ hmix;
    } else if constexpr (kMode == OUT) {
      it.mix1 = (uint32_t)a.seeds[g] ^ hmix;
    }
  }
  const DenseRowPairs pairs{((size_t)g * a.N + (it.on ? it.gr : 0)) * a.N};

  const int cnt = a.jcount[(size_t)g * a.n_i + ib];
  const int* jl = a.jlist + ((size_t)g * a.n_i + ib) * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  walk_mask<kVec16>(sm, mg, a.N, row0, R, jl, cnt, lane, [&]() {
    flush<kMode, kBf16>(a, it, pairs, sm.lists + rl * CAPR,
                        it.on ? sm.rowcnt[rl] : 0, zbuf);
  });

  if (it.on) {
    const bool dead = it.m <= NEG_INF;
    const float l = dead ? 1.f : it.l;
    if constexpr (kMode != LSE) {
      float* og = a.out + (it.gh * a.N + it.gr) * a.Dv;
      for (int x = 0; x < a.Dv; ++x)
        og[x] = dead ? 0.f : acc_s[x * WARP + lane] / l;
    }
    a.lse[it.gh * a.N + it.gr] = dead ? LSE_DEAD : it.m + logf(l);
  }
}

template <int kMode, bool kBf16>
int launch(Walk a, int G, void* stream) {
  if (bad_walk<kMode>(a, G)) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  warp_items(a.H, &a.HG, &a.R);
  a.n_hg = (a.H + a.HG - 1) / a.HG;
  a.n_sub = a.n_i * (BM / a.R);
  const size_t smem = warp_bytes(a.R, a.D, a.Dv);
  const bool vec16 = a.N % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0;
  const auto kern = vec16 ? pairwalk_fwd_kernel<kMode, kBf16, true>
                          : pairwalk_fwd_kernel<kMode, kBf16, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)a.n_sub * a.n_hg, G);
  kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// B1: out [G, H, N, Dv] and lse [G, H, N] of the forward walk
// over the dense int8 mask [G, N, N], one hash seed per g.
extern "C" int tagan_flash_geometric_fwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* jlist, const void* jcount, const void* scale,
    const void* seed, void* out, void* lse, int G, int H, int N, int D,
    int Dv, int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
  return launch<OUT, false>(
      out_walk(q, k, v, mask, jlist, jcount, scale, seed, out, lse, H, N, D,
               Dv, n_i, W, metric, sqrt_d, use_dropout, keep_thresh,
               inv_keep),
      G, stream);
}

// B1's bf16 form: the same arguments.
extern "C" int tagan_flash_geometric_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* jlist, const void* jcount, const void* scale,
    const void* seed, void* out, void* lse, int G, int H, int N, int D,
    int Dv, int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
  return launch<OUT, true>(
      out_walk(q, k, v, mask, jlist, jcount, scale, seed, out, lse, H, N, D,
               Dv, n_i, W, metric, sqrt_d, use_dropout, keep_thresh,
               inv_keep),
      G, stream);
}

// B5: out [G, H, N, Dv] and lse2 [G, H, N] of the second softmax, given
// lse1 [G, H, N], the bias [G, N, N] and two seeds per g, [G, 2].
extern "C" int tagan_flash_biased_fwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* lse1, const void* jlist, const void* jcount,
    const void* scale, const void* seeds, void* out, void* lse2, int G, int H,
    int N, int D, int Dv, int n_i, int W, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep, void* stream) {
  return launch<BIASED, false>(
      biased_walk(q, k, v, mask, bias, lse1, jlist, jcount, scale, seeds, out,
                  lse2, H, N, D, Dv, n_i, W, metric, sqrt_d, use_dropout,
                  keep_thresh, inv_keep),
      G, stream);
}

// B5's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* lse1, const void* jlist, const void* jcount,
    const void* scale, const void* seeds, void* out, void* lse2, int G, int H,
    int N, int D, int Dv, int n_i, int W, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep, void* stream) {
  return launch<BIASED, true>(
      biased_walk(q, k, v, mask, bias, lse1, jlist, jcount, scale, seeds, out,
                  lse2, H, N, D, Dv, n_i, W, metric, sqrt_d, use_dropout,
                  keep_thresh, inv_keep),
      G, stream);
}

// B4: lse1 [G, H, N] of the forward walk over the dense int8 mask
// [G, N, N].
extern "C" int tagan_flash_lse1(const void* q, const void* k,
                                const void* mask, const void* jlist,
                                const void* jcount, const void* scale,
                                void* lse1, int G, int H, int N, int D,
                                int n_i, int W, int metric, float sqrt_d,
                                void* stream) {
  return launch<LSE, false>(lse1_walk(q, k, mask, jlist, jcount, scale, lse1,
                                      H, N, D, n_i, W, metric, sqrt_d),
                            G, stream);
}

// B4's bf16 form: the same arguments.
extern "C" int tagan_flash_lse1_bf16(const void* q, const void* k,
                                     const void* mask, const void* jlist,
                                     const void* jcount, const void* scale,
                                     void* lse1, int G, int H, int N, int D,
                                     int n_i, int W, int metric, float sqrt_d,
                                     void* stream) {
  return launch<LSE, true>(lse1_walk(q, k, mask, jlist, jcount, scale, lse1,
                                     H, N, D, n_i, W, metric, sqrt_d),
                           G, stream);
}
