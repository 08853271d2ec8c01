// Edge-biased geometric attention, backward, as two mask-driven pair walks,
// for Hopper (sm_90a): a row walk and a key walk.
//
// Replaces the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// that differentiate the dense path's double softmax, in their dense-mask
// forms bf16=False and bf16=True (the template flag kBf16; host side
// flash_biased_attention_bwd):
//
//   row walk  B6   _biased_bwd_pre_kernel  delta1_i = sum_j w1 dw1,
//                                          dB_ij = sum_h dz
//             B7a  _biased_bwd_dq_kernel   dq_i, and d(scale)
//   key walk  B7b  _biased_bwd_dkv_kernel  dk_j, dv_j
//
// Per valid pair (i, j) and head h they recompute what the forward (B4, B5:
// flash_pairwalk_fwd.cu) formed, as _bwd_biased_common does:
//
//   s   = the metric score of q_i and k_j,  w1 = exp(s - lse1_i),
//   z   = drop1(w1) + B_ij,                 w2 = exp(z - lse2_i),
//   dp2 = drop2(do_i . v_j),
//   dz  = w2 (dp2 - delta2_i),              dw1 = drop1(dz),
//   ds  = w1 (dw1 - delta1_i),              W = the chain weight of ds,
//   dq_i += W k_j,  dk_j += W q_i,          dv_j += drop2(w2) do_i,
//
// and the squared-distance metrics subtract the row and column sums of W
// times the unrounded q_i and k_j; d(scale) sums ds s sq.
//  - fp32 (bf16=False): every operand unrounded, W = chain_weight (the
//    scaled dot's 1/sqrt(d) inside it), no TF32. The CPU's fp32 function
//    (flash_biased_backward_plain) up to the order of the sums.
//  - bf16 (bf16=True), at the rounding points of the plain bf16 version
//    (flash_biased_backward_plain(..., bf16=True)): q and k rounded to bf16
//    after their fp32 norms, do and v rounded, W = chain_weight_bf16 and
//    drop2(w2) rounded as operands of their products; the scaled dot
//    divides the dq and dk sums by sqrt(d) (chain_finish).
// In both, w1, z, w2, dz, delta1, dB, ds and the sums of W are fp32. The
// dropouts are the coordinate hash (keep_hash) with seeds[g, 0] and
// seeds[g, 1]. A dropped w1 is not a masked pair: z = B there, so dz and dB
// are set while dw1 = 0. Both softmaxes are normalised by the forward's
// lse1 and lse2, so no walk order enters the pairs' values; only the order
// of the sums does, and it is fixed: neither kernel has an atomic, and
// repeated calls are bit-identical.
//
// The row walk (B6 and B7a). B2's walk (flash_pairwalk_bwd.cu) over the
// forward plan (jlist, jcount): one warp is one block, R rows of one 64-row
// query tile for a group of HG heads, each lane one (row, head) item whose
// q_i and do_i (rounded in bf16) and dq_i accumulator stay in its shared
// slots. The mask is read once for all the group's heads and each row's
// valid columns are listed (`walk_mask`, flash_pairwalk.cuh).
//  Pass 1 (B6) at every listed pair: w1, w2, dz and dw1 from k_j, v_j and
//   the bias at (i, j), gathered at the valid pairs only (contiguous in row
//   i); delta1 += w1 dw1 in the lane; dB_ij = the row's HG lanes' dz summed
//   in head order by shuffles, stored once by the row's first lane.
//  Pass 2 (B7a), once delta1 is whole: the same recompute, then ds, W,
//   dq_i += W k_j and the d(scale) term.
//  When no list of the warp overflowed (CAPR entries a row), the lists are
//  still in shared memory after pass 1 and pass 2 walks them; otherwise the
//  warp walks its mask tiles again (the re-read comes from L2 where it
//  still holds them). d(scale) is written per item, [G, H, N], for torch to
//  sum in a fixed order. Past 32 heads the entry point launches the walk
//  once per group of 32 heads, in order on the stream, each group adding its
//  heads' dz into dB: still no atomic.
//
// The key walk (B7b), over the transposed plan (ilist, icount): one block
// owns KB keys (all 64 at head dim 16) of one 64-key tile of one snapshot
// for a group of HG heads (up to 8), each lane one (key, head) item whose
// k_j and v_j (rounded in bf16) and dk_j and dv_j accumulators stay in its
// shared slots; a warp holds R keys.
//  The walk (`walk_key_mask`, flash_pairwalk.cuh, shared with B3b's key
//  walk in flash_pairwalk_two_walk.cu) copies each walked [64 rows x 64
//  keys] mask tile whole by cp.async into an NST-stage ring, one block
//  barrier a step, ballots each key's 64-bit row word and lists its valid
//  rows. When a key's list could overflow (the block votes at the step's
//  barrier, so that all warps flush together), and at the end, the warp
//  flushes: its lanes step through their keys' lists together, gathering
//  q_i, do_i, lse1_i, lse2_i, delta2_i, delta1_i (the row walk's) and the
//  bias at (i, j) (one sector a valid pair), recompute w1, w2, dz, dw1, ds
//  and W, and add into dk_j and dv_j in ascending row order.
//  dk_j and dv_j are written once at the end, with the squared-distance
//  column term (and, in bf16, the scaled dot's 1/sqrt(d)).
//
// Why the whole tile and not the R-byte pieces of each warp's keys (which
// flash_pairwalk_bwd.cu rejected for B2 at ~4x the mask's sectors): the
// block's warps share one copy of the tile, so each 64-byte row segment is
// read once. pairwalk_variants.py times the pieces (`KEY_PIECES`) against
// the whole tile.
//
// What bounds them on the H100. Each snapshot's int8 mask is N^2 bytes (100
// MB at N = 10,000), read once by each walk; q, k, v, do, the row
// statistics, the bias and dB at the valid pairs and the outputs are small
// beside it. So the least time of each is the mask's bytes over the memory
// rate, and the pairs' work (~2 to 3 products of head dim a pair and head)
// is far below the fp32 rate at the model's density.
//
// The per-pair code (the recompute and both flushes) lives in
// flash_pairwalk_biased_bwd.cuh, shared with the compact walks of
// flash_pairwalk_biased_bwd_compact.cu.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the last launch.

#include "flash_pairwalk.cuh"
#include "flash_pairwalk_biased_bwd.cuh"

namespace {

using namespace tagan_pairwalk;

// the flushes: false leaves each walk streaming and listing the mask alone
// (pairwalk_variants.py; its outputs are then not the function)
constexpr bool ROW_FLUSH = true;
constexpr bool KEY_FLUSH = true;

// ---------------------------------------------------------------------------
// The row walk
// ---------------------------------------------------------------------------

// Bytes of one warp's (one block's) shared memory: the walk's, then q and
// do (rounded in bf16) and the dq accumulator, each [width][32 lanes].
__host__ __device__ inline size_t row_bytes(int R, int D, int Dv) {
  return walk_bytes(R) + row_item_bytes(D, Dv);
}

template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(WARP) row_walk_kernel(const Bwd a) {
  const int lane = threadIdx.x;
  const int R = a.R, HG = a.HG;
  const int sub = (int)blockIdx.x, g = (int)blockIdx.y;
  const int ib = sub / (BM / R), row0 = sub * R;

  extern __shared__ __align__(16) uint8_t smem[];
  const WalkSmem sm = walk_smem(smem, R);
  float* q_s = reinterpret_cast<float*>(sm.rest);
  float* do_s = q_s + WARP * a.D;
  float* dq_s = do_s + WARP * a.Dv;

  size_t row;
  RowItem it =
      row_item<kBf16>(a, g, row0, lane, a.hg, q_s, do_s, dq_s, &row);
  const int rl = lane / HG;
  const DenseRowPairs pairs{((size_t)g * a.N + (it.on ? it.gr : 0)) * a.N};

  const int cnt = a.pcount[(size_t)g * a.n_t + ib];
  const int* jl = a.plan + ((size_t)g * a.n_t + ib) * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  const int* list = sm.lists + (rl < R ? rl : 0) * CAPR;
  int flushes = 0;
  walk_mask<kVec16>(sm, mg, a.N, row0, R, jl, cnt, lane, [&]() {
    ++flushes;
    if constexpr (ROW_FLUSH)
      row_pass<1, kBf16>(a, it, pairs, list, it.on ? sm.rowcnt[rl] : 0, HG);
  });
  if (flushes == 1) {   // every list whole in shared memory: pass 2 there
    if constexpr (ROW_FLUSH)
      row_pass<2, kBf16>(a, it, pairs, list, it.on ? sm.rowcnt[rl] : 0, HG);
  } else {
    walk_mask<kVec16>(sm, mg, a.N, row0, R, jl, cnt, lane, [&]() {
      if constexpr (ROW_FLUSH)
        row_pass<2, kBf16>(a, it, pairs, list, it.on ? sm.rowcnt[rl] : 0,
                           HG);
    });
  }
  row_finish<kBf16>(a, it, row, dq_s, lane);
}

// ---------------------------------------------------------------------------
// The key walk
// ---------------------------------------------------------------------------

// Bytes of one block: the ring and the keys' lists, then k and v (rounded
// in bf16) and the dk and dv accumulators, each [width][threads].
__host__ __device__ inline size_t key_bytes(int KB, int R, int D, int Dv) {
  return key_walk_bytes(KB) + key_item_bytes(KB, R, D, Dv);
}

template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(KEY_WARPS * WARP, 1)
key_walk_kernel(const Bwd a) {
  const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;
  const int nthr = blockDim.x;
  const int R = a.R, HG = a.HG;
  // head groups innermost, then the key blocks of one tile: the blocks
  // that read one mask tile run together
  const int hg = (int)(blockIdx.x % a.n_hg);
  const int rest = (int)(blockIdx.x / a.n_hg);
  const int kb = rest % a.n_kb, jb = rest / a.n_kb;
  const int g = (int)blockIdx.y;
  const int col0 = jb * BN;
  const int kc0 = kb * a.KB + warp * R;   // the warp's first key in the tile

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  int* lists = reinterpret_cast<int*>(smem + (size_t)NST * BM * KROW);
  float* k_s = reinterpret_cast<float*>(smem + key_walk_bytes(a.KB));
  float* v_s = k_s + (size_t)nthr * a.D;
  float* dk_s = v_s + (size_t)nthr * a.Dv;
  float* dv_s = dk_s + (size_t)nthr * a.D;

  const int kl = lane / HG, h = hg * HG + lane % HG;
  KeyItem it = key_item<kBf16>(a, g, col0 + kc0 + kl, h, lane < R * HG, tid,
                               nthr, k_s, v_s, dk_s, dv_s);
  const DenseKeyPairs pairs{(size_t)g * a.N, a.N, it.gc};

  const size_t walk = (size_t)g * a.n_t + jb;
  const int cnt = a.pcount[walk];
  const int* il = a.plan + walk * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  int* list = lists + (warp * R + (kl < R ? kl : 0)) * CAPR;
  const bool writer = lane < R * HG && lane % HG == 0;
  walk_key_mask<kVec16>(ring, list, mg, a.N, col0, kc0, kl, R, writer, il,
                        cnt, [&](int n) {
                          if constexpr (KEY_FLUSH)
                            key_pass<kBf16>(a, it, pairs, list, n, nthr);
                        });

  key_finish<kBf16>(a, it, dk_s, dv_s, tid, nthr);
}

template <bool kBf16>
int launch_rows(Bwd a, int G, void* stream) {
  if (bad_args(a, G)) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  warp_items(a.H, &a.HG, &a.R);
  const int n_hg = (a.H + a.HG - 1) / a.HG;
  const size_t smem = row_bytes(a.R, a.D, a.Dv);
  const auto kern = vec16_mask(a) ? row_walk_kernel<kBf16, true>
                                  : row_walk_kernel<kBf16, false>;
  const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.n_t * (BM / a.R)), G);
  // head groups one after another on the stream: each adds its dz into dB
  for (a.hg = 0; a.hg < n_hg; ++a.hg) {
    kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <bool kBf16>
int launch_keys(Bwd a, int G, void* stream) {
  if (bad_args(a, G)) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  if (!key_blocks(&a, [&](int KB) { return key_bytes(KB, a.R, a.D, a.Dv); }))
    return (int)cudaErrorInvalidValue;
  const size_t smem = key_bytes(a.KB, a.R, a.D, a.Dv);
  const auto kern = vec16_mask(a) ? key_walk_kernel<kBf16, true>
                                  : key_walk_kernel<kBf16, false>;
  const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.n_t * a.n_kb * a.n_hg), G);
  kern<<<grid, (a.KB / a.R) * WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int row_entry(const void* q, const void* k, const void* v, const void* mask,
              const void* bias, const void* dout, const void* lse1,
              const void* lse2, const void* delta2, const void* jlist,
              const void* jcount, const void* scale, const void* seeds,
              void* delta1, void* dbias, void* dq, void* dscale_part, int G,
              int H, int N, int D, int Dv, int n_i, int W, int metric,
              float sqrt_d, int use_dropout, unsigned int keep_thresh,
              float inv_keep, int need_dscale, void* stream) {
  Bwd a = common_args(q, k, v, mask, bias, dout, lse1, lse2, delta2, jlist,
                      jcount, scale, seeds, H, N, D, Dv, n_i, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1_out = (float*)delta1;
  a.dbias = (float*)dbias;
  a.dq = (float*)dq;
  a.dscale = (float*)dscale_part;
  a.need_dscale = need_dscale;
  return launch_rows<kBf16>(a, G, stream);
}

template <bool kBf16>
int key_entry(const void* q, const void* k, const void* v, const void* mask,
              const void* bias, const void* dout, const void* lse1,
              const void* lse2, const void* delta2, const void* delta1,
              const void* ilist, const void* icount, const void* scale,
              const void* seeds, void* dk, void* dv, int G, int H, int N,
              int D, int Dv, int n_j, int W, int metric, float sqrt_d,
              int use_dropout, unsigned int keep_thresh, float inv_keep,
              void* stream) {
  Bwd a = common_args(q, k, v, mask, bias, dout, lse1, lse2, delta2, ilist,
                      icount, scale, seeds, H, N, D, Dv, n_j, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1 = (const float*)delta1;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  return launch_keys<kBf16>(a, G, stream);
}

}  // namespace

// The row walk, B6 and B7a: delta1 [G, H, N], dB [G, N, N] (written at the
// mask's valid pairs only), dq [G, H, N, D] and, with need_dscale, each
// item's d(scale) term [G, H, N], over the forward walk (jlist, jcount
// [G, n_i, W], [G, n_i]) of the dense int8 mask [G, N, N], given lse1, lse2
// and delta2 [G, H, N], the head-shared bias [G, N, N] and two seeds per g,
// [G, 2].
extern "C" int tagan_flash_biased_bwd_row(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* jlist, const void* jcount,
    const void* scale, const void* seeds, void* delta1, void* dbias,
    void* dq, void* dscale_part, int G, int H, int N, int D, int Dv,
    int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, int need_dscale,
    void* stream) {
  return row_entry<false>(q, k, v, mask, bias, dout, lse1, lse2, delta2,
                          jlist, jcount, scale, seeds, delta1, dbias, dq,
                          dscale_part, G, H, N, D, Dv, n_i, W, metric, sqrt_d,
                          use_dropout, keep_thresh, inv_keep, need_dscale,
                          stream);
}

// The row walk's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_bwd_row_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* jlist, const void* jcount,
    const void* scale, const void* seeds, void* delta1, void* dbias,
    void* dq, void* dscale_part, int G, int H, int N, int D, int Dv,
    int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, int need_dscale,
    void* stream) {
  return row_entry<true>(q, k, v, mask, bias, dout, lse1, lse2, delta2,
                         jlist, jcount, scale, seeds, delta1, dbias, dq,
                         dscale_part, G, H, N, D, Dv, n_i, W, metric, sqrt_d,
                         use_dropout, keep_thresh, inv_keep, need_dscale,
                         stream);
}

// The key walk, B7b: dk [G, H, N, D] and dv [G, H, N, Dv] over the
// transposed walk (ilist, icount [G, n_j, W], [G, n_j]), given the row
// walk's delta1.
extern "C" int tagan_flash_biased_bwd_key(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* ilist,
    const void* icount, const void* scale, const void* seeds, void* dk,
    void* dv, int G, int H, int N, int D, int Dv, int n_j, int W, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return key_entry<false>(q, k, v, mask, bias, dout, lse1, lse2, delta2,
                          delta1, ilist, icount, scale, seeds, dk, dv, G, H,
                          N, D, Dv, n_j, W, metric, sqrt_d, use_dropout,
                          keep_thresh, inv_keep, stream);
}

// The key walk's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_bwd_key_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* ilist,
    const void* icount, const void* scale, const void* seeds, void* dk,
    void* dv, int G, int H, int N, int D, int Dv, int n_j, int W, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return key_entry<true>(q, k, v, mask, bias, dout, lse1, lse2, delta2,
                         delta1, ilist, icount, scale, seeds, dk, dv, G, H, N,
                         D, Dv, n_j, W, metric, sqrt_d, use_dropout,
                         keep_thresh, inv_keep, stream);
}
