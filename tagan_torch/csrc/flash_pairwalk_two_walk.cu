// Geometric attention's two-walk backward over the dense mask, as pair
// walks for Hopper (sm_90a): the row walk B3a (dq, d(scale)) and the key
// walk B3b (dk, dv), each in fp32 and bf16 (the template flag kBf16).
//
// Replaces the Pallas TPU kernels tagan_tpu/ops/pallas/flash_geometric.py::
// _flash_bwd_dq_kernel (pallas_call :1455) and _flash_bwd_dkv_kernel
// (pallas_call :1534) in their dense-mask forms (host side
// flash_geometric_attention_bwd with fused=False, launched :2009 and
// :2074), bf16=False and bf16=True. Over the mask's valid pairs (i, j), the
// row walk along the forward plan (jlist, jcount), the key walk along the
// transposed plan (ilist, icount):
//
//     p_ij  = exp(s_ij - lse_i),          dp_ij = drop(do_i . v_j),
//     ds_ij = p_ij (dp_ij - delta_i),     W_ij  = the chain weight of ds,
//     dq_i  = sum_j W_ij k_j,             dk_j  = sum_i W_ij q_i,
//     dv_j  = sum_i drop(p_ij) do_i,
//
// and the squared-distance metrics subtract (sum_j W_ij) q_i and
// (sum_i W_ij) k_j, q_i and k_j read unrounded. The row walk also writes
// each (row, head) item's d(scale) term, sum_j ds_ij s_ij sq_ij times the
// metric's factor, [G, H, N], which the caller sums in a fixed order.
// delta_i = do_i . out_i - dlse_i comes from the caller; a dead row (lse =
// 1e30) gives p = 0. drop is the JAX package's coordinate hash (keep_hash)
// at (i, j) with mix = seed[g] ^ h * 0xC2B2AE3D: the forward's dropout.
//  - fp32: every operand unrounded, W = chain_weight (the scaled dot's
//    1/sqrt(d) inside it), no TF32.
//  - bf16: q and k rounded to bf16 after their fp32 norms, do and v
//    rounded, W = chain_weight_bf16 and drop(p) rounded as operands of
//    their products; the scaled dot divides dq and dk by sqrt(d) at the
//    end (chain_finish). The norms, the sums of W, the q and k terms, the
//    d(scale) term and every sum stay fp32.
// p is normalised by the given lse and has no running max, so no walk
// order enters a pair's value; only the order of the fp32 sums does. The
// plain version is flash_geometric_backward_plain.
//
// The row walk (B3a). B2's walk (`walk_mask`, flash_pairwalk.cuh) with the
// compact row walk's flush and one pass: one warp is one block, R rows of
// one 64-row query tile for a group of HG <= 32 heads (`warp_items`), each
// lane one (row, head) item whose q and do (rounded in bf16) and dq
// accumulator stay in its shared slots (`row_item<kBf16, 1>`: one seed a
// g, lse and delta read; `row_finish<kBf16, 1>`). The mask is read once
// for the group's heads, each row's valid columns listed; when a row's
// list could pass CAPR, and at the end, the flush (`dq_pass`,
// flash_pairwalk_two_walk.cuh, shared with B3a c) gathers k_j and v_j at
// the listed pairs only. Past 32 heads the head groups are grid blocks,
// innermost, so that the groups of one sub-tile read its mask together:
// no head group reads another's output, so none waits for one.
//
// The key walk (B3b). B7b's block and walk (`walk_key_mask`,
// flash_pairwalk.cuh) with the compact key walk's flush: one block owns KB
// keys of one 64-key tile for up to KEY_HG = 8 heads (`key_blocks`), each
// lane one (key, head) item whose k_j and v_j (rounded in bf16) and dk_j
// and dv_j accumulators stay in its shared slots (`key_item<kBf16, 1>`,
// `key_finish`); head groups innermost in the grid. Each walked mask tile
// is copied whole by cp.async, each key's row word comes by ballots, its
// rows are listed, and the flush (`dkv_pass`, shared with B3b c) gathers
// q_i, do_i, lse_i and delta_i at the listed pairs only, summing dk_j and
// dv_j in ascending row order.
//
// Neither walk has an atomic: each output element is written by one lane
// in a fixed order, so repeated calls are bit-identical (the reason
// fused=False exists beside B2, whose dk, dv and d(scale) sum by atomics),
// and every row (key) before N is written, rows (keys) no pair reaches
// (an empty walk, dead rows, an empty key strip) as 0.
//
// What bounds them on the H100. Each snapshot's int8 mask is N^2 bytes (100
// MB at N = 10,000), read once by each walk; q, k, v, do, lse, delta, the
// plan and the outputs are small beside it. So the least time of each is
// the mask's bytes over the memory rate (0.034 ms at the model's shape),
// and the pairs' work (~3 to 4 products of head dim a pair and head) is
// far below the fp32 rate at the model's density. The 64 x 64 tile
// kernels these replace computed all 4,096 pairs of every walked tile for
// each head: at degree 16 a 10K row has ~16 valid pairs.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_pairwalk_two_walk.cuh"

namespace {

using namespace tagan_pairwalk;

// the flushes: false leaves each walk streaming and listing the mask alone
// (pairwalk_variants.py; its outputs are then not the function)
constexpr bool ROW_FLUSH = true;
constexpr bool KEY_FLUSH = true;

// ---------------------------------------------------------------------------
// The row walk (B3a)
// ---------------------------------------------------------------------------

// Bytes of one warp's (one block's) shared memory: the walk's, then q and
// do (rounded in bf16) and the dq accumulator, each [width][32 lanes].
__host__ __device__ inline size_t row_bytes(int R, int D, int Dv) {
  return walk_bytes(R) + row_item_bytes(D, Dv);
}

// No minimum of warps an SM, as B6 + B7a's dense row walk: with the
// compact row walk's minimum of 8 ptxas gave the fp32 walk 167-189
// registers and it ran ~1.4x the time of the walk at 128
// (pairwalk_variants.py's `rows8`; chip_smoke.py phase 1 logs ptxas's
// report).
template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(WARP) dq_walk_kernel(const Bwd a) {
  const int lane = threadIdx.x;
  const int R = a.R;
  // head groups innermost: the groups of one sub-tile read its mask
  // together
  const int hg = (int)(blockIdx.x % a.n_hg), sub = (int)(blockIdx.x / a.n_hg);
  const int g = (int)blockIdx.y;
  const int ib = sub / (BM / R), row0 = sub * R;

  extern __shared__ __align__(16) uint8_t smem[];
  const WalkSmem sm = walk_smem(smem, R);
  float* q_s = reinterpret_cast<float*>(sm.rest);
  float* do_s = q_s + WARP * a.D;
  float* dq_s = do_s + WARP * a.Dv;

  // the item: one seed a batch index, [G]
  size_t row;
  RowItem it =
      row_item<kBf16, 1>(a, g, row0, lane, hg, q_s, do_s, dq_s, &row);
  const int rl = lane / a.HG;
  const DenseRowPairs pairs{};    // the entry is the key; no bias here
  const size_t walk = (size_t)g * a.n_t + ib;
  const int cnt = a.pcount[walk];
  const int* jl = a.plan + walk * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  const int* list = sm.lists + (rl < R ? rl : 0) * CAPR;
  walk_mask<kVec16>(sm, mg, a.N, row0, R, jl, cnt, lane, [&]() {
    if constexpr (ROW_FLUSH)
      dq_pass<kBf16>(a, it, pairs, list, it.on ? sm.rowcnt[rl] : 0);
  });
  row_finish<kBf16, 1>(a, it, row, dq_s, lane);
}

template <bool kBf16>
int launch_rows(Bwd a, int G, void* stream) {
  if (bad_args(a, G)) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  warp_items(a.H, &a.HG, &a.R);
  a.n_hg = (a.H + a.HG - 1) / a.HG;
  const size_t smem = row_bytes(a.R, a.D, a.Dv);
  const auto kern = vec16_mask(a) ? dq_walk_kernel<kBf16, true>
                                  : dq_walk_kernel<kBf16, false>;
  const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.n_t * (BM / a.R) * a.n_hg), G);
  kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int dq_entry(const void* q, const void* k, const void* v, const void* mask,
             const void* dout, const void* lse, const void* delta,
             const void* jlist, const void* jcount, const void* scale,
             const void* seed, void* dq, void* dscale, int G, int H, int N,
             int D, int Dv, int n_i, int W, int metric, float sqrt_d,
             int use_dropout, unsigned int keep_thresh, float inv_keep,
             int need_dscale, void* stream) {
  // lse and delta ride in the biased walk's lse1 and delta1; no bias,
  // lse2 or delta2
  Bwd a = common_args(q, k, v, mask, nullptr, dout, lse, nullptr, nullptr,
                      jlist, jcount, scale, seed, H, N, D, Dv, n_i, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1 = (const float*)delta;
  a.dq = (float*)dq;
  a.dscale = (float*)dscale;
  a.need_dscale = need_dscale;
  return launch_rows<kBf16>(a, G, stream);
}

// ---------------------------------------------------------------------------
// The key walk (B3b)
// ---------------------------------------------------------------------------

// Bytes of one block: the ring and the keys' lists, then k and v (rounded
// in bf16) and the dk and dv accumulators, each [width][threads].
__host__ __device__ inline size_t key_bytes(int KB, int R, int D, int Dv) {
  return key_walk_bytes(KB) + key_item_bytes(KB, R, D, Dv);
}

// One block of up to KEY_WARPS warps an SM at least, as B7b's key walk.
template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(KEY_WARPS * WARP, 1)
dkv_walk_kernel(const Bwd a) {
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

  // the item: one seed a batch index, [G]
  const int kl = lane / HG, h = hg * HG + lane % HG;
  KeyItem it = key_item<kBf16, 1>(a, g, col0 + kc0 + kl, h, lane < R * HG,
                                  tid, nthr, k_s, v_s, dk_s, dv_s);
  const DenseKeyPairs pairs{};    // the entry is the row; no bias here
  const size_t walk = (size_t)g * a.n_t + jb;
  const int cnt = a.pcount[walk];
  const int* il = a.plan + walk * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  int* list = lists + (warp * R + (kl < R ? kl : 0)) * CAPR;
  const bool writer = lane < R * HG && lane % HG == 0;
  walk_key_mask<kVec16>(ring, list, mg, a.N, col0, kc0, kl, R, writer, il,
                        cnt, [&](int n) {
                          if constexpr (KEY_FLUSH)
                            dkv_pass<kBf16>(a, it, pairs, list, n, nthr);
                        });
  key_finish<kBf16>(a, it, dk_s, dv_s, tid, nthr);
}

template <bool kBf16>
int launch_keys(Bwd a, int G, void* stream) {
  if (bad_args(a, G)) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  if (!key_blocks(&a, [&](int KB) { return key_bytes(KB, a.R, a.D, a.Dv); }))
    return (int)cudaErrorInvalidValue;
  const size_t smem = key_bytes(a.KB, a.R, a.D, a.Dv);
  const auto kern = vec16_mask(a) ? dkv_walk_kernel<kBf16, true>
                                  : dkv_walk_kernel<kBf16, false>;
  const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.n_t * a.n_kb * a.n_hg), G);
  kern<<<grid, (a.KB / a.R) * WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int dkv_entry(const void* q, const void* k, const void* v, const void* mask,
              const void* dout, const void* lse, const void* delta,
              const void* ilist, const void* icount, const void* scale,
              const void* seed, void* dk, void* dv, int G, int H, int N,
              int D, int Dv, int n_j, int W, int metric, float sqrt_d,
              int use_dropout, unsigned int keep_thresh, float inv_keep,
              void* stream) {
  // lse and delta ride in the biased walk's lse1 and delta1 (the key
  // walk's row statistics); no bias, lse2 or delta2
  Bwd a = common_args(q, k, v, mask, nullptr, dout, lse, nullptr, nullptr,
                      ilist, icount, scale, seed, H, N, D, Dv, n_j, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1 = (const float*)delta;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  return launch_keys<kBf16>(a, G, stream);
}

}  // namespace

// B3a: dq [G, H, N, D] and, with need_dscale, each (row, head) item's
// d(scale) term [G, H, N] (summed by the caller) over the forward walk
// (jlist, jcount [G, n_i, W], [G, n_i]) of the dense int8 mask [G, N, N],
// given q, k [G, H, N, D], v, do [G, H, N, Dv], lse and delta [G, H, N],
// scale f32[H] and one seed per g, i32[G].
extern "C" int tagan_flash_geometric_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* scale, const void* seed, void* dq,
    void* dscale, int G, int H, int N, int D, int Dv, int n_i, int W,
    int metric, float sqrt_d, int use_dropout, unsigned int keep_thresh,
    float inv_keep, int need_dscale, void* stream) {
  return dq_entry<false>(q, k, v, mask, dout, lse, delta, jlist, jcount,
                         scale, seed, dq, dscale, G, H, N, D, Dv, n_i, W,
                         metric, sqrt_d, use_dropout, keep_thresh, inv_keep,
                         need_dscale, stream);
}

// B3a's bf16 form: the same arguments.
extern "C" int tagan_flash_geometric_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* scale, const void* seed, void* dq,
    void* dscale, int G, int H, int N, int D, int Dv, int n_i, int W,
    int metric, float sqrt_d, int use_dropout, unsigned int keep_thresh,
    float inv_keep, int need_dscale, void* stream) {
  return dq_entry<true>(q, k, v, mask, dout, lse, delta, jlist, jcount,
                        scale, seed, dq, dscale, G, H, N, D, Dv, n_i, W,
                        metric, sqrt_d, use_dropout, keep_thresh, inv_keep,
                        need_dscale, stream);
}

// B3b: dk [G, H, N, D] and dv [G, H, N, Dv] over the transposed walk
// (ilist, icount [G, n_j, W], [G, n_j]) of the dense int8 mask [G, N, N],
// given q, k [G, H, N, D], v, do [G, H, N, Dv], lse and delta [G, H, N],
// scale f32[H] and one seed per g, i32[G].
extern "C" int tagan_flash_geometric_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* ilist,
    const void* icount, const void* scale, const void* seed, void* dk,
    void* dv, int G, int H, int N, int D, int Dv, int n_j, int W, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return dkv_entry<false>(q, k, v, mask, dout, lse, delta, ilist, icount,
                          scale, seed, dk, dv, G, H, N, D, Dv, n_j, W, metric,
                          sqrt_d, use_dropout, keep_thresh, inv_keep, stream);
}

// B3b's bf16 form: the same arguments.
extern "C" int tagan_flash_geometric_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* ilist,
    const void* icount, const void* scale, const void* seed, void* dk,
    void* dv, int G, int H, int N, int D, int Dv, int n_j, int W, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return dkv_entry<true>(q, k, v, mask, dout, lse, delta, ilist, icount,
                         scale, seed, dk, dv, G, H, N, D, Dv, n_j, W, metric,
                         sqrt_d, use_dropout, keep_thresh, inv_keep, stream);
}
