// Geometric attention's backward over the hybrid band's compact store, as
// pair walks for Hopper (sm_90a): the row walk B3a c (dq, d(scale)) and
// the key walk B3b c (dk, dv), each in fp32 and bf16 (the template flag
// kBf16).
//
// Replaces the Pallas TPU kernels tagan_tpu/ops/pallas/flash_geometric.py::
// _flash_bwd_dq_kernel (pallas_call :1455) and _flash_bwd_dkv_kernel
// (pallas_call :1534) in their compact occupied-block forms (3-tuple plans:
// the hybrid backend's band; host side flash_geometric_attention_bwd,
// launched :2009 and :2074), bf16=False and bf16=True. Over the store's
// valid pairs (i, j), the row walk along the forward walk (jlist, jcount,
// jslot), the key walk along the transposed walk (ilist, icount, islot):
//
//     p_ij  = exp(s_ij - lse_i),          dp_ij = drop(do_i . v_j),
//     ds_ij = p_ij (dp_ij - delta_i),     W_ij  = the chain weight of ds,
//     dq_i  = sum_j W_ij k_j,             dk_j  = sum_i W_ij q_i,
//     dv_j  = sum_i drop(p_ij) do_i,
//
// and the squared-distance metrics subtract (sum_j W_ij) q_i and
// (sum_i W_ij) k_j, q_i and k_j read unrounded at their global row. The
// row walk also writes each (row, head) item's d(scale) term,
// sum_j ds_ij s_ij sq_ij times the metric's factor, which the caller sums.
// delta_i = do_i . out_i - dlse_i comes from the caller; a dead row (lse =
// 1e30) gives p = 0. drop is the JAX package's coordinate hash (keep_hash)
// at the global (i, j) with mix = seed[g] ^ h * 0xC2B2AE3D: the forward's
// dropout.
//  - fp32: every operand unrounded, W = chain_weight (the scaled dot's
//    1/sqrt(d) inside it), no TF32.
//  - bf16: q and k rounded to bf16 after their fp32 norms, do and v
//    rounded, W = chain_weight_bf16 and drop(p) rounded as operands of
//    their products; the scaled dot divides dq and dk by sqrt(d) at the
//    end (chain_finish). The norms, the sums of W, the q and k terms, the
//    d(scale) term and every sum stay fp32.
// p is normalised by the given lse and has no running max, so no walk
// order enters a pair's value; only the order of the fp32 sums does. The
// plain version is flash_geometric_backward_compact_plain.
//
// The row walk (B3a c). The compact biased backward's row walk
// (flash_pairwalk_biased_bwd_compact.cu, B6c + B7a c) with the unbiased
// per-pair function and one pass: no row statistic is formed here. One
// warp is one block: R rows of one 64-row query tile for a group of
// HG <= 32 heads, each lane one (row, head) item (`warp_items`) whose q and
// do (rounded in bf16) and dq accumulator stay in its shared slots
// (`row_item<kBf16, 1>`: one seed a g, lse and delta read; `row_finish`);
// past 32 heads the head groups are grid blocks, innermost, as in the
// compact forward walk, so the groups of one sub-tile walk its slots
// together (no cross-head sum: nothing is shared between heads). The slot
// walk of flash_pairwalk_slots.cuh (`walk_slots`, shared with B1c, B5c
// and B6c + B7a c) copies each step's row words by cp.async NST - 1 steps
// ahead and lists each row's valid columns; when a row's list could pass
// CAPR, and at the end, the flush (`dq_pass`, flash_pairwalk_two_walk.cuh,
// shared with the dense B3a) gathers k_j and v_j
// (16 bytes at a time where aligned) at the listed pairs only, recomputes
// s, p and dp, and sums dq_i and the d(scale) term in the walk's order.
//
// The key walk (B3b c). The compact biased backward's key walk (B7b c)
// with the unbiased per-pair function. One block owns KB keys of one
// 64-key tile for up to KEY_HG = 8 heads (`key_blocks`: KB halved until
// the block's shared memory fits), each lane one (key, head) item whose
// k_j and v_j (rounded in bf16) and dk_j and dv_j accumulators stay in its
// shared slots (`key_item`, `key_finish`); head groups are innermost in the
// grid, so the blocks that read one slot run together. The key slot walk
// of flash_pairwalk_slots.cuh (`walk_key_slots`, shared with B7b c) copies
// each walked slot's 64 row words (512 B) by cp.async NST - 1 steps ahead,
// one block barrier a step, ballots each key's row word and lists its
// rows; the flush (`dkv_pass`, flash_pairwalk_two_walk.cuh, shared with
// the dense B3b) gathers q_i and do_i (16 bytes at a
// time where aligned), lse_i and delta_i at the listed pairs only,
// recomputes s, p and dp and sums dk_j and dv_j in the walk's row order.
//
// Neither walk has an atomic: each output element is written by one lane,
// so repeated calls are bit-identical, and every row (key) before N is
// written, rows (keys) no pair reaches (an empty walk, slots whose bits are
// all 0, dead rows) as 0.
//
// What bounds them on the H100. The store is 512 B a walked tile (17.8 MB
// a 131K snapshot); q, k, v, do, lse, delta and the walk are read once and
// dq (the row walk) or dk and dv (the key walk) written once: ~0.057 and
// ~0.067 ms at 3.35 TB/s. The pairs' products (~3 to 4 of head dim a pair
// and head) are far below the fp32 rate. The band holds ~61 valid pairs a
// walked tile (~1 a row), so the flushes' gathers set the pace, where a
// tile walk computes all 4,096 pairs of every walked tile once per head.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_pairwalk_slots.cuh"
#include "flash_pairwalk_two_walk.cuh"

namespace {

using namespace tagan_pairwalk;

// the flushes: false leaves each walk walking the slots and listing each
// row's keys (each key's rows) alone (pairwalk_variants.py; its outputs are
// then not the function)
constexpr bool ROW_FLUSH = true;
constexpr bool KEY_FLUSH = true;

// ---------------------------------------------------------------------------
// The row walk (B3a c)
// ---------------------------------------------------------------------------

// Bytes of a row walk warp: its slot walk and its items.
__host__ __device__ inline size_t row_bytes(int R, int D, int Dv) {
  return slot_walk_bytes(R) + row_item_bytes(D, Dv);
}

// At least 8 warps an SM, as the other compact one-warp walks: without a
// minimum, ptxas holds a one-warp-block walk to 64-72 registers and spills
// (chip_smoke.py phase 1 logs ptxas's report).
template <bool kBf16, int kForm>
__global__ void __launch_bounds__(WARP, 8) dq_row_walk_kernel(const Bwd a) {
  const int lane = threadIdx.x;
  const int R = a.R;
  // head groups innermost: the groups of one sub-tile walk its slots
  // together
  const int hg = (int)(blockIdx.x % a.n_hg), sub = (int)(blockIdx.x / a.n_hg);
  const int g = (int)blockIdx.y;
  const int ib = sub / (BM / R), row0 = sub * R, rr0 = row0 - ib * BM;

  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* ring = reinterpret_cast<uint64_t*>(smem);
  int* lists = reinterpret_cast<int*>(smem + (size_t)NST * R * 8);
  int* rowcnt = lists + R * CAPR;
  float* q_s = reinterpret_cast<float*>(smem + slot_walk_bytes(R));
  float* do_s = q_s + WARP * a.D;
  float* dq_s = do_s + WARP * a.Dv;

  // the item: one seed a batch index, [G]
  size_t row;
  RowItem it =
      row_item<kBf16, 1>(a, g, row0, lane, hg, q_s, do_s, dq_s, &row);
  const int rl = lane / a.HG;
  const size_t walk = (size_t)g * a.n_t + ib;
  const int cnt = a.pcount[walk];
  const int* jl = a.plan + walk * a.W;
  const int* js = a.pslot + walk * a.W;
  const CompactRowPairs pairs{jl, js, (size_t)g * a.S, it.gr & (BM - 1)};
  const uint8_t* st =
      a.mask + (size_t)g * a.S * BM * row_store_bytes<kForm>();
  const int* list = lists + (rl < R ? rl : 0) * CAPR;
  walk_slots<kForm>(ring, lists, rowcnt, st, a.N, row0, rr0, R, jl, js, cnt,
                    lane, [&]() {
                      if constexpr (ROW_FLUSH)
                        dq_pass<kBf16>(a, it, pairs, list,
                                       it.on ? rowcnt[rl] : 0);
                    });
  row_finish<kBf16, 1>(a, it, row, dq_s, lane);
}

template <bool kBf16, int kForm>
int launch_rows(Bwd a, int G, void* stream) {
  if (bad_args(a, G) || a.S < 1) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  warp_items(a.H, &a.HG, &a.R);
  a.n_hg = (a.H + a.HG - 1) / a.HG;
  const size_t smem = row_bytes(a.R, a.D, a.Dv);
  const auto kern = dq_row_walk_kernel<kBf16, kForm>;
  const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.n_t * (BM / a.R) * a.n_hg), G);
  kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int dq_entry(const void* q, const void* k, const void* v, const void* store,
             const void* dout, const void* lse, const void* delta,
             const void* jlist, const void* jcount, const void* jslot,
             const void* scale, const void* seed, void* dq,
             void* dscale_part, int G, int H, int N, int D, int Dv, int n_i,
             int W, int S, int packed, int metric, float sqrt_d,
             int use_dropout, unsigned int keep_thresh, float inv_keep,
             int need_dscale, void* stream) {
  // lse and delta ride in the biased walk's lse1 and delta1; no bias,
  // lse2 or delta2
  Bwd a = common_args(q, k, v, store, nullptr, dout, lse, nullptr, nullptr,
                      jlist, jcount, scale, seed, H, N, D, Dv, n_i, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1 = (const float*)delta;
  a.pslot = (const int*)jslot;
  a.S = S;
  a.dq = (float*)dq;
  a.dscale = (float*)dscale_part;
  a.need_dscale = need_dscale;
  return packed ? launch_rows<kBf16, COMPACT_BITS>(a, G, stream)
                : launch_rows<kBf16, COMPACT_I8>(a, G, stream);
}

// ---------------------------------------------------------------------------
// The key walk (B3b c)
// ---------------------------------------------------------------------------

// Bytes of a key walk block: its slot walk (ring and lists) and its items.
__host__ __device__ inline size_t key_bytes(int KB, int R, int D, int Dv) {
  return slot_key_walk_bytes(KB) + key_item_bytes(KB, R, D, Dv);
}

// One block of up to KEY_WARPS warps an SM at least, as the biased key
// walks (chip_smoke.py phase 1 logs ptxas's report).
template <bool kBf16, int kForm>
__global__ void __launch_bounds__(KEY_WARPS * WARP, 1)
dkv_key_walk_kernel(const Bwd a) {
  const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;
  const int nthr = blockDim.x;
  const int R = a.R, HG = a.HG;
  // head groups innermost, then the key blocks of one tile: the blocks
  // that read one slot run together
  const int hg = (int)(blockIdx.x % a.n_hg);
  const int rest = (int)(blockIdx.x / a.n_hg);
  const int kb = rest % a.n_kb, jb = rest / a.n_kb;
  const int g = (int)blockIdx.y;
  const int col0 = jb * BN;
  const int kc0 = kb * a.KB + warp * R;   // the warp's first key in the tile

  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* ring = reinterpret_cast<uint64_t*>(smem);    // [NST][64]
  int* lists = reinterpret_cast<int*>(smem + (size_t)NST * BM * 8);
  float* k_s = reinterpret_cast<float*>(smem + slot_key_walk_bytes(a.KB));
  float* v_s = k_s + (size_t)nthr * a.D;
  float* dk_s = v_s + (size_t)nthr * a.Dv;
  float* dv_s = dk_s + (size_t)nthr * a.D;

  // the item: one seed a batch index, [G]
  const int kl = lane / HG, h = hg * HG + lane % HG;
  KeyItem it = key_item<kBf16, 1>(a, g, col0 + kc0 + kl, h, lane < R * HG,
                                  tid, nthr, k_s, v_s, dk_s, dv_s);
  const size_t walk = (size_t)g * a.n_t + jb;
  const int cnt = a.pcount[walk];
  const int* il = a.plan + walk * a.W;
  const int* isl = a.pslot + walk * a.W;
  const CompactKeyPairs pairs{il, isl, (size_t)g * a.S, kc0 + kl};
  const uint8_t* st =
      a.mask + (size_t)g * a.S * BM * row_store_bytes<kForm>();
  int* list = lists + (warp * R + (kl < R ? kl : 0)) * CAPR;
  const bool writer = lane < R * HG && lane % HG == 0;
  const bool key_in = col0 + kc0 + kl < a.N;
  walk_key_slots<kForm>(ring, list, st, a.N, kc0, kl, R, writer, key_in, il,
                        isl, cnt, [&](int n) {
                          if constexpr (KEY_FLUSH)
                            dkv_pass<kBf16>(a, it, pairs, list, n, nthr);
                        });
  key_finish<kBf16>(a, it, dk_s, dv_s, tid, nthr);
}

template <bool kBf16, int kForm>
int launch_keys(Bwd a, int G, void* stream) {
  if (bad_args(a, G) || a.S < 1) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  if (!key_blocks(&a, [&](int KB) { return key_bytes(KB, a.R, a.D, a.Dv); }))
    return (int)cudaErrorInvalidValue;
  const size_t smem = key_bytes(a.KB, a.R, a.D, a.Dv);
  const auto kern = dkv_key_walk_kernel<kBf16, kForm>;
  const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.n_t * a.n_kb * a.n_hg), G);
  kern<<<grid, (a.KB / a.R) * WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int dkv_entry(const void* q, const void* k, const void* v, const void* store,
              const void* dout, const void* lse, const void* delta,
              const void* ilist, const void* icount, const void* islot,
              const void* scale, const void* seed, void* dk, void* dv, int G,
              int H, int N, int D, int Dv, int n_j, int W, int S, int packed,
              int metric, float sqrt_d, int use_dropout,
              unsigned int keep_thresh, float inv_keep, void* stream) {
  // lse and delta ride in the biased walk's lse1 and delta1 (the key
  // walk's row statistics); no bias, lse2 or delta2
  Bwd a = common_args(q, k, v, store, nullptr, dout, lse, nullptr, nullptr,
                      ilist, icount, scale, seed, H, N, D, Dv, n_j, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1 = (const float*)delta;
  a.pslot = (const int*)islot;
  a.S = S;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  return packed ? launch_keys<kBf16, COMPACT_BITS>(a, G, stream)
                : launch_keys<kBf16, COMPACT_I8>(a, G, stream);
}

}  // namespace

// B3a c: dq [G, H, N, D] and, with need_dscale, each (row, head) item's
// d(scale) term [G, H, N] (summed by the caller) over the forward walk
// (jlist, jcount, jslot [G, n_i, W], [G, n_i], [G, n_i, W]) of the compact
// store, bits i64[G, S, 64] (packed) or int8 [G, S, 64, 64], 16-byte
// aligned, given q, k [G, H, N, D], v, do [G, H, N, Dv], lse and delta
// [G, H, N], scale f32[H] and one seed per g, i32[G].
extern "C" int tagan_flash_geometric_bwd_dq_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* jslot, const void* scale,
    const void* seed, void* dq, void* dscale_part, int G, int H, int N,
    int D, int Dv, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    int need_dscale, void* stream) {
  return dq_entry<false>(q, k, v, store, dout, lse, delta, jlist, jcount,
                         jslot, scale, seed, dq, dscale_part, G, H, N, D, Dv,
                         n_i, W, S, packed, metric, sqrt_d, use_dropout,
                         keep_thresh, inv_keep, need_dscale, stream);
}

// B3a c's bf16 form: the same arguments.
extern "C" int tagan_flash_geometric_bwd_dq_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* jslot, const void* scale,
    const void* seed, void* dq, void* dscale_part, int G, int H, int N,
    int D, int Dv, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    int need_dscale, void* stream) {
  return dq_entry<true>(q, k, v, store, dout, lse, delta, jlist, jcount,
                        jslot, scale, seed, dq, dscale_part, G, H, N, D, Dv,
                        n_i, W, S, packed, metric, sqrt_d, use_dropout,
                        keep_thresh, inv_keep, need_dscale, stream);
}

// B3b c: dk [G, H, N, D] and dv [G, H, N, Dv] over the transposed walk
// (ilist, icount, islot [G, n_j, W], [G, n_j], [G, n_j, W]) of the compact
// store, bits i64[G, S, 64] (packed) or int8 [G, S, 64, 64], 16-byte
// aligned (islot names the same (row tile, key tile) slots as the forward
// walk), given q, k [G, H, N, D], v, do [G, H, N, Dv], lse and delta
// [G, H, N], scale f32[H] and one seed per g, i32[G].
extern "C" int tagan_flash_geometric_bwd_dkv_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* dout, const void* lse, const void* delta, const void* ilist,
    const void* icount, const void* islot, const void* scale,
    const void* seed, void* dk, void* dv, int G, int H, int N, int D, int Dv,
    int n_j, int W, int S, int packed, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return dkv_entry<false>(q, k, v, store, dout, lse, delta, ilist, icount,
                          islot, scale, seed, dk, dv, G, H, N, D, Dv, n_j, W,
                          S, packed, metric, sqrt_d, use_dropout, keep_thresh,
                          inv_keep, stream);
}

// B3b c's bf16 form: the same arguments.
extern "C" int tagan_flash_geometric_bwd_dkv_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* dout, const void* lse, const void* delta, const void* ilist,
    const void* icount, const void* islot, const void* scale,
    const void* seed, void* dk, void* dv, int G, int H, int N, int D, int Dv,
    int n_j, int W, int S, int packed, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return dkv_entry<true>(q, k, v, store, dout, lse, delta, ilist, icount,
                         islot, scale, seed, dk, dv, G, H, N, D, Dv, n_j, W, S,
                         packed, metric, sqrt_d, use_dropout, keep_thresh,
                         inv_keep, stream);
}
