// Edge-biased geometric attention, backward, over the compact store, for
// Hopper (sm_90a): three kernels.
//
// Replaces the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// that differentiate the dense path's double softmax, in their compact
// occupied-block form (B6c, B7a c, B7b c: the hybrid backend's band, host
// side tagan_tpu/ops/pallas/hybrid_biased.py _band_bwd_pre and
// _band_bwd_dq_dkv). Their dense-mask forms, B6, B7a and B7b, are the row
// and key pair walks of flash_pairwalk_biased_bwd.cu. The forward (B4c, B5c
// in flash_biased_fwd.cu) computed, per query row i, head h and valid key j
// (the store's bit at (i, j)), with s_ij the metric score:
//
//   w1 = exp(s - lse1),  w1d = drop1(w1),  z = w1d + B,
//   w2 = exp(z - lse2),  out_i = sum_j drop2(w2)_ij v_j.
//
// Each kernel recomputes these per pair (_bwd_biased_common) and, with
// dp2 = drop2(do_i . v_j), dz = w2 (dp2 - delta2_i), dw1 = drop1(dz) and
// ds = w1 (dw1 - delta1_i):
//
//   B6c   _biased_bwd_pre_kernel  delta1_i = sum_j w1 dw1  (per head)
//                                 dB_ij = sum_h dz         (head-shared B)
//   B7a c _biased_bwd_dq_kernel   dq_i = sum_j W_ij k_j, and d(scale)
//   B7b c _biased_bwd_dkv_kernel  dk_j = sum_i W_ij q_i,
//                                 dv_j = sum_i drop2(w2)_ij do_i
//
// where W is the metric's chain weight of ds (flash_geometric_common.cuh:
// chain_weight; the squared-distance metrics also subtract (sum_j W_ij) q_i
// and (sum_i W_ij) k_j). A dropped w1 is not a masked pair: z = B there, so dz
// and dB are non-zero while dw1 = 0. lse1, lse2, delta2 = rowsum(do * out) and
// (for B7a c, B7b c) delta1 are inputs, as in the TPU kernels: the hybrid
// backend passes statistics of a union of walks. Rows with lse = 1e30 (no
// valid key) give 0.
//
// Design. B6c keeps the TPU's order with the heads innermost: one thread
// block per (64-row query tile, folded batch index g) walks jlist[g, tile,
// :jcount] and, at each walked tile, loops over the H heads. Each thread
// sums its 4x4 pairs' dz over the heads in registers and writes its part of
// the dB slot once: no atomics. delta1 is summed per (row, head) in shared
// memory across the walk and written at the end; it is deterministic. B7a c
// and B7b c are B3a c and B3b c (flash_geometric_bwd.cuh) with this
// recompute: one block per (tile, head, g) on the forward walk (dq, and a
// d(scale) partial per block summed by the caller) or on the transposed walk
// (dk, dv), accumulators in registers, templated on the 16-wide feature
// lanes. Thread (rg, lane) owns query rows 4*rg..4*rg+3 and keys lane + 16*b
// (b < 4), as in every kernel here.
//
// Each step loads its store tile (slot g * S + jslot, or islot for B7b c:
// the same tile, row = query, column = key; there is no transposed store)
// into 64 row words in dynamic shared memory past the tiles, and reads the
// bias from the same slot of the bias store, [G, S, 64, 64]. B6c writes dB
// into the slots of the walked tiles, every pair (0 off the mask); slots no
// walk visits are left as they were, so the caller passes dB zeroed. Slot
// offsets are size_t: S * 64 * 64 passes 2^31 past ~130K slots.
//
// The bf16 forms (kBf16; the TPU kernels' bf16=True) round the operands of
// every product as B3a c's and B3b c's bf16 forms do
// (flash_geometric_common.cuh): q.k from tiles rounded in place after their
// norms, do.v from do and v rounded as staged, the chain's W k and W q with
// W = chain_weight_bf16 rounded as each product loads it (dq and dk sums
// finished by chain_finish), and dv = drop2(w2)^T do with drop2(w2) stored
// rounded. w1, z, w2, dz, delta1, dB and the squared-distance metrics' sums
// of W and their q and k terms (read unrounded from global memory) stay
// fp32. The backward normalises by lse1 and lse2, so no walk order enters.
//
// What bounds it on the H100. The work the data needs is ~2 to 6 products of
// head dim per valid pair and head; what must move is q, k, v, do, the row
// statistics, the store, the f32 bias and dB slots and the outputs. The
// walks visit only the band's occupied tiles: at one 131K hybrid snapshot
// ~35K tiles per head with ~1/60 of their pairs valid, and dB is written at
// 16 KB per walked tile. fp32 issue on the CUDA cores per walked pair sets
// the pace, far above that bound.
//
// The kernels and their entry templates live in flash_biased_bwd.cuh. This
// file holds the entries of the fp32 forms; flash_biased_bwd_compact_bf16.cu
// holds the bf16 forms' entries, so that nvcc builds their 24 instantiations
// beside this file's rather than after them.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_biased_bwd.cuh"

using namespace tagan_flash;

// B6c: delta1 [G, H, N] and dB over the compact store of S slots per g,
// bits i64[G, S, 64] (packed) or int8 [G, S, 64, 64], with the slot of each
// walk step, jslot [G, n_i, W], given lse1, lse2 and delta2 [G, H, N] and two
// seeds per g, [G, 2]; the bias and dB in the same slots, f32[G, S, 64, 64].
// dB is written on the walked slots only: pass it zeroed.
extern "C" int tagan_flash_biased_bwd_pre_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* jlist, const void* jcount,
    const void* jslot, const void* scale, const void* seeds, void* delta1,
    void* dbias, int G, int H, int N, int D, int Dv, int n_i, int W, int S,
    int packed, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
  return (packed ? pre_entry<COMPACT_BITS> : pre_entry<COMPACT_I8>)(
      q, k, v, store, bias, dout, lse1, lse2, delta2, jlist, jcount, jslot,
      scale, seeds, delta1, dbias, G, H, N, D, Dv, n_i, W, S, metric, sqrt_d,
      use_dropout, keep_thresh, inv_keep, stream);
}

// B7a c: dq [G, H, N, D] and, with need_dscale, the d(scale) partials
// [G, H, n_i] over the compact store and the bias store, the forward walk
// with its slots, given B6c's delta1.
extern "C" int tagan_flash_biased_bwd_dq_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* jlist,
    const void* jcount, const void* jslot, const void* scale,
    const void* seeds, void* dq, void* dscale_part, int G, int H, int N,
    int D, int Dv, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    int need_dscale, void* stream) {
  return (packed ? dq_entry<COMPACT_BITS> : dq_entry<COMPACT_I8>)(
      q, k, v, store, bias, dout, lse1, lse2, delta2, delta1, jlist, jcount,
      jslot, scale, seeds, dq, dscale_part, G, H, N, D, Dv, n_i, W, S, metric,
      sqrt_d, use_dropout, keep_thresh, inv_keep, need_dscale, stream);
}

// B7b c: dk [G, H, N, D] and dv [G, H, N, Dv] over the compact store and
// the bias store, the transposed walk (ilist, icount) naming each step's
// slot of the same stores, islot [G, n_j, W].
extern "C" int tagan_flash_biased_bwd_dkv_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* ilist,
    const void* icount, const void* islot, const void* scale,
    const void* seeds, void* dk, void* dv, int G, int H, int N, int D,
    int Dv, int n_j, int W, int S, int packed, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return (packed ? dkv_entry<COMPACT_BITS> : dkv_entry<COMPACT_I8>)(
      q, k, v, store, bias, dout, lse1, lse2, delta2, delta1, ilist, icount,
      islot, scale, seeds, dk, dv, G, H, N, D, Dv, n_j, W, S, metric, sqrt_d,
      use_dropout, keep_thresh, inv_keep, stream);
}
