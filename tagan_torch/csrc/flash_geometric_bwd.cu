// Block-sparse edge-masked geometric attention, two-walk backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels tagan_tpu/ops/pallas/flash_geometric.py::
// _flash_bwd_dq_kernel (B3a) and _flash_bwd_dkv_kernel (B3b), host side
// flash_geometric_attention_bwd with fused=False, in their dense-mask form
// and the bf16 form (bf16=True) of each. Their compact occupied-block forms
// (B3a c and B3b c: 3-tuple plans, the hybrid backend's band) are the row
// and key pair walks of flash_pairwalk_bwd_compact.cu. For query row i,
// key j, head h, with
// p_ij = exp(s_ij - lse_i) on the mask,
//
//     dp_ij = drop(do_i . v_j),   ds_ij = p_ij (dp_ij - delta_i)
//     dq_i  = sum_j W_ij k_j,     dk_j = sum_i W_ij q_i,
//     dv_j  = sum_i drop(p_ij) do_i
//
// where W is the metric's chain weight (flash_geometric_common.cuh:
// chain_weight; the squared-distance metrics also subtract
// (sum_j W_ij) q_i and (sum_i W_ij) k_j) and delta_i = do_i . out_i - dlse_i
// comes from the caller (dlse: the cotangent of the forward's lse, which
// the hybrid band's logsumexp merge gives). The dropout keep bits are the
// forward's hash on global (row, col, head) coordinates, so both walks see
// the forward's mask.
//
// Design. B3a: one thread block per (64-row query tile, head, folded index
// g), walking jlist[g, tile, :jcount] as the forward does; the query tile,
// its dO, lse and delta stay in shared memory, dq accumulates in registers,
// and a d(scale) partial per block goes to [G, H, n_i] (summed by the
// caller). B3b: one block per (64-key tile, head, g), walking the
// transposed plan ilist[g, tile, :icount]; dk and dv accumulate in
// registers. Both are deterministic: every output element is written by
// one block in a fixed order. A key strip or query tile with an empty walk
// writes zeros, and a dead row (lse = 1e30) gives p = 0 on every pair.
// Thread (rg, lane) recomputes the 4 x 4 pairs of B1's layout; the
// accumulators are templated on the 16-wide feature lanes (D, Dv <= 16,
// 32, 64 or 128) so head dim 16 holds one lane.
//
// The bf16 forms (kBf16) are the same walks with every
// product's operands rounded to bf16 (flash_geometric_common.cuh: rd,
// chain_weight_bf16): q.k, do.v, W k, W q and drop(p) do, from q and k
// tiles rounded in place after their norms and do and v rounded as staged;
// the row norms, the squared-distance metrics' sums of W and their q and k
// terms (read unrounded from global memory at the global row or
// column), and the d(scale) sum stay fp32.
//
// The kernels and their launchers are in flash_geometric_bwd.cuh; this
// file instantiates them.
//
// What bounds it on the H100. The work the data needs is ~5 products of
// head dim per valid pair; what must move is q, k, v, do, lse, delta, the
// mask (dense int8 [N, N]) and dq, dk, dv, so the
// least time is those bytes over the memory rate. With uniformly random
// edges nearly every 64 x 64 block is occupied and both walks visit ~N^2
// pairs per head, so like B1 the kernels are bound by fp32 issue on the
// CUDA cores, far above that bound. At the model's shape (one snapshot,
// H=4, N=10,000, head dim 16) the bound is 0.034 ms for each kernel
// (~113-116 MB at 3.35 TB/s); chip_smoke.py phase 5 times both kernels
// against it. Tensor cores, TMA and a walk over edges are later steps.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_geometric_bwd.cuh"

using namespace tagan_flash;

// B3a: dq [G, H, N, D] and, with need_dscale, the d(scale) partials
// [G, H, n_i] of the forward walk (jlist, jcount) over the dense int8 mask
// [G, N, N].
extern "C" int tagan_flash_geometric_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* scale, const void* seed, void* dq,
    void* dscale_part, int G, int H, int N, int D, int Dv, int n_i, int W,
    int metric, float sqrt_d, int use_dropout, unsigned int keep_thresh,
    float inv_keep, int need_dscale, void* stream) {
  return dq_entry<DENSE_MASK>(q, k, v, mask, dout, lse, delta, jlist, jcount,
                              jlist, scale, seed, dq, dscale_part, G, H, N, D,
                              Dv, n_i, W, 0, metric, sqrt_d, use_dropout,
                              keep_thresh, inv_keep, need_dscale, stream);
}

// B3b: dk [G, H, N, D] and dv [G, H, N, Dv] over the transposed walk
// (ilist, icount) and the dense mask.
extern "C" int tagan_flash_geometric_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* ilist,
    const void* icount, const void* scale, const void* seed, void* dk,
    void* dv, int G, int H, int N, int D, int Dv, int n_j, int W, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return dkv_entry(q, k, v, mask, dout, lse, delta, ilist, icount, scale,
                   seed, dk, dv, G, H, N, D, Dv, n_j, W, metric, sqrt_d,
                   use_dropout, keep_thresh, inv_keep, stream);
}

// B3a's bf16 form: the same arguments.
extern "C" int tagan_flash_geometric_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* scale, const void* seed, void* dq,
    void* dscale_part, int G, int H, int N, int D, int Dv, int n_i, int W,
    int metric, float sqrt_d, int use_dropout, unsigned int keep_thresh,
    float inv_keep, int need_dscale, void* stream) {
  return dq_entry<DENSE_MASK, true>(q, k, v, mask, dout, lse, delta, jlist,
                                    jcount, jlist, scale, seed, dq,
                                    dscale_part, G, H, N, D, Dv, n_i, W, 0,
                                    metric, sqrt_d, use_dropout, keep_thresh,
                                    inv_keep, need_dscale, stream);
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
