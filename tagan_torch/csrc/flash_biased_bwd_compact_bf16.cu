// The bf16 forms of B6c, B7a c and B7b c, the edge-biased compact backward
// of the hybrid backend's band with bf16=True, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels tagan_tpu/ops/pallas/flash_geometric.py::
// _biased_bwd_pre_kernel, _biased_bwd_dq_kernel and _biased_bwd_dkv_kernel
// with compact=True and bf16=True (host side tagan_tpu/ops/pallas/
// hybrid_biased.py _band_bwd_pre, launched at :298, and _band_bwd_dq_dkv,
// :371 and :405). The kernels are flash_biased_bwd.cuh's templates,
// documented there, instantiated here with kBf16 for the bit and the int8
// store; this file only holds their entries. The fp32 forms are the pair
// walks of flash_pairwalk_biased_bwd_compact.cu.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_biased_bwd.cuh"

using namespace tagan_flash;

// B6c's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_bwd_pre_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* jlist, const void* jcount,
    const void* jslot, const void* scale, const void* seeds, void* delta1,
    void* dbias, int G, int H, int N, int D, int Dv, int n_i, int W, int S,
    int packed, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
  return (packed ? pre_entry<COMPACT_BITS, true>
                 : pre_entry<COMPACT_I8, true>)(
      q, k, v, store, bias, dout, lse1, lse2, delta2, jlist, jcount, jslot,
      scale, seeds, delta1, dbias, G, H, N, D, Dv, n_i, W, S, metric, sqrt_d,
      use_dropout, keep_thresh, inv_keep, stream);
}

// B7a c's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_bwd_dq_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* jlist,
    const void* jcount, const void* jslot, const void* scale,
    const void* seeds, void* dq, void* dscale_part, int G, int H, int N,
    int D, int Dv, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    int need_dscale, void* stream) {
  return (packed ? dq_entry<COMPACT_BITS, true> : dq_entry<COMPACT_I8, true>)(
      q, k, v, store, bias, dout, lse1, lse2, delta2, delta1, jlist, jcount,
      jslot, scale, seeds, dq, dscale_part, G, H, N, D, Dv, n_i, W, S, metric,
      sqrt_d, use_dropout, keep_thresh, inv_keep, need_dscale, stream);
}

// B7b c's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_bwd_dkv_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* ilist,
    const void* icount, const void* islot, const void* scale,
    const void* seeds, void* dk, void* dv, int G, int H, int N, int D,
    int Dv, int n_j, int W, int S, int packed, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return (packed ? dkv_entry<COMPACT_BITS, true>
                 : dkv_entry<COMPACT_I8, true>)(
      q, k, v, store, bias, dout, lse1, lse2, delta2, delta1, ilist, icount,
      islot, scale, seeds, dk, dv, G, H, N, D, Dv, n_j, W, S, metric, sqrt_d,
      use_dropout, keep_thresh, inv_keep, stream);
}
