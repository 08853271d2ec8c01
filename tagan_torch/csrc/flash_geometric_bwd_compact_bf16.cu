// The bf16 forms of B3a c and B3b c, the two-walk compact backward of
// the hybrid backend's band with bf16=True, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels tagan_tpu/ops/pallas/flash_geometric.py::
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel with 3-tuple plans and
// bf16=True (launched at flash_geometric.py:2009 and :2074). The kernels
// are flash_geometric_bwd.cuh's templates, documented in
// flash_geometric_bwd.cu, instantiated here with kBf16 for the bit and the
// int8 store; this file only holds their entries, so that nvcc builds
// these 16 instantiations beside that file's 32 rather than after them.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_geometric_bwd.cuh"

using namespace tagan_flash;

// B3a c's bf16 form: the same arguments.
extern "C" int tagan_flash_geometric_bwd_dq_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* jslot, const void* scale,
    const void* seed, void* dq, void* dscale_part, int G, int H, int N,
    int D, int Dv, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    int need_dscale, void* stream) {
  return (packed ? dq_entry<COMPACT_BITS, true>
                 : dq_entry<COMPACT_I8, true>)(
      q, k, v, store, dout, lse, delta, jlist, jcount, jslot, scale, seed, dq,
      dscale_part, G, H, N, D, Dv, n_i, W, S, metric, sqrt_d, use_dropout,
      keep_thresh, inv_keep, need_dscale, stream);
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
  return (packed ? dkv_entry<COMPACT_BITS, true>
                 : dkv_entry<COMPACT_I8, true>)(
      q, k, v, store, dout, lse, delta, ilist, icount, islot, scale, seed, dk,
      dv, G, H, N, D, Dv, n_j, W, S, metric, sqrt_d, use_dropout, keep_thresh,
      inv_keep, stream);
}
