// The bf16 form of B3a c, the dq walk of the compact backward of the
// hybrid backend's band with bf16=True, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tagan_tpu/ops/pallas/flash_geometric.py::
// _flash_bwd_dq_kernel with 3-tuple plans and bf16=True (launched at
// flash_geometric.py:2009). The kernel is flash_geometric_bwd.cuh's
// template, documented in flash_geometric_bwd.cu, instantiated here with
// kBf16 for the bit and the int8 store; this file only holds its entry, so
// that nvcc builds these 8 instantiations beside that file's rather than
// after them. B3b c's bf16 form is the key pair walk of
// flash_pairwalk_bwd_compact.cu.
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
