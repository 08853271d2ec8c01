// Edge-biased geometric attention, backward, over the hybrid band's compact
// store, as two pair walks for Hopper (sm_90a): a row walk and a key walk.
//
// Replaces the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// that differentiate the double softmax, in their compact occupied-block
// forms bf16=False and bf16=True (the template flag kBf16; host side
// tagan_tpu/ops/pallas/hybrid_biased.py):
//
//   row walk  B6c    _band_bwd_pre, pallas_call :298   delta1_i, dB_ij
//             B7a c  _band_bwd_dq_dkv, dq :371         dq_i, and d(scale)
//   key walk  B7b c  _band_bwd_dq_dkv, dk/dv :405      dk_j, dv_j
//
// with the union row statistics that _hybrid_biased's backward threads
// (hybrid_biased.py :596-660): lse1, lse2 and delta2 of the union of the
// band and the residual are inputs, and B7a c and B7b c take the union's
// delta1_U = delta1_band + delta1_res. They are the dense walks of
// flash_pairwalk_biased_bwd.cu (B6 + B7a, B7b) with the same per-pair code
// (flash_pairwalk_biased_bwd.cuh: the recompute, both flushes, and in bf16
// their rounding points), over another mask source and another bias
// address:
//
//  - The mask is the compact store: the band's occupied 64 x 64 tiles, slot
//    s of batch index g at g * S + s, as 64 uint64 row words (bit c of word
//    r for pair (r, c); COMPACT_BITS) or int8 [64][64] (COMPACT_I8). Each
//    walk step names its slot (jslot, islot [G, n_t, W]); a step past the
//    walk's count is not taken, and a slot whose bits are all 0 lists
//    nothing.
//  - The bias and dB of pair (i, j) lie at [g, slot, i % 64, j % 64] of
//    the walked step's slot of the bias store f32[G, S, 64, 64], not at
//    [g, i, j]. A list entry is (walk step t, column c) as t * 64 + c, and
//    the flush reads the step's tile and slot back from the walk.
//
// The row walk (B6c and B7a c). One warp is one block: R rows of one
// 64-row query tile for a group of HG heads, each lane one (row, head)
// item. At each step, lane r < R copies its row's word (8 bytes) of the
// step's slot by cp.async into an NST-stage ring, NST - 1 steps ahead (the
// int8 store: reads its 64-byte row and puts the row's word there), reads
// back only its own word and appends its set bits, ascending, to its row's
// list in shared memory (CAPR entries a row: at the band's ~1 valid pair a
// row and walked tile, the whole walk): the slot walk of
// flash_pairwalk_slots.cuh, which the compact forward walk shares.
//  Pass 1 (B6c) at every listed pair: w1, w2, dz and dw1, delta1 += w1 dw1
//   in the lane; dB_ij = the row's HG lanes' dz summed in head order,
//   stored once by the row's first lane, at the mask's pairs only (dB is
//   never zeroed: its one reader gathers it at band edges).
//  Then each lane adds its row's delta1_res (when given) to its delta1:
//   pass 2 and the key walk take the union's, which the walk writes.
//  Pass 2 (B7a c): the same recompute, then ds, W, dq_i += W k_j and the
//   d(scale) term, from the lists in shared memory unless a warp's list
//   overflowed (then it walks its slots again).
// Past 32 heads the entry point launches the walk once per group of 32
// heads, in order on the stream, each group adding its dz into dB.
//
// The key walk (B7b c), over the transposed walk (ilist, icount, islot):
// one block owns KB keys of one 64-key tile for up to 8 heads, as the dense
// key walk. Each walked slot's 64 row words (512 B) are copied whole by
// cp.async into the block's ring (the int8 store's 4 KB read and turned
// into the words as they are loaded), one block barrier a step; each warp
// turns its R keys' columns into a 64-bit row word a key by two ballots
// (rows 0-31 and 32-63) and appends the key's rows to its list (the key
// slot walk of flash_pairwalk_slots.cuh, which the unbiased compact key
// walk of flash_pairwalk_bwd_compact.cu shares); the flush
// gathers q_i, do_i, the row statistics, delta1_U and the bias at the
// valid pairs and sums dk_j and dv_j in the walk's row order.
//
// Neither walk has an atomic: repeated calls are bit-identical. Both
// softmaxes are normalised by the given lse1 and lse2, so no walk order
// enters the pairs' values.
//
// What bounds them on the H100. The store is 512 B a walked tile (17.8 MB
// a 131K snapshot); q, k, v, do, the row statistics, the bias and dB at the
// valid pairs (one 32-byte sector each) and the outputs are read or written
// once; the pairs' products (~2 to 3 of head dim a pair and head) are far
// below the fp32 rate. The band holds ~1 valid pair a row a walked tile,
// so the flush's gathers set the pace, as in the dense walks.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the last launch.

#include "flash_pairwalk_biased_bwd.cuh"
#include "flash_pairwalk_slots.cuh"

namespace {

using namespace tagan_pairwalk;

// the flushes: false leaves each walk walking the slots and listing the
// pairs alone (pairwalk_variants.py; its outputs are then not the function)
constexpr bool ROW_FLUSH = true;
constexpr bool KEY_FLUSH = true;

// ---------------------------------------------------------------------------
// The row walk
// ---------------------------------------------------------------------------

// Bytes of a row walk warp: its slot walk and its items.
__host__ __device__ inline size_t row_bytes(int R, int D, int Dv) {
  return slot_walk_bytes(R) + row_item_bytes(D, Dv);
}

// At least 8 warps an SM: without a minimum, ptxas held the walk to 64-72
// registers (the SM's 32 one-warp blocks) and spilled; with it, 154-157
// registers in fp32 and 113-116 in bf16, no spill (chip_smoke.py phase 1
// logs ptxas's report).
template <bool kBf16, int kForm>
__global__ void __launch_bounds__(WARP, 8) row_walk_kernel(const Bwd a) {
  const int lane = threadIdx.x;
  const int R = a.R, HG = a.HG;
  const int sub = (int)blockIdx.x, g = (int)blockIdx.y;
  const int ib = sub / (BM / R), row0 = sub * R, rr0 = row0 - ib * BM;

  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* ring = reinterpret_cast<uint64_t*>(smem);
  int* lists = reinterpret_cast<int*>(smem + (size_t)NST * R * 8);
  int* rowcnt = lists + R * CAPR;
  float* q_s = reinterpret_cast<float*>(smem + slot_walk_bytes(R));
  float* do_s = q_s + WARP * a.D;
  float* dq_s = do_s + WARP * a.Dv;

  size_t row;
  RowItem it =
      row_item<kBf16>(a, g, row0, lane, a.hg, q_s, do_s, dq_s, &row);
  const int rl = lane / HG;
  const size_t walk = (size_t)g * a.n_t + ib;
  const int cnt = a.pcount[walk];
  const int* jl = a.plan + walk * a.W;
  const int* js = a.pslot + walk * a.W;
  const CompactRowPairs pairs{jl, js, (size_t)g * a.S, it.gr & (BM - 1)};
  const uint8_t* st =
      a.mask + (size_t)g * a.S * BM * row_store_bytes<kForm>();
  const int* list = lists + (rl < R ? rl : 0) * CAPR;
  int flushes = 0;
  walk_slots<kForm>(ring, lists, rowcnt, st, a.N, row0, rr0, R, jl, js, cnt,
                    lane, [&]() {
                      ++flushes;
                      if constexpr (ROW_FLUSH)
                        row_pass<1, kBf16>(a, it, pairs, list,
                                           it.on ? rowcnt[rl] : 0, HG);
                    });
  // the union's delta1: the band's row sums and the residual's
  if (it.on && a.delta1_rest != nullptr) it.d1 += a.delta1_rest[row];
  if (flushes == 1) {   // every list whole in shared memory: pass 2 there
    if constexpr (ROW_FLUSH)
      row_pass<2, kBf16>(a, it, pairs, list, it.on ? rowcnt[rl] : 0, HG);
  } else {
    walk_slots<kForm>(ring, lists, rowcnt, st, a.N, row0, rr0, R, jl, js,
                      cnt, lane, [&]() {
                        if constexpr (ROW_FLUSH)
                          row_pass<2, kBf16>(a, it, pairs, list,
                                             it.on ? rowcnt[rl] : 0, HG);
                      });
  }
  row_finish<kBf16>(a, it, row, dq_s, lane);
}

// ---------------------------------------------------------------------------
// The key walk
// ---------------------------------------------------------------------------

// Bytes of a key walk block: its slot walk (ring and lists) and its items.
__host__ __device__ inline size_t key_bytes(int KB, int R, int D, int Dv) {
  return slot_key_walk_bytes(KB) + key_item_bytes(KB, R, D, Dv);
}

template <bool kBf16, int kForm>
__global__ void __launch_bounds__(KEY_WARPS * WARP, 1)
key_walk_kernel(const Bwd a) {
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

  const int kl = lane / HG, h = hg * HG + lane % HG;
  KeyItem it = key_item<kBf16>(a, g, col0 + kc0 + kl, h, lane < R * HG, tid,
                               nthr, k_s, v_s, dk_s, dv_s);
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
                            key_pass<kBf16>(a, it, pairs, list, n, nthr);
                        });
  key_finish<kBf16>(a, it, dk_s, dv_s, tid, nthr);
}

bool bad_compact(const Bwd& a, int G) {
  return bad_args(a, G) || a.S < 1;
}

template <bool kBf16, int kForm>
int launch_rows(Bwd a, int G, void* stream) {
  if (bad_compact(a, G)) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  warp_items(a.H, &a.HG, &a.R);
  const int n_hg = (a.H + a.HG - 1) / a.HG;
  const size_t smem = row_bytes(a.R, a.D, a.Dv);
  const auto kern = row_walk_kernel<kBf16, kForm>;
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

template <bool kBf16, int kForm>
int launch_keys(Bwd a, int G, void* stream) {
  if (bad_compact(a, G)) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  if (!key_blocks(&a, [&](int KB) { return key_bytes(KB, a.R, a.D, a.Dv); }))
    return (int)cudaErrorInvalidValue;
  const size_t smem = key_bytes(a.KB, a.R, a.D, a.Dv);
  const auto kern = key_walk_kernel<kBf16, kForm>;
  const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.n_t * a.n_kb * a.n_hg), G);
  kern<<<grid, (a.KB / a.R) * WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int row_entry(const void* q, const void* k, const void* v, const void* store,
              const void* bias, const void* dout, const void* lse1,
              const void* lse2, const void* delta2, const void* delta1_rest,
              const void* jlist, const void* jcount, const void* jslot,
              const void* scale, const void* seeds, void* delta1,
              void* dbias, void* dq, void* dscale_part, int G, int H, int N,
              int D, int Dv, int n_i, int W, int S, int packed, int metric,
              float sqrt_d, int use_dropout, unsigned int keep_thresh,
              float inv_keep, int need_dscale, void* stream) {
  Bwd a = common_args(q, k, v, store, bias, dout, lse1, lse2, delta2, jlist,
                      jcount, scale, seeds, H, N, D, Dv, n_i, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1_rest = (const float*)delta1_rest;
  a.pslot = (const int*)jslot;
  a.S = S;
  a.delta1_out = (float*)delta1;
  a.dbias = (float*)dbias;
  a.dq = (float*)dq;
  a.dscale = (float*)dscale_part;
  a.need_dscale = need_dscale;
  return packed ? launch_rows<kBf16, COMPACT_BITS>(a, G, stream)
                : launch_rows<kBf16, COMPACT_I8>(a, G, stream);
}

template <bool kBf16>
int key_entry(const void* q, const void* k, const void* v, const void* store,
              const void* bias, const void* dout, const void* lse1,
              const void* lse2, const void* delta2, const void* delta1,
              const void* ilist, const void* icount, const void* islot,
              const void* scale, const void* seeds, void* dk, void* dv, int G,
              int H, int N, int D, int Dv, int n_j, int W, int S, int packed,
              int metric, float sqrt_d, int use_dropout,
              unsigned int keep_thresh, float inv_keep, void* stream) {
  Bwd a = common_args(q, k, v, store, bias, dout, lse1, lse2, delta2, ilist,
                      icount, scale, seeds, H, N, D, Dv, n_j, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1 = (const float*)delta1;
  a.pslot = (const int*)islot;
  a.S = S;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  return packed ? launch_keys<kBf16, COMPACT_BITS>(a, G, stream)
                : launch_keys<kBf16, COMPACT_I8>(a, G, stream);
}

}  // namespace

// The row walk, B6c and B7a c: delta1_U [G, H, N] (the band's row sums
// plus delta1_rest [G, H, N] where that is not null), dB f32[G, S, 64, 64]
// in the store's slots (written at the mask's valid pairs only), dq
// [G, H, N, D] and, with need_dscale, each item's d(scale) term [G, H, N],
// over the forward walk (jlist, jcount, jslot [G, n_i, W], [G, n_i],
// [G, n_i, W]) of the compact store, bits i64[G, S, 64] (packed) or int8
// [G, S, 64, 64], 16-byte aligned, given lse1, lse2 and delta2 [G, H, N]
// (the union's), the bias store f32[G, S, 64, 64] and two seeds per g,
// [G, 2].
extern "C" int tagan_flash_biased_bwd_row_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1_rest, const void* jlist,
    const void* jcount, const void* jslot, const void* scale,
    const void* seeds, void* delta1, void* dbias, void* dq,
    void* dscale_part, int G, int H, int N, int D, int Dv, int n_i, int W,
    int S, int packed, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, int need_dscale,
    void* stream) {
  return row_entry<false>(q, k, v, store, bias, dout, lse1, lse2, delta2,
                          delta1_rest, jlist, jcount, jslot, scale, seeds,
                          delta1, dbias, dq, dscale_part, G, H, N, D, Dv, n_i,
                          W, S, packed, metric, sqrt_d, use_dropout,
                          keep_thresh, inv_keep, need_dscale, stream);
}

// The row walk's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_bwd_row_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1_rest, const void* jlist,
    const void* jcount, const void* jslot, const void* scale,
    const void* seeds, void* delta1, void* dbias, void* dq,
    void* dscale_part, int G, int H, int N, int D, int Dv, int n_i, int W,
    int S, int packed, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, int need_dscale,
    void* stream) {
  return row_entry<true>(q, k, v, store, bias, dout, lse1, lse2, delta2,
                         delta1_rest, jlist, jcount, jslot, scale, seeds,
                         delta1, dbias, dq, dscale_part, G, H, N, D, Dv, n_i,
                         W, S, packed, metric, sqrt_d, use_dropout,
                         keep_thresh, inv_keep, need_dscale, stream);
}

// The key walk, B7b c: dk [G, H, N, D] and dv [G, H, N, Dv] over the
// transposed walk (ilist, icount, islot [G, n_j, W], [G, n_j], [G, n_j, W])
// of the same store and bias store (islot names the same (row tile, key
// tile) slots), given the row walk's delta1_U.
extern "C" int tagan_flash_biased_bwd_key_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* ilist,
    const void* icount, const void* islot, const void* scale,
    const void* seeds, void* dk, void* dv, int G, int H, int N, int D, int Dv,
    int n_j, int W, int S, int packed, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return key_entry<false>(q, k, v, store, bias, dout, lse1, lse2, delta2,
                          delta1, ilist, icount, islot, scale, seeds, dk, dv,
                          G, H, N, D, Dv, n_j, W, S, packed, metric, sqrt_d,
                          use_dropout, keep_thresh, inv_keep, stream);
}

// The key walk's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_bwd_key_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* ilist,
    const void* icount, const void* islot, const void* scale,
    const void* seeds, void* dk, void* dv, int G, int H, int N, int D, int Dv,
    int n_j, int W, int S, int packed, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return key_entry<true>(q, k, v, store, bias, dout, lse1, lse2, delta2,
                         delta1, ilist, icount, islot, scale, seeds, dk, dv,
                         G, H, N, D, Dv, n_j, W, S, packed, metric, sqrt_d,
                         use_dropout, keep_thresh, inv_keep, stream);
}
