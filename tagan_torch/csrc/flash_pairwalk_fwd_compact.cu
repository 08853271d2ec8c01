// Geometric attention forwards over the hybrid band's compact store, as
// pair walks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// in their compact occupied-block forms (a 3-tuple plan), bf16=False and
// bf16=True (the template flag kBf16), as two modes of one walk (kMode):
//
//   B1c  _flash_kernel (host side _flash_forward), pallas_call :1369
//        kMode OUT: out_i, lse_i
//   B5c  _flash_biased_kernel (host side tagan_tpu/ops/pallas/
//        hybrid_biased.py _band_biased_main), pallas_call :236
//        kMode BIASED: out_i, lse2_i
//
// For each query row i and head h, over the band's valid keys j (the
// store's bits), with s_ij the metric score:
//
//   B1c  w_ij   = softmax_j s_ij
//        out_i  = sum_j drop(w_ij) v_j,   lse_i = logsumexp_j s_ij
//   B5c  given lse1 (the union's: a logsumexp over a superset of the
//        walked pairs, an input),
//        w1_ij  = exp(s_ij - lse1_i)
//        w1d_ij = keep1_ij ? w1_ij / (1 - p) : 0
//        z_ij   = w1d_ij + bias[g, slot, i % 64, j % 64]
//        out_i  = sum_j drop2(softmax_j z_ij) v_j,  lse2_i = logsumexp_j z_ij
//
// with out = 0 and lse = 1e30 on rows that have no valid key. A dropped
// w1 is not a masked pair: it enters the second softmax as z = bias. Each
// softmax's denominator is the un-dropped sum. The keep masks are the JAX
// package's coordinate hash (_keep_mask) at the global (i, j), bit for
// bit: B1c's with the snapshot's one seed, B5c's keep1 and keep2 with its
// two. The bias is shared by the heads. The bf16 form rounds q and k
// after their fp32 norms, drop(p) relative to the running max after each
// walk step, in jlist order, and v; the sums are fp32. So its result
// depends on the walk (ROADMAP C11(b)), and a unit never splits a row's
// walk.
//
// It is the dense forward walk (flash_pairwalk_fwd.cu) over another mask
// source and another bias address, with the same per-pair code
// (flash_pairwalk_fwd.cuh: the scores, the flush and its rounding points):
//  - The mask is the compact store, bits i64[G, S, 64] or int8
//    [G, S, 64, 64]: the slot walk of flash_pairwalk_slots.cuh, which the
//    compact row walks of the backward share. A list entry is (walk step
//    t, column c) as t * 64 + c, and `CompactRowPairs` reads the step's
//    key tile and slot back from the walk.
//  - B5c's bias of pair (i, j) lies at [g, slot, i % 64, j % 64] of the
//    walked step's slot of the bias store f32[G, S, 64, 64], not at
//    [g, i, j]: one 4-byte read a valid pair, the HG lanes of a row
//    reading the same word.
//
// Design. One warp is one block and one unit: R rows of one 64-row query
// tile of one folded snapshot g, for a group of HG <= 32 heads, R * HG <=
// 32, each lane one (row, head) item (`warp_items`); past 32 heads the
// head groups are grid blocks, innermost, so that the groups of one
// sub-tile walk its slots together. No block barrier and no atomic:
// out and lse are written once per live row, dead rows and rows with an
// empty walk included, and repeated calls are bit-identical. The flush
// runs when a row's list (CAPR entries) could overflow and at the end,
// over the valid pairs only: k gathered UNROLL entries a lane at once for
// the scores (B5c: w1, drop1 and the bias); the online softmax one walk
// step at a time (entry >> 6); v gathered for drop(p) v.
//
// What bounds it on the H100. The store is 512 B a walked tile (17.8 MB a
// 131K snapshot); q, k, v, out and lse (B5c: lse1) are read or written
// once, B5c's bias at the valid pairs only (4 bytes each): ~0.05 ms at
// 3.35 TB/s. The pairs' products (~2 to 3 of head dim a pair and head)
// are far below the fp32 rate. The band holds ~1 valid pair a row a walked
// tile (60.6 a tile), so the flush's gathers set the pace, as in the
// compact row walks. The tile templates it replaces computed all 4,096
// pairs of every walked tile once per head (68 times the valid pairs),
// and B5c's staged each 16 KB bias tile per head.
//
// B4c's lse1 (kMode LSE, the flush's first pass) is not built here; it is
// still the tile template of flash_biased_fwd.cu.
//
// Interface: plain C, loaded with ctypes; the entry points and arguments of
// the tile templates' B1c and B5c entries. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_pairwalk_fwd.cuh"
#include "flash_pairwalk_slots.cuh"

namespace {

using namespace tagan_pairwalk;

// the flush: false leaves the walk walking the slots and listing the pairs
// alone (pairwalk_variants.py; its outputs are then not the function)
constexpr bool FWD_FLUSH = true;

// Bytes of a warp: its slot walk, then its items' part.
__host__ __device__ inline size_t compact_warp_bytes(int R, int D, int Dv) {
  return slot_walk_bytes(R) + item_bytes(D, Dv);
}

// At least 8 warps an SM, as the compact row walk: without a minimum,
// ptxas held a one-warp-block walk to 64-72 registers and spilled
// (chip_smoke.py phase 1 logs ptxas's report).
template <int kMode, bool kBf16, int kForm>
__global__ void __launch_bounds__(WARP, 8)
compact_fwd_kernel(const Walk a) {
  const int lane = threadIdx.x;
  const int R = a.R;
  const int hg = (int)(blockIdx.x % a.n_hg), sub = (int)(blockIdx.x / a.n_hg);
  const int g = (int)blockIdx.y;
  const int ib = sub / (BM / R), row0 = sub * R, rr0 = row0 - ib * BM;

  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* ring = reinterpret_cast<uint64_t*>(smem);
  int* lists = reinterpret_cast<int*>(smem + (size_t)NST * R * 8);
  int* rowcnt = lists + R * CAPR;
  float* q_s = reinterpret_cast<float*>(smem + slot_walk_bytes(R));
  float* acc_s = q_s + WARP * a.D;
  float* zbuf = acc_s + WARP * a.Dv + lane;

  // the lane's item, as the dense walk's: its row of q (rounded after its
  // norm in bf16), its accumulator zeroed, its scale, B5c's lse1 and the
  // hash mixes (B1c: one seed a g; B5c: two)
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
    for (int d = 0; d < a.D; ++d) {
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
  const size_t walk = (size_t)g * a.n_i + ib;
  const int cnt = a.jcount[walk];
  const int* jl = a.jlist + walk * a.W;
  const int* js = a.jslot + walk * a.W;
  const CompactRowPairs pairs{jl, js, (size_t)g * a.S, it.gr & (BM - 1)};
  const uint8_t* st =
      a.mask + (size_t)g * a.S * BM * row_store_bytes<kForm>();
  const int* list = lists + (rl < R ? rl : 0) * CAPR;
  walk_slots<kForm>(ring, lists, rowcnt, st, a.N, row0, rr0, R, jl, js, cnt,
                    lane, [&]() {
                      if constexpr (FWD_FLUSH)
                        flush<kMode, kBf16>(a, it, pairs, list,
                                            it.on ? rowcnt[rl] : 0, zbuf);
                    });

  if (it.on) {        // every live row once: 0 and 1e30 on a dead one
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

template <int kMode, bool kBf16, int kForm>
int launch(Walk a, int G, void* stream) {
  if (bad_walk<kMode>(a, G) || a.S < 1) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  warp_items(a.H, &a.HG, &a.R);
  a.n_hg = (a.H + a.HG - 1) / a.HG;
  a.n_sub = a.n_i * (BM / a.R);
  const size_t smem = compact_warp_bytes(a.R, a.D, a.Dv);
  const auto kern = compact_fwd_kernel<kMode, kBf16, kForm>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)a.n_sub * a.n_hg, G);
  kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int out_entry(const void* q, const void* k, const void* v, const void* store,
              const void* jlist, const void* jcount, const void* jslot,
              const void* scale, const void* seed, void* out, void* lse,
              int G, int H, int N, int D, int Dv, int n_i, int W, int S,
              int packed, int metric, float sqrt_d, int use_dropout,
              unsigned int keep_thresh, float inv_keep, void* stream) {
  Walk a = out_walk(q, k, v, store, jlist, jcount, scale, seed, out, lse, H,
                    N, D, Dv, n_i, W, metric, sqrt_d, use_dropout,
                    keep_thresh, inv_keep);
  a.jslot = (const int*)jslot;
  a.S = S;
  return packed ? launch<OUT, kBf16, COMPACT_BITS>(a, G, stream)
                : launch<OUT, kBf16, COMPACT_I8>(a, G, stream);
}

template <bool kBf16>
int biased_entry(const void* q, const void* k, const void* v,
                 const void* store, const void* bias, const void* lse1,
                 const void* jlist, const void* jcount, const void* jslot,
                 const void* scale, const void* seeds, void* out, void* lse2,
                 int G, int H, int N, int D, int Dv, int n_i, int W, int S,
                 int packed, int metric, float sqrt_d, int use_dropout,
                 unsigned int keep_thresh, float inv_keep, void* stream) {
  Walk a = biased_walk(q, k, v, store, bias, lse1, jlist, jcount, scale,
                       seeds, out, lse2, H, N, D, Dv, n_i, W, metric, sqrt_d,
                       use_dropout, keep_thresh, inv_keep);
  a.jslot = (const int*)jslot;
  a.S = S;
  return packed ? launch<BIASED, kBf16, COMPACT_BITS>(a, G, stream)
                : launch<BIASED, kBf16, COMPACT_I8>(a, G, stream);
}

}  // namespace

// B1c: out [G, H, N, Dv] and lse [G, H, N] of the forward over the compact
// store (bits i64[G, S, 64] when packed, else int8 [G, S, 64, 64], 16-byte
// aligned) along the walk (jlist, jcount, jslot [G, n_i, W], [G, n_i],
// [G, n_i, W]), one hash seed per g, [G].
extern "C" int tagan_flash_geometric_fwd_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* jlist, const void* jcount, const void* jslot,
    const void* scale, const void* seed, void* out, void* lse, int G, int H,
    int N, int D, int Dv, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return out_entry<false>(q, k, v, store, jlist, jcount, jslot, scale, seed,
                          out, lse, G, H, N, D, Dv, n_i, W, S, packed,
                          metric, sqrt_d, use_dropout, keep_thresh, inv_keep,
                          stream);
}

// B1c's bf16 form: the same arguments.
extern "C" int tagan_flash_geometric_fwd_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* jlist, const void* jcount, const void* jslot,
    const void* scale, const void* seed, void* out, void* lse, int G, int H,
    int N, int D, int Dv, int n_i, int W, int S, int packed, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return out_entry<true>(q, k, v, store, jlist, jcount, jslot, scale, seed,
                         out, lse, G, H, N, D, Dv, n_i, W, S, packed, metric,
                         sqrt_d, use_dropout, keep_thresh, inv_keep, stream);
}

// B5c: out [G, H, N, Dv] and lse2 [G, H, N] of the second softmax over the
// compact store (bits i64[G, S, 64] when packed, else int8 [G, S, 64, 64],
// 16-byte aligned) along the walk (jlist, jcount, jslot [G, n_i, W],
// [G, n_i], [G, n_i, W]), given lse1 [G, H, N], the bias in the same
// slots, f32[G, S, 64, 64], and two seeds per g, [G, 2].
extern "C" int tagan_flash_biased_fwd_compact(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* lse1, const void* jlist, const void* jcount,
    const void* jslot, const void* scale, const void* seeds, void* out,
    void* lse2, int G, int H, int N, int D, int Dv, int n_i, int W, int S,
    int packed, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
  return biased_entry<false>(q, k, v, store, bias, lse1, jlist, jcount,
                             jslot, scale, seeds, out, lse2, G, H, N, D, Dv,
                             n_i, W, S, packed, metric, sqrt_d, use_dropout,
                             keep_thresh, inv_keep, stream);
}

// B5c's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_fwd_compact_bf16(
    const void* q, const void* k, const void* v, const void* store,
    const void* bias, const void* lse1, const void* jlist, const void* jcount,
    const void* jslot, const void* scale, const void* seeds, void* out,
    void* lse2, int G, int H, int N, int D, int Dv, int n_i, int W, int S,
    int packed, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
  return biased_entry<true>(q, k, v, store, bias, lse1, jlist, jcount, jslot,
                            scale, seeds, out, lse2, G, H, N, D, Dv, n_i, W,
                            S, packed, metric, sqrt_d, use_dropout,
                            keep_thresh, inv_keep, stream);
}
