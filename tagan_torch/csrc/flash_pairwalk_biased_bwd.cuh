// The per-pair work of the edge-biased backward's pair walks, shared by
// flash_pairwalk_biased_bwd.cu (the dense mask's row and key walks) and
// flash_pairwalk_biased_bwd_compact.cu (the hybrid band's row and key walks
// over the compact store), each in fp32 and bf16: the walks' arguments,
// one pair's recompute, and the two flushes that gather a row's (a key's)
// listed pairs, recompute them and sum into the lane's accumulators. The
// unbiased compact key walk (flash_pairwalk_bwd_compact.cu, B3b c) takes
// the arguments, the key walk's block (`key_blocks`), its item and its
// outputs from here, with a flush of its own, and so does its unbiased
// compact row walk (B3a c) the row walk's item and outputs.
//
// A walk lists each row's (key's) valid pairs as ints; where the pair's key
// (row) and its bias entry lie is the walk's own: a policy object turns a
// list entry into the key's (row's) index (`index`) and, where the flush
// reads it, the offset of the pair's bias and dB entry (`bias`). The dense
// walks list the index itself, with the bias [G, N, N] (`DenseRowPairs`,
// `DenseKeyPairs`); the compact walks list (walk step, column in the tile)
// and read the step's slot of the bias store [G, S, 64, 64]
// (`CompactRowPairs`, `CompactKeyPairs`: flash_pairwalk_slots.cuh).

#pragma once

#include "flash_pairwalk.cuh"

namespace tagan_pairwalk {

constexpr int KEY_WARPS = 16;     // warps of a key walk block, at most
constexpr int KEY_HG = 8;         // heads of a key walk block, at most
constexpr size_t MAX_SMEM = 227 * 1024;

// Both walks' arguments.
struct Bwd {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;    // dense: int8 [G, N, N]; compact: the store
  const float* bias;      // dense: [G, N, N]; compact: [G, S, 64, 64]
  const float* dout;
  const float* lse1;
  const float* lse2;
  const float* delta2;
  const float* delta1;    // key walk: the row walk's output
  const float* delta1_rest;   // compact row walk: added to delta1, or null
  const int* plan;        // row walk: jlist; key walk: ilist
  const int* pcount;
  const int* pslot;       // compact: the slot of each walk step
  const float* scale;
  const int* seeds;
  float* delta1_out;
  float* dbias;
  float* dq;
  float* dscale;          // [G, H, N]: each item's d(scale) term
  float* dk;
  float* dv;
  int H, N, D, Dv, n_t, W, HG, R, metric;
  int S;                  // compact: slots a folded batch index
  float sqrt_d;
  int use_dropout;
  uint32_t keep_thresh;
  float inv_keep;
  int need_dscale;
  int hg;                 // row walk: this launch's head group
  int KB, n_kb;           // key walk: keys a block, blocks a key tile
  int n_hg;               // key walk, unbiased row walk: head groups
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One pair's recompute from its products: s, sq, w1, dz, dw1 and drop2(w2).
struct Pair {
  float s, sq, w1, dz, dw1, w2d;
};

__device__ __forceinline__ Pair recompute(const Bwd& a, float qk, float qn,
                                          float kn, float dp, float b,
                                          float lse1, float lse2,
                                          float delta2, float sc,
                                          uint32_t mix1, uint32_t mix2,
                                          uint32_t gr, uint32_t gc) {
  Pair p;
  p.s = score_of(a.metric, qk, qn, kn, sc, a.sqrt_d);
  p.sq = fmaxf(qn + kn - 2.f * qk, 0.f);
  p.w1 = expf(p.s - lse1);          // lse1 >= the row's valid scores
  float w1d = p.w1, dpv = dp;
  bool keep1 = true, keep2 = true;
  if (a.use_dropout) {
    keep1 = keep_hash(mix1, gr, gc) < a.keep_thresh;
    keep2 = keep_hash(mix2, gr, gc) < a.keep_thresh;
    w1d = keep1 ? p.w1 * a.inv_keep : 0.f;
    dpv = keep2 ? dpv * a.inv_keep : 0.f;
  }
  const float w2 = expf(w1d + b - lse2);
  p.dz = w2 * (dpv - delta2);
  p.dw1 = a.use_dropout ? (keep1 ? p.dz * a.inv_keep : 0.f) : p.dz;
  p.w2d = a.use_dropout ? (keep2 ? w2 * a.inv_keep : 0.f) : w2;
  return p;
}

// The dense key walk's list entries: the row index; the bias is
// [G, N, N] (the row walk's are `DenseRowPairs`, flash_pairwalk.cuh).
struct DenseKeyPairs {
  size_t g_n;             // g * N
  int N, gc;
  __device__ __forceinline__ int index(int x) const { return x; }
  __device__ __forceinline__ size_t bias(int x) const {
    return (g_n + x) * N + gc;
  }
};

// ---------------------------------------------------------------------------
// The row walk's flush
// ---------------------------------------------------------------------------

// Bytes of a row walk warp's own part of shared memory, past its walk's:
// q and do (rounded in bf16) and the dq accumulator, each [width][32 lanes].
__host__ __device__ inline size_t row_item_bytes(int D, int Dv) {
  return (size_t)WARP * (2 * D + Dv) * 4;
}

// One lane's (row, head) item. d1: the biased walks' delta1 (pass 1's
// sum), the unbiased dq walk's delta.
struct RowItem {
  bool on;
  int gr, base;          // base: the row's first lane
  size_t gh;             // g * H + h
  float qn, sc, lse1, lse2, delta2, d1, wsum, dsc;
  uint32_t mix1, mix2;
  const float* qs;       // q_s + lane, stride 32
  const float* dos;      // do_s + lane, stride 32
  float* dq;             // dq_s + lane, stride 32
};

// One pass over a row list of n entries, every lane in step (to the
// longest list): kPass 1 sums delta1 and stores dB, kPass 2 adds dq.
template <int kPass, bool kBf16, class Pairs>
__device__ __forceinline__ void row_pass(const Bwd& a, RowItem& it,
                                         const Pairs& pairs, const int* list,
                                         int n, int HG) {
  const bool k4 = (a.D & 3) == 0 && aligned16(a.k);
  const bool v4 = (a.Dv & 3) == 0 && aligned16(a.v);
  const float* kg = a.k + it.gh * a.N * a.D;
  const float* vg = a.v + it.gh * a.N * a.Dv;
  const int nmax = __reduce_max_sync(FULL, n);
  for (int e = 0; e < nmax; ++e) {
    const bool on = e < n;
    const int ent = on ? list[e] : 0;     // the list entry
    const int gc = on ? pairs.index(ent) : 0;
    const float* kr = kg + (size_t)gc * a.D;
    const float* vr = vg + (size_t)gc * a.Dv;
    float qk = 0.f, kn = 0.f, dp = 0.f;
    // q.k (bf16: of rounded operands) and |k|^2 of the unrounded row
    if (k4) {
      for (int d = 0; d < a.D; d += 4) {
        const float4 x = on ? __ldg(reinterpret_cast<const float4*>(kr + d))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        kn += x.x * x.x;
        qk = fmaf(it.qs[d * WARP], rd<kBf16>(x.x), qk);
        kn += x.y * x.y;
        qk = fmaf(it.qs[(d + 1) * WARP], rd<kBf16>(x.y), qk);
        kn += x.z * x.z;
        qk = fmaf(it.qs[(d + 2) * WARP], rd<kBf16>(x.z), qk);
        kn += x.w * x.w;
        qk = fmaf(it.qs[(d + 3) * WARP], rd<kBf16>(x.w), qk);
      }
    } else {
      for (int d = 0; d < a.D; ++d) {
        const float x = on ? __ldg(kr + d) : 0.f;
        kn += x * x;
        qk = fmaf(it.qs[d * WARP], rd<kBf16>(x), qk);
      }
    }
    // do.v (bf16: of rounded operands)
    if (v4) {
      for (int c = 0; c < a.Dv; c += 4) {
        const float4 y = on ? __ldg(reinterpret_cast<const float4*>(vr + c))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        dp = fmaf(it.dos[c * WARP], rd<kBf16>(y.x), dp);
        dp = fmaf(it.dos[(c + 1) * WARP], rd<kBf16>(y.y), dp);
        dp = fmaf(it.dos[(c + 2) * WARP], rd<kBf16>(y.z), dp);
        dp = fmaf(it.dos[(c + 3) * WARP], rd<kBf16>(y.w), dp);
      }
    } else {
      for (int c = 0; c < a.Dv; ++c) {
        const float y = on ? __ldg(vr + c) : 0.f;
        dp = fmaf(it.dos[c * WARP], rd<kBf16>(y), dp);
      }
    }
    float dz = 0.f, wq = 0.f;
    if (on) {
      const Pair p = recompute(a, qk, it.qn, kn, dp,
                               __ldg(a.bias + pairs.bias(ent)),
                               it.lse1, it.lse2, it.delta2, it.sc, it.mix1,
                               it.mix2, (uint32_t)it.gr, (uint32_t)gc);
      if constexpr (kPass == 1) {
        dz = p.dz;
        it.d1 = fmaf(p.w1, p.dw1, it.d1);
      } else {
        const float ds = p.w1 * (p.dw1 - it.d1);
        const float w =
            kBf16 ? chain_weight_bf16(a.metric, ds, p.s, p.sq, qk, it.sc)
                  : chain_weight(a.metric, ds, p.s, p.sq, qk, it.sc, a.sqrt_d);
        it.dsc = fmaf(ds * p.s, p.sq, it.dsc);
        it.wsum += w;
        wq = rd<kBf16>(w);
      }
    }
    if constexpr (kPass == 1) {
      // dB_ij: the row's HG lanes' dz in head order (lanes off the row or
      // past H hold 0); its first lane stores it, after the earlier head
      // groups' sums
      float sum = 0.f;
      for (int h = 0; h < HG; ++h) sum += __shfl_sync(FULL, dz, it.base + h);
      if (on && (int)(threadIdx.x) == it.base) {
        const size_t off = pairs.bias(ent);
        a.dbias[off] = a.hg ? a.dbias[off] + sum : sum;
      }
    } else if (on) {
      // dq_i += W k_j (bf16: rounded): the k row again, now in L1
      for (int d = 0; d < a.D; ++d)
        it.dq[d * WARP] = fmaf(wq, rd<kBf16>(__ldg(kr + d)), it.dq[d * WARP]);
    }
  }
}

// The row item of lane `lane` for rows [row0, row0 + R) of batch index g
// and head group hg: q (the norm, then the row, bf16: rounded) and do into
// their slots, dq's slots zeroed, the row statistics, the scale and the
// dropout mixes: kSeeds seeds a batch index, two here (mix1, mix2 from
// seeds [G, 2]; lse1, lse2 and delta2 read, delta1 summed from 0), one for
// the unbiased compact row walk (mix1 from seeds [G]; lse in lse1, delta
// read into d1; flash_pairwalk_bwd_compact.cu).
template <bool kBf16, int kSeeds = 2>
__device__ __forceinline__ RowItem row_item(const Bwd& a, int g, int row0,
                                            int lane, int hg, float* q_s,
                                            float* do_s, float* dq_s,
                                            size_t* row_out) {
  RowItem it;
  const int R = a.R, HG = a.HG;
  const int rl = lane / HG, h = hg * HG + lane % HG;
  it.gr = row0 + rl;
  it.base = rl * HG;
  it.on = lane < R * HG && h < a.H && it.gr < a.N;
  it.gh = (size_t)g * a.H + (it.on ? h : 0);
  it.qs = q_s + lane;
  it.dos = do_s + lane;
  it.dq = dq_s + lane;
  it.qn = it.lse1 = it.lse2 = it.delta2 = it.d1 = it.wsum = it.dsc = 0.f;
  it.sc = 1.f;
  it.mix1 = it.mix2 = 0u;
  const size_t row = it.gh * a.N + it.gr;
  *row_out = row;
  if (it.on) {
    const float* qr = a.q + row * a.D;
    for (int d = 0; d < a.D; ++d) {
      const float x = qr[d];
      it.qn += x * x;
      q_s[d * WARP + lane] = rd<kBf16>(x);
      dq_s[d * WARP + lane] = 0.f;
    }
    const float* dor = a.dout + row * a.Dv;
    for (int c = 0; c < a.Dv; ++c) do_s[c * WARP + lane] = rd<kBf16>(dor[c]);
    it.lse1 = a.lse1[row];
    if constexpr (kSeeds == 1) {
      it.d1 = a.delta1[row];
    } else {
      it.lse2 = a.lse2[row];
      it.delta2 = a.delta2[row];
    }
    it.sc = a.scale[h];
    const uint32_t hmix = (uint32_t)h * 0xC2B2AE3Du;
    if constexpr (kSeeds == 1) {
      it.mix1 = (uint32_t)a.seeds[g] ^ hmix;
    } else {
      it.mix1 = (uint32_t)a.seeds[2 * g] ^ hmix;
      it.mix2 = (uint32_t)a.seeds[2 * g + 1] ^ hmix;
    }
  }
  return it;
}

// The row item's outputs: delta1 (not for the one-seed unbiased walk),
// dq (the squared-distance row term, or the chain's finish) and the
// d(scale) term. Dead rows: no pair, delta1 = dq = 0.
template <bool kBf16, int kSeeds = 2>
__device__ __forceinline__ void row_finish(const Bwd& a, const RowItem& it,
                                           size_t row, const float* dq_s,
                                           int lane) {
  if (!it.on) return;
  if constexpr (kSeeds == 2) a.delta1_out[row] = it.d1;
  const bool sqm = is_sq_metric(a.metric);
  const float* qr = a.q + row * a.D;
  float* og = a.dq + row * a.D;
  for (int d = 0; d < a.D; ++d) {
    const float x = dq_s[d * WARP + lane];
    og[d] = sqm ? x - it.wsum * qr[d] : chain_finish<kBf16>(a.metric, x,
                                                             a.sqrt_d);
  }
  if (a.need_dscale)
    a.dscale[row] = it.dsc * dscale_factor(a.metric, it.sc);
}

// ---------------------------------------------------------------------------
// The key walk's flush
// ---------------------------------------------------------------------------

// Bytes of a key walk block's own part of shared memory, past its walk's
// (ring and lists): k and v (rounded in bf16) and the dk and dv
// accumulators, each [width][threads].
__host__ __device__ inline size_t key_item_bytes(int KB, int R, int D,
                                                 int Dv) {
  return (size_t)(KB / R) * WARP * (2 * D + 2 * Dv) * 4;
}

// One lane's (key, head) item.
struct KeyItem {
  bool on;
  int gc;
  size_t gh;
  float kn, sc, wsum;
  uint32_t mix1, mix2;
  const float* ks;       // k_s + tid, stride nthr
  const float* vs;       // v_s + tid
  float* dk;             // dk_s + tid
  float* dv;             // dv_s + tid
};

// The key item of thread `tid` for key gc of batch index g, head h: k (the
// norm, then the row, bf16: rounded) and v into their slots, dk's and dv's
// slots zeroed, the scale and the dropout mixes: kSeeds seeds a batch
// index, two here (mix1, mix2 from seeds [G, 2]), one for the unbiased
// key walk (mix1 from seeds [G]; flash_pairwalk_bwd_compact.cu).
template <bool kBf16, int kSeeds = 2>
__device__ __forceinline__ KeyItem key_item(const Bwd& a, int g, int gc,
                                            int h, bool lane_on, int tid,
                                            int nthr, float* k_s, float* v_s,
                                            float* dk_s, float* dv_s) {
  KeyItem it;
  it.gc = gc;
  it.on = lane_on && h < a.H && it.gc < a.N;
  it.gh = (size_t)g * a.H + (it.on ? h : 0);
  it.ks = k_s + tid;
  it.vs = v_s + tid;
  it.dk = dk_s + tid;
  it.dv = dv_s + tid;
  it.kn = it.wsum = 0.f;
  it.sc = 1.f;
  it.mix1 = it.mix2 = 0u;
  if (it.on) {
    const size_t key = it.gh * a.N + it.gc;
    const float* kr = a.k + key * a.D;
    for (int d = 0; d < a.D; ++d) {
      const float x = kr[d];
      it.kn += x * x;
      k_s[d * nthr + tid] = rd<kBf16>(x);
      dk_s[d * nthr + tid] = 0.f;
    }
    const float* vr = a.v + key * a.Dv;
    for (int c = 0; c < a.Dv; ++c) {
      v_s[c * nthr + tid] = rd<kBf16>(vr[c]);
      dv_s[c * nthr + tid] = 0.f;
    }
    it.sc = a.scale[h];
    const uint32_t hmix = (uint32_t)h * 0xC2B2AE3Du;
    if constexpr (kSeeds == 1) {
      it.mix1 = (uint32_t)a.seeds[g] ^ hmix;
    } else {
      it.mix1 = (uint32_t)a.seeds[2 * g] ^ hmix;
      it.mix2 = (uint32_t)a.seeds[2 * g + 1] ^ hmix;
    }
  }
  return it;
}

// The flush of a key list of n rows (ascending), every lane of the warp in
// step (to the longest list): dk_j and dv_j in the lane's slots.
template <bool kBf16, class Pairs>
__device__ __forceinline__ void key_pass(const Bwd& a, KeyItem& it,
                                         const Pairs& pairs, const int* list,
                                         int n, int nthr) {
  const bool q4 = (a.D & 3) == 0 && aligned16(a.q);
  const bool o4 = (a.Dv & 3) == 0 && aligned16(a.dout);
  const int nmax = __reduce_max_sync(FULL, n);
  for (int e = 0; e < nmax; ++e) {
    if (!(it.on && e < n)) continue;
    const int ent = list[e];              // the list entry
    const int gr = pairs.index(ent);
    const size_t row = it.gh * a.N + gr;
    const float* qr = a.q + row * a.D;
    const float* dor = a.dout + row * a.Dv;
    float qk = 0.f, qn = 0.f, dp = 0.f;
    if (q4) {
      for (int d = 0; d < a.D; d += 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(qr + d));
        qn += x.x * x.x;
        qk = fmaf(rd<kBf16>(x.x), it.ks[d * nthr], qk);
        qn += x.y * x.y;
        qk = fmaf(rd<kBf16>(x.y), it.ks[(d + 1) * nthr], qk);
        qn += x.z * x.z;
        qk = fmaf(rd<kBf16>(x.z), it.ks[(d + 2) * nthr], qk);
        qn += x.w * x.w;
        qk = fmaf(rd<kBf16>(x.w), it.ks[(d + 3) * nthr], qk);
      }
    } else {
      for (int d = 0; d < a.D; ++d) {
        const float x = __ldg(qr + d);
        qn += x * x;
        qk = fmaf(rd<kBf16>(x), it.ks[d * nthr], qk);
      }
    }
    if (o4) {
      for (int c = 0; c < a.Dv; c += 4) {
        const float4 y = __ldg(reinterpret_cast<const float4*>(dor + c));
        dp = fmaf(rd<kBf16>(y.x), it.vs[c * nthr], dp);
        dp = fmaf(rd<kBf16>(y.y), it.vs[(c + 1) * nthr], dp);
        dp = fmaf(rd<kBf16>(y.z), it.vs[(c + 2) * nthr], dp);
        dp = fmaf(rd<kBf16>(y.w), it.vs[(c + 3) * nthr], dp);
      }
    } else {
      for (int c = 0; c < a.Dv; ++c)
        dp = fmaf(rd<kBf16>(__ldg(dor + c)), it.vs[c * nthr], dp);
    }
    const Pair p = recompute(a, qk, qn, it.kn, dp,
                             __ldg(a.bias + pairs.bias(ent)),
                             __ldg(a.lse1 + row), __ldg(a.lse2 + row),
                             __ldg(a.delta2 + row), it.sc, it.mix1, it.mix2,
                             (uint32_t)gr, (uint32_t)it.gc);
    const float ds = p.w1 * (p.dw1 - __ldg(a.delta1 + row));
    const float w =
        kBf16 ? chain_weight_bf16(a.metric, ds, p.s, p.sq, qk, it.sc)
              : chain_weight(a.metric, ds, p.s, p.sq, qk, it.sc, a.sqrt_d);
    it.wsum += w;
    const float wk = rd<kBf16>(w), pr = rd<kBf16>(p.w2d);
    // dk_j += W q_i and dv_j += drop2(w2) do_i (bf16: rounded): the rows
    // again, now in L1
    for (int d = 0; d < a.D; ++d)
      it.dk[d * nthr] = fmaf(wk, rd<kBf16>(__ldg(qr + d)), it.dk[d * nthr]);
    if (pr != 0.f)
      for (int c = 0; c < a.Dv; ++c)
        it.dv[c * nthr] = fmaf(pr, rd<kBf16>(__ldg(dor + c)), it.dv[c * nthr]);
  }
}

// The key item's outputs: dk (the squared-distance column term, or the
// chain's finish) and dv. Keys no row reaches: no pair, dk = dv = 0.
template <bool kBf16>
__device__ __forceinline__ void key_finish(const Bwd& a, const KeyItem& it,
                                           const float* dk_s,
                                           const float* dv_s, int tid,
                                           int nthr) {
  if (!it.on) return;
  const size_t key = it.gh * a.N + it.gc;
  const bool sqm = is_sq_metric(a.metric);
  const float* kr = a.k + key * a.D;
  float* ok = a.dk + key * a.D;
  for (int d = 0; d < a.D; ++d) {
    const float x = dk_s[d * nthr + tid];
    ok[d] = sqm ? x - it.wsum * kr[d] : chain_finish<kBf16>(a.metric, x,
                                                             a.sqrt_d);
  }
  float* ov = a.dv + key * a.Dv;
  for (int c = 0; c < a.Dv; ++c) ov[c] = dv_s[c * nthr + tid];
}

// ---------------------------------------------------------------------------
// Launch helpers
// ---------------------------------------------------------------------------

__host__ inline bool bad_args(const Bwd& a, int G) {
  return G < 0 || a.H < 0 || a.N < 0 || a.D < 1 || a.D > MAX_D ||
         a.Dv < 1 || a.Dv > MAX_D || a.metric < 0 || a.metric > COS_DIST ||
         a.n_t != (a.N + BM - 1) / BM || a.W < 0;
}

// Whether the dense walks may copy the mask [G, N, N] in 16-byte chunks.
__host__ inline bool vec16_mask(const Bwd& a) {
  return a.N % 16 == 0 && (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The key walk's block: HG heads (up to KEY_HG), R keys a warp, KB keys a
// block (up to KEY_WARPS warps, halved until `bytes(KB)` fits); n_kb key
// blocks a key tile and n_hg head groups. False when no KB fits.
template <class Bytes>
__host__ inline bool key_blocks(Bwd* a, Bytes bytes) {
  a->HG = a->H < KEY_HG ? a->H : KEY_HG;
  a->R = 1;
  while (a->R * 2 * a->HG <= WARP) a->R *= 2;
  a->KB = BN < KEY_WARPS * a->R ? BN : KEY_WARPS * a->R;
  while (a->KB > a->R && bytes(a->KB) > MAX_SMEM) a->KB /= 2;
  a->n_kb = BN / a->KB;
  a->n_hg = (a->H + a->HG - 1) / a->HG;
  return bytes(a->KB) <= MAX_SMEM;
}

__host__ inline Bwd common_args(const void* q, const void* k, const void* v,
                                const void* mask, const void* bias,
                                const void* dout, const void* lse1,
                                const void* lse2, const void* delta2,
                                const void* plan, const void* pcount,
                                const void* scale, const void* seeds, int H,
                                int N, int D, int Dv, int n_t, int W,
                                int metric, float sqrt_d, int use_dropout,
                                unsigned int keep_thresh, float inv_keep) {
  Bwd a{};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.mask = (const uint8_t*)mask;
  a.bias = (const float*)bias;
  a.dout = (const float*)dout;
  a.lse1 = (const float*)lse1;
  a.lse2 = (const float*)lse2;
  a.delta2 = (const float*)delta2;
  a.plan = (const int*)plan;
  a.pcount = (const int*)pcount;
  a.scale = (const float*)scale;
  a.seeds = (const int*)seeds;
  a.H = H; a.N = N; a.D = D; a.Dv = Dv; a.n_t = n_t; a.W = W;
  a.metric = metric; a.sqrt_d = sqrt_d; a.use_dropout = use_dropout;
  a.keep_thresh = keep_thresh; a.inv_keep = inv_keep;
  return a;
}

}  // namespace tagan_pairwalk
