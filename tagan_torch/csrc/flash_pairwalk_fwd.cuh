// The per-pair work of the forward pair walks, shared by
// flash_pairwalk_fwd.cu (B1, B4 and B5 over the dense mask) and
// flash_pairwalk_fwd_compact.cu (B1c and B5c over the hybrid band's
// compact store), each in fp32 and bf16: the walks' arguments, one lane's
// (row, head) item, the scores of a lane's listed pairs, and the flush
// that turns a row's list into the online softmax and the output
// accumulator.
// Each kernel sets up and writes out its items itself: with that done by
// shared helpers, ptxas gave the dense B4 bf16 walk 96 registers, or 80
// and a spill (chip_smoke.py phase 1).
//
// A walk lists each row's valid pairs as ints; where the pair's key and its
// bias entry lie is the walk's own: a policy object turns a list entry into
// the key's index (`index`) and the offset of the pair's bias (`bias`),
// read where it is used. The dense walk lists the key itself, with the
// bias [G, N, N] (`DenseRowPairs`, flash_pairwalk.cuh); the compact walk
// lists (walk step, column in the tile) and reads the step's slot of the
// bias store [G, S, 64, 64] (`CompactRowPairs`, flash_pairwalk_slots.cuh).
// Either way the entries of one key tile are adjacent and ascending, and
// entry >> 6 names the tile (dense) or the walk step (compact), so the
// flush's softmax steps tile by tile in the walk's order.

#pragma once

#include "flash_pairwalk.cuh"

namespace tagan_pairwalk {

constexpr int UNROLL = 2;         // entries a lane gathers at once

// What a walk computes: B1's out and lse, B5's out and lse2 over the
// biased second softmax, or B4's lse1 alone.
enum Mode : int { OUT = 0, BIASED = 1, LSE = 2 };

// Bytes of a warp's own part of shared memory, past its walk's: q (rounded
// in the bf16 form), the accumulators and the flush's per-entry values,
// each [width][32 lanes]. B4 passes Dv = 0: it keeps no accumulator.
__host__ __device__ inline size_t item_bytes(int D, int Dv) {
  return (size_t)WARP * (D + Dv + CAPR) * 4;
}

// The forward walks' arguments.
struct Walk {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;    // dense: int8 [G, N, N]; compact: the store
  const float* bias;      // dense: [G, N, N]; compact: [G, S, 64, 64]
  const float* lse1;
  const int* jlist;
  const int* jcount;
  const float* scale;
  const int* seeds;
  float* out;
  float* lse;
  int H, N, D, Dv, n_i, W, HG, R, n_hg, n_sub, metric;
  float sqrt_d;
  int use_dropout;
  uint32_t keep_thresh;
  float inv_keep;
  const int* jslot;       // compact: the slot of each walk step
  int S;                  // compact: slots a folded batch index
};

// One lane's (row, head) item: where it reads and what it keeps.
struct Item {
  bool on;
  int gr, g;
  size_t gh;       // g * H + h
  float qn, sc, l1, m, l;
  uint32_t mix1, mix2;   // B1: mix1 only; B5: drop1's and drop2's
  const float* qs;       // q_s + lane, stride 32
  float* acc;            // acc_s + lane, stride 32
};

// z of up to UNROLL listed pairs (the item's row, key gc[u] of entry
// ent[u]) where on[u]: the score from q and k (rounded in the bf16 form;
// the norms from the unrounded rows), and for B5 drop1(exp(s - lse1)) +
// bias. The pairs' k rows are loaded together, so that their gathers are
// in flight at once.
template <bool kBiased, bool kBf16, class Pairs>
__device__ __forceinline__ void pair_z(const Walk& a, const Item& it,
                                       const Pairs& pairs,
                                       const int (&ent)[UNROLL],
                                       const int (&gc)[UNROLL],
                                       const bool (&on)[UNROLL], bool k4,
                                       float (&z)[UNROLL]) {
  const float* kr[UNROLL];
  float qk[UNROLL], kn[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    kr[u] = a.k + (it.gh * a.N + gc[u]) * a.D;
    qk[u] = kn[u] = 0.f;
  }
  if (k4) {
    for (int d = 0; d < a.D; d += 4) {
      float4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        x[u] = on[u] ? __ldg(reinterpret_cast<const float4*>(kr[u] + d))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      const float q0 = it.qs[d * WARP], q1 = it.qs[(d + 1) * WARP],
                  q2 = it.qs[(d + 2) * WARP], q3 = it.qs[(d + 3) * WARP];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        kn[u] += x[u].x * x[u].x;
        qk[u] = fmaf(q0, rd<kBf16>(x[u].x), qk[u]);
        kn[u] += x[u].y * x[u].y;
        qk[u] = fmaf(q1, rd<kBf16>(x[u].y), qk[u]);
        kn[u] += x[u].z * x[u].z;
        qk[u] = fmaf(q2, rd<kBf16>(x[u].z), qk[u]);
        kn[u] += x[u].w * x[u].w;
        qk[u] = fmaf(q3, rd<kBf16>(x[u].w), qk[u]);
      }
    }
  } else {
    for (int d = 0; d < a.D; ++d) {
      float x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) x[u] = on[u] ? __ldg(kr[u] + d) : 0.f;
      const float qd = it.qs[d * WARP];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        kn[u] += x[u] * x[u];
        qk[u] = fmaf(qd, rd<kBf16>(x[u]), qk[u]);
      }
    }
  }
  float bias[UNROLL];
  if constexpr (kBiased) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      bias[u] = on[u] ? __ldg(a.bias + pairs.bias(ent[u])) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    z[u] = score_of(a.metric, qk[u], it.qn, kn[u], it.sc, a.sqrt_d);
    if constexpr (kBiased) {
      // lse1 >= the row's valid scores, so w1 <= 1
      float w1 = expf(z[u] - it.l1);
      if (a.use_dropout) {
        const bool keep = keep_hash(it.mix1, (uint32_t)it.gr,
                                    (uint32_t)gc[u]) < a.keep_thresh;
        w1 = keep ? w1 * a.inv_keep : 0.f;
      }
      z[u] = w1 + bias[u];
    }
  }
}

// The flush of a row list of n entries (the entries of one key tile are
// adjacent and ascending), in three passes. A and C loop over the entries
// in step across the warp (to the longest list), so that every lane's
// gathers are in flight together, UNROLL entries a lane at a time:
//  A. z of every entry into zbuf, and its max mA;
//  B. the online softmax, tile by tile, in shared memory only: for each
//     key tile m_new = max(m, the tile's max z), alpha = exp(m - m_new),
//     p = exp(z - m_new), l = l alpha + sum p (un-dropped), and the dropped
//     p (rounded to bf16 relative to that m_new in the bf16 form, as the
//     dense walk rounds it); zbuf takes that p times exp(m_new - m_fin),
//     m_fin = max(m, mA) the max after the flush, which is the product of
//     the later tiles' alphas;
//  C. acc = acc exp(m_before - m_fin) + sum of zbuf's weights times v
//     (rounded to bf16 in the bf16 form), in the entries' order.
// B4 (kMode LSE) takes pass A only, then l = l exp(m - m_fin) + sum
// exp(z - m_fin) and m = m_fin.
template <int kMode, bool kBf16, class Pairs>
__device__ __forceinline__ void flush(const Walk& a, Item& it,
                                      const Pairs& pairs, const int* list,
                                      int n, float* zbuf) {
  constexpr bool kBiased = kMode == BIASED;
  const bool k4 = (a.D & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(a.k) & 15) == 0;
  const bool v4 = (a.Dv & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(a.v) & 15) == 0;
  const int nmax = __reduce_max_sync(FULL, n);
  float mA = NEG_INF;
  for (int j0 = 0; j0 < nmax; j0 += UNROLL) {
    int ent[UNROLL], gc[UNROLL];
    bool on[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      on[u] = j0 + u < n;
      ent[u] = on[u] ? list[j0 + u] : 0;
      gc[u] = on[u] ? pairs.index(ent[u]) : 0;
    }
    float z[UNROLL];
    pair_z<kBiased, kBf16>(a, it, pairs, ent, gc, on, k4, z);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (on[u]) {
        zbuf[(j0 + u) * WARP] = z[u];
        mA = fmaxf(mA, z[u]);
      }
  }
  if constexpr (kMode == LSE) {
    if (n > 0) {
      const float m_fin = fmaxf(it.m, mA);
      float rs = 0.f;
      for (int j = 0; j < n; ++j) rs += expf(zbuf[j * WARP] - m_fin);
      it.l = it.l * expf(it.m - m_fin) + rs;
      it.m = m_fin;
    }
    return;
  }

  float s0 = 1.f;   // acc's factor
  if (n > 0) {
    const float m_fin = fmaxf(it.m, mA);
    s0 = expf(it.m - m_fin);
    const uint32_t mixp = kBiased ? it.mix2 : it.mix1;
    int e = 0;
    while (e < n) {
      const int tile = list[e] >> 6;
      int f = e + 1;
      while (f < n && (list[f] >> 6) == tile) ++f;
      float mx = NEG_INF;
      for (int j = e; j < f; ++j) mx = fmaxf(mx, zbuf[j * WARP]);
      const float m_new = fmaxf(it.m, mx);
      const float alpha = expf(it.m - m_new);
      const float later = expf(m_new - m_fin);
      float rs = 0.f;
      for (int j = e; j < f; ++j) {
        float p = expf(zbuf[j * WARP] - m_new);
        rs += p;
        if (a.use_dropout) {
          const bool keep =
              keep_hash(mixp, (uint32_t)it.gr,
                        (uint32_t)pairs.index(list[j])) < a.keep_thresh;
          p = keep ? p * a.inv_keep : 0.f;
        }
        zbuf[j * WARP] = rd<kBf16>(p) * later;
      }
      it.l = it.l * alpha + rs;
      it.m = m_new;
      e = f;
    }
    for (int x = 0; x < a.Dv; ++x) it.acc[x * WARP] *= s0;
  }

  const float* vg = a.v + it.gh * a.N * a.Dv;
  for (int j0 = 0; j0 < nmax; j0 += UNROLL) {
    const float* vr[UNROLL];
    float w[UNROLL];
    bool on[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      on[u] = j0 + u < n;
      vr[u] = vg + (size_t)(on[u] ? pairs.index(list[j0 + u]) : 0) * a.Dv;
      w[u] = on[u] ? zbuf[(j0 + u) * WARP] : 0.f;
    }
    if (v4) {
      for (int x = 0; x < a.Dv; x += 4) {
        float4 y[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          y[u] = on[u] ? __ldg(reinterpret_cast<const float4*>(vr[u] + x))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        float c0 = it.acc[x * WARP], c1 = it.acc[(x + 1) * WARP],
              c2 = it.acc[(x + 2) * WARP], c3 = it.acc[(x + 3) * WARP];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          c0 = fmaf(w[u], rd<kBf16>(y[u].x), c0);
          c1 = fmaf(w[u], rd<kBf16>(y[u].y), c1);
          c2 = fmaf(w[u], rd<kBf16>(y[u].z), c2);
          c3 = fmaf(w[u], rd<kBf16>(y[u].w), c3);
        }
        it.acc[x * WARP] = c0;
        it.acc[(x + 1) * WARP] = c1;
        it.acc[(x + 2) * WARP] = c2;
        it.acc[(x + 3) * WARP] = c3;
      }
    } else {
      for (int x = 0; x < a.Dv; ++x) {
        float y[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) y[u] = on[u] ? __ldg(vr[u] + x) : 0.f;
        float c = it.acc[x * WARP];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) c = fmaf(w[u], rd<kBf16>(y[u]), c);
        it.acc[x * WARP] = c;
      }
    }
  }
}

// The bad arguments both walks refuse (before the launch; B4 takes
// Dv = 0).
template <int kMode>
__host__ inline bool bad_walk(const Walk& a, int G) {
  const bool dv_ok = kMode == LSE ? a.Dv == 0 : a.Dv >= 1 && a.Dv <= MAX_D;
  return G < 0 || a.H < 0 || a.N < 0 || a.D < 1 || a.D > MAX_D || !dv_ok ||
         a.metric < 0 || a.metric > COS_DIST ||
         a.n_i != (a.N + BM - 1) / BM || a.W < 0;
}

// B1's walk arguments, one hash seed per g; B5's and B4's start from them.
__host__ inline Walk out_walk(const void* q, const void* k, const void* v,
                              const void* mask, const void* jlist,
                              const void* jcount, const void* scale,
                              const void* seed, void* out, void* lse, int H,
                              int N, int D, int Dv, int n_i, int W,
                              int metric, float sqrt_d, int use_dropout,
                              unsigned int keep_thresh, float inv_keep) {
  Walk a{};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.mask = (const uint8_t*)mask;
  a.jlist = (const int*)jlist;
  a.jcount = (const int*)jcount;
  a.scale = (const float*)scale;
  a.seeds = (const int*)seed;
  a.out = (float*)out;
  a.lse = (float*)lse;
  a.H = H; a.N = N; a.D = D; a.Dv = Dv; a.n_i = n_i; a.W = W;
  a.metric = metric; a.sqrt_d = sqrt_d; a.use_dropout = use_dropout;
  a.keep_thresh = keep_thresh; a.inv_keep = inv_keep;
  return a;
}

// B5's: B1's with the bias, lse1 and two seeds per g, [G, 2].
__host__ inline Walk biased_walk(const void* q, const void* k, const void* v,
                                 const void* mask, const void* bias,
                                 const void* lse1, const void* jlist,
                                 const void* jcount, const void* scale,
                                 const void* seeds, void* out, void* lse2,
                                 int H, int N, int D, int Dv, int n_i, int W,
                                 int metric, float sqrt_d, int use_dropout,
                                 unsigned int keep_thresh, float inv_keep) {
  Walk a = out_walk(q, k, v, mask, jlist, jcount, scale, seeds, out, lse2, H,
                    N, D, Dv, n_i, W, metric, sqrt_d, use_dropout,
                    keep_thresh, inv_keep);
  a.bias = (const float*)bias;
  a.lse1 = (const float*)lse1;
  return a;
}

}  // namespace tagan_pairwalk
