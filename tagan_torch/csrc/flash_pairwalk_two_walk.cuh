// The flushes of the unbiased two-walk backward (fused=False), shared by
// its dense walks (flash_pairwalk_two_walk.cu: B3a over the dense mask's
// forward plan, B3b over its transposed plan) and its compact walks
// (flash_pairwalk_bwd_compact.cu: B3a c and B3b c over the hybrid band's
// store), each in fp32 and bf16 (the template flag kBf16). Each flush
// takes its walk's policy object, which turns a list entry into the
// pair's key (row) index (`DenseRowPairs`, `DenseKeyPairs`: the entry is
// the index; `CompactRowPairs`, `CompactKeyPairs`: walk step and place in
// the tile), and gathers at the listed pairs only:
//
//     p_ij  = exp(s_ij - lse_i),          dp_ij = drop(do_i . v_j),
//     ds_ij = p_ij (dp_ij - delta_i),     W_ij  = the chain weight of ds,
//     dq_i += W_ij k_j  (dq_pass),        dk_j += W_ij q_i,
//     dv_j += drop(p_ij) do_i  (dkv_pass),
//
// with the sums of W and, in the row flush, the d(scale) term. The walks'
// arguments, items and outputs are the biased walks'
// (flash_pairwalk_biased_bwd.cuh): lse rides in `lse1`, delta in `delta1`
// (the row item reads it into `d1`), one dropout seed a batch index.

#pragma once

#include "flash_pairwalk_biased_bwd.cuh"

namespace tagan_pairwalk {

// The flush of a row list of n entries (ascending), every lane of the warp
// in step (to the longest list): dq_i in the lane's slots, the sum of W and
// the d(scale) term. The item carries lse in `lse1` and delta in `d1`.
template <bool kBf16, class Pairs>
__device__ __forceinline__ void dq_pass(const Bwd& a, RowItem& it,
                                        const Pairs& pairs,
                                        const int* list, int n) {
  const bool k4 = (a.D & 3) == 0 && aligned16(a.k);
  const bool v4 = (a.Dv & 3) == 0 && aligned16(a.v);
  const float* kg = a.k + it.gh * a.N * a.D;
  const float* vg = a.v + it.gh * a.N * a.Dv;
  const int nmax = __reduce_max_sync(FULL, n);
  for (int e = 0; e < nmax; ++e) {
    if (e >= n) continue;
    const int gc = pairs.index(list[e]);
    const float* kr = kg + (size_t)gc * a.D;
    const float* vr = vg + (size_t)gc * a.Dv;
    // q.k (bf16: of rounded operands), |k|^2 of the unrounded row, do.v
    float qk = 0.f, kn = 0.f, dp = 0.f;
    if (k4) {
      for (int d = 0; d < a.D; d += 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(kr + d));
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
        const float x = __ldg(kr + d);
        kn += x * x;
        qk = fmaf(it.qs[d * WARP], rd<kBf16>(x), qk);
      }
    }
    if (v4) {
      for (int c = 0; c < a.Dv; c += 4) {
        const float4 y = __ldg(reinterpret_cast<const float4*>(vr + c));
        dp = fmaf(it.dos[c * WARP], rd<kBf16>(y.x), dp);
        dp = fmaf(it.dos[(c + 1) * WARP], rd<kBf16>(y.y), dp);
        dp = fmaf(it.dos[(c + 2) * WARP], rd<kBf16>(y.z), dp);
        dp = fmaf(it.dos[(c + 3) * WARP], rd<kBf16>(y.w), dp);
      }
    } else {
      for (int c = 0; c < a.Dv; ++c)
        dp = fmaf(it.dos[c * WARP], rd<kBf16>(__ldg(vr + c)), dp);
    }
    const float s = score_of(a.metric, qk, it.qn, kn, it.sc, a.sqrt_d);
    const float sq = fmaxf(it.qn + kn - 2.f * qk, 0.f);
    const float p = expf(s - it.lse1);   // lse >= the row's s; dead: 0
    float dpv = dp;
    if (a.use_dropout)
      dpv = keep_hash(it.mix1, (uint32_t)it.gr, (uint32_t)gc) <
                    a.keep_thresh
                ? dp * a.inv_keep
                : 0.f;
    const float ds = p * (dpv - it.d1);
    const float w =
        kBf16 ? chain_weight_bf16(a.metric, ds, s, sq, qk, it.sc)
              : chain_weight(a.metric, ds, s, sq, qk, it.sc, a.sqrt_d);
    it.dsc = fmaf(ds * s, sq, it.dsc);
    it.wsum += w;
    const float wq = rd<kBf16>(w);
    // dq_i += W k_j (bf16: rounded): the k row again, now in L1
    for (int d = 0; d < a.D; ++d)
      it.dq[d * WARP] = fmaf(wq, rd<kBf16>(__ldg(kr + d)), it.dq[d * WARP]);
  }
}

// The flush of a key list of n rows (ascending), every lane of the warp in
// step (to the longest list): dk_j and dv_j in the lane's slots. The
// walk's arguments carry lse in `lse1` and delta in `delta1`.
template <bool kBf16, class Pairs>
__device__ __forceinline__ void dkv_pass(const Bwd& a, KeyItem& it,
                                         const Pairs& pairs,
                                         const int* list, int n, int nthr) {
  const bool q4 = (a.D & 3) == 0 && aligned16(a.q);
  const bool o4 = (a.Dv & 3) == 0 && aligned16(a.dout);
  const int nmax = __reduce_max_sync(FULL, n);
  for (int e = 0; e < nmax; ++e) {
    if (!(it.on && e < n)) continue;
    const int gr = pairs.index(list[e]);
    const size_t row = it.gh * a.N + gr;
    const float* qr = a.q + row * a.D;
    const float* dor = a.dout + row * a.Dv;
    // q.k (bf16: of rounded operands), |q|^2 of the unrounded row, do.v
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
    const float s = score_of(a.metric, qk, qn, it.kn, it.sc, a.sqrt_d);
    const float sq = fmaxf(qn + it.kn - 2.f * qk, 0.f);
    const float p = expf(s - __ldg(a.lse1 + row));   // lse >= the row's s
    float pd = p, dpv = dp;
    if (a.use_dropout) {
      const bool keep = keep_hash(it.mix1, (uint32_t)gr, (uint32_t)it.gc) <
                        a.keep_thresh;
      pd = keep ? p * a.inv_keep : 0.f;
      dpv = keep ? dp * a.inv_keep : 0.f;
    }
    const float ds = p * (dpv - __ldg(a.delta1 + row));
    const float w =
        kBf16 ? chain_weight_bf16(a.metric, ds, s, sq, qk, it.sc)
              : chain_weight(a.metric, ds, s, sq, qk, it.sc, a.sqrt_d);
    it.wsum += w;
    const float wk = rd<kBf16>(w), pr = rd<kBf16>(pd);
    // dk_j += W q_i and dv_j += drop(p) do_i (bf16: rounded): the rows
    // again, now in L1
    for (int d = 0; d < a.D; ++d)
      it.dk[d * nthr] = fmaf(wk, rd<kBf16>(__ldg(qr + d)), it.dk[d * nthr]);
    if (pr != 0.f)
      for (int c = 0; c < a.Dv; ++c)
        it.dv[c * nthr] = fmaf(pr, rd<kBf16>(__ldg(dor + c)), it.dv[c * nthr]);
  }
}

}  // namespace tagan_pairwalk
