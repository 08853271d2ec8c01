// Edge-masked geometric attention, backward, as a mask-driven pair walk,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tagan_tpu/ops/pallas/flash_geometric.py::
// _flash_bwd_fused_kernel (B2; host side _bwd_fused_call, public
// flash_geometric_attention_bwd(..., fused=True)) in its dense-mask forms,
// bf16=False and bf16=True (the template flag kBf16): dq, dk, dv and
// d(scale) in one walk. At every valid pair (i, j) and head h it computes
// what B3a's and B3b's forms of the same precision (the flushes `dq_pass`
// and `dkv_pass` of flash_pairwalk_two_walk.cuh) compute per pair:
//
//   s  = the metric score of q_i and k_j,   p  = exp(s - lse_i),
//   dp = drop(do_i . v_j),                  ds = p (dp - delta_i),
//   dq_i += W k_j,  dk_j += W q_i,          dv_j += drop(p) do_i,
//
// with W the pair's chain weight, and for the squared-distance metrics
// subtracts the row and column sums of W times q_i and k_j; d(scale) sums
// ds s sq. The dropout is the coordinate hash (keep_hash) with seed[g].
//  - fp32 (bf16=False): every operand unrounded, W = chain_weight (the
//    scaled dot's 1/sqrt(d) inside it). The CPU's fp32 function up to the
//    order of the sums.
//  - bf16 (bf16=True): q and k rounded to bf16 after their fp32 norms, do,
//    v, W (chain_weight_bf16) and drop(p) rounded as operands of their
//    products, the row and column sums of W and the squared-distance
//    metrics' q and k terms fp32; the scaled dot divides the dq and dk sums
//    by sqrt(d) (`chain_finish`).
// p is normalised by the forward's lse, with no running max, so the result
// depends on no walk: rows and pairs may be taken in any order.
//
// What bounds it on the H100. As for the forward pair walks
// (flash_pairwalk_fwd.cu): each snapshot's int8 mask is N^2 bytes (100 MB
// at N = 10,000), read once, and the rest (q, k, v, do, lse, delta and the
// outputs) is small beside it, so the least time is the mask's bytes over
// the memory rate. A dense tile walk computes all 4,096 pairs of every
// walked 64 x 64 tile, once per head; at 16 edges a row over 10,000 nodes a
// tile holds ~6.5 valid pairs.
//
// Design. The forward pair walk's, over the forward plan (jlist, jcount):
// one warp is one block and one unit, R rows of one 64-row query tile for
// a group of HG heads (R * HG <= 32), each lane one (row, head) item whose
// q_i and do_i and whose dq_i accumulator stay in its shared slots, so dq
// needs no atomics. (The fp32 form stages them in the same fp32 slots as
// the bf16 form, which keeps its rounded values as floats: 66 KB a warp at
// D = Dv = 128 and H = 1.) The mask is read once for all the group's heads
// and each row's valid columns are listed (`walk_mask`,
// flash_pairwalk.cuh). At a flush the warp steps through the rows' lists
// together, UNROLL entries a lane at a time, so that the gathers of all
// lanes are in flight at once (the forward walk's lesson): k_j and v_j are
// gathered from global memory (one snapshot's K and V stay in L2) for s and
// dp, then k_j again (now in L1) for dq_i and dk_j. dk_j and dv_j are added
// into zeroed fp32 outputs with atomicAdd, four floats at a time where the
// width is a multiple of 4 (`TAGAN_VEC4_ATOMICS`), the squared-distance
// metrics' column term folded into each pair's dk_j addend (W q_i - W k_j)
// and the bf16 scaled dot's 1/sqrt(d) into its rounded W. Unlike the
// forward there is no per-entry buffer: each pair is finished where it is
// formed. d(scale) is reduced over the warp's rows and added per (g, h)
// with atomicAdd. So dk, dv and d(scale) vary in their last bits from run
// to run; B3a + B3b (fused=False) are the deterministic form in both
// precisions.
//
// Why not a transposed walk, which would keep dk_j and dv_j in registers:
// it reads each mask row in R-byte pieces of a 64-byte tile row, ~4x the
// mask's sectors, and the mask stream is already most of the forward
// walk's time.
//
// Interface: plain C, loaded with ctypes; the same entry points and
// arguments as the dense template had, but the walk is the forward plan
// and the d(scale) partials are [G, H]. Launches on the given stream,
// allocates nothing (dk, dv and the partials must be zeroed by the
// caller), returns the cudaError_t of the launch.

#include "flash_pairwalk.cuh"

#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 ||    \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 2))
#define TAGAN_VEC4_ATOMICS 1
#else
#define TAGAN_VEC4_ATOMICS 0
#endif

namespace {

using namespace tagan_pairwalk;

// entries a lane gathers at once: 1 beat 2 and 4 here (pairwalk_variants.py
// on the H100: 0.140 / 0.160 / 0.148 ms a snapshot over a 16-snapshot fold
// at degree 16), where the forward walk takes 2
constexpr int UNROLL = 1;

// The walk's arguments.
struct Bwd {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;
  const float* dout;
  const float* lse;
  const float* delta;
  const int* jlist;
  const int* jcount;
  const float* scale;
  const int* seed;
  float* dq;
  float* dk;
  float* dv;
  float* dscale;
  int H, N, D, Dv, n_i, W, HG, R, n_hg, metric;
  float sqrt_d;
  int use_dropout;
  uint32_t keep_thresh;
  float inv_keep;
  int need_dscale;
};

// Bytes of one warp's (one block's) shared memory: the walk's, then q and
// do (rounded in the bf16 form) and the dq accumulator, each
// [width][32 lanes].
__host__ __device__ inline size_t warp_bytes(int R, int D, int Dv) {
  return walk_bytes(R) + (size_t)WARP * (2 * D + Dv) * 4;
}

// One lane's (row, head) item.
struct Item {
  bool on;
  int gr;
  size_t gh;             // g * H + h
  float qn, sc, lse, delta, wsum, dsc;
  uint32_t mix;
  const float* qs;       // q_s + lane, stride 32
  const float* dos;      // do_s + lane, stride 32
  float* dq;             // dq_s + lane, stride 32
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[0..4) += (x, y, z, w): one float4 atomic where `vec` (dst 16-byte
// aligned) and the compiler has them, else four.
__device__ __forceinline__ void add4(float* dst, float x, float y, float z,
                                     float w, bool vec) {
#if TAGAN_VEC4_ATOMICS
  if (vec) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(x, y, z, w));
    return;
  }
#endif
  atomicAdd(dst, x);
  atomicAdd(dst + 1, y);
  atomicAdd(dst + 2, z);
  atomicAdd(dst + 3, w);
}

// The flush of a row list of n entries: every listed pair's gradients,
// UNROLL entries a lane at a time in step across the warp (to the longest
// list).
template <bool kBf16>
__device__ __forceinline__ void flush(const Bwd& a, Item& it, const int* list,
                                      int n) {
  const bool k4 = (a.D & 3) == 0 && aligned16(a.k) && aligned16(a.dk);
  const bool v4 = (a.Dv & 3) == 0 && aligned16(a.v) && aligned16(a.dv);
  const bool sqm = is_sq_metric(a.metric);
  // the bf16 forms' scaled dot divides its dk sum by sqrt(d) here; the fp32
  // chain weight holds 1/sqrt(d) already
  const float fin = kBf16 && a.metric == SCALED_DOT ? 1.f / a.sqrt_d : 1.f;
  const float* kg = a.k + it.gh * a.N * a.D;
  const float* vg = a.v + it.gh * a.N * a.Dv;
  float* dkg = a.dk + it.gh * a.N * a.D;
  float* dvg = a.dv + it.gh * a.N * a.Dv;
  const int nmax = __reduce_max_sync(FULL, n);
  for (int j0 = 0; j0 < nmax; j0 += UNROLL) {
    int gc[UNROLL];
    bool on[UNROLL];
    const float* kr[UNROLL];
    const float* vr[UNROLL];
    float qk[UNROLL], kn[UNROLL], dp[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      on[u] = j0 + u < n;
      gc[u] = on[u] ? list[j0 + u] : 0;
      kr[u] = kg + (size_t)gc[u] * a.D;
      vr[u] = vg + (size_t)gc[u] * a.Dv;
      qk[u] = kn[u] = dp[u] = 0.f;
    }
    // q.k (bf16: from rounded operands) and |k|^2 from the unrounded row
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
    // do.v (bf16: from rounded operands)
    if (v4) {
      for (int e = 0; e < a.Dv; e += 4) {
        float4 y[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          y[u] = on[u] ? __ldg(reinterpret_cast<const float4*>(vr[u] + e))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        const float o0 = it.dos[e * WARP], o1 = it.dos[(e + 1) * WARP],
                    o2 = it.dos[(e + 2) * WARP], o3 = it.dos[(e + 3) * WARP];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          dp[u] = fmaf(o0, rd<kBf16>(y[u].x), dp[u]);
          dp[u] = fmaf(o1, rd<kBf16>(y[u].y), dp[u]);
          dp[u] = fmaf(o2, rd<kBf16>(y[u].z), dp[u]);
          dp[u] = fmaf(o3, rd<kBf16>(y[u].w), dp[u]);
        }
      }
    } else {
      for (int e = 0; e < a.Dv; ++e) {
        float y[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) y[u] = on[u] ? __ldg(vr[u] + e) : 0.f;
        const float oe = it.dos[e * WARP];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          dp[u] = fmaf(oe, rd<kBf16>(y[u]), dp[u]);
      }
    }
    // the pair's weights: wq multiplies k_j into dq_i, wk q_i into dk_j,
    // wc (squared distances: W itself) k_j out of dk_j, pr do_i into dv_j
    float wq[UNROLL], wk[UNROLL], wc[UNROLL], pr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      wq[u] = wk[u] = wc[u] = pr[u] = 0.f;
      if (!on[u]) continue;
      const float s = score_of(a.metric, qk[u], it.qn, kn[u], it.sc,
                               a.sqrt_d);
      const float sq = fmaxf(it.qn + kn[u] - 2.f * qk[u], 0.f);
      // lse_i >= the row's valid scores, so p <= 1
      const float p = expf(s - it.lse);
      float dpv = dp[u], pd = p;
      if (a.use_dropout) {
        const bool keep = keep_hash(it.mix, (uint32_t)it.gr,
                                    (uint32_t)gc[u]) < a.keep_thresh;
        dpv = keep ? dpv * a.inv_keep : 0.f;
        pd = keep ? p * a.inv_keep : 0.f;
      }
      const float ds = p * (dpv - it.delta);
      const float w =
          kBf16 ? chain_weight_bf16(a.metric, ds, s, sq, qk[u], it.sc)
                : chain_weight(a.metric, ds, s, sq, qk[u], it.sc, a.sqrt_d);
      it.dsc = fmaf(ds * s, sq, it.dsc);
      it.wsum += w;
      wq[u] = rd<kBf16>(w);
      wk[u] = wq[u] * fin;
      wc[u] = sqm ? w : 0.f;
      pr[u] = rd<kBf16>(pd);
    }
    // dq_i += rd(W) k_j and dk_j += rd(W) q_i - [sq] W k_j (rd the bf16
    // form's rounding): k rows again
    if (k4) {
      for (int d = 0; d < a.D; d += 4) {
        float4 x[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          x[u] = on[u] ? __ldg(reinterpret_cast<const float4*>(kr[u] + d))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        const float q0 = it.qs[d * WARP], q1 = it.qs[(d + 1) * WARP],
                    q2 = it.qs[(d + 2) * WARP], q3 = it.qs[(d + 3) * WARP];
        float c0 = it.dq[d * WARP], c1 = it.dq[(d + 1) * WARP],
              c2 = it.dq[(d + 2) * WARP], c3 = it.dq[(d + 3) * WARP];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          c0 = fmaf(wq[u], rd<kBf16>(x[u].x), c0);
          c1 = fmaf(wq[u], rd<kBf16>(x[u].y), c1);
          c2 = fmaf(wq[u], rd<kBf16>(x[u].z), c2);
          c3 = fmaf(wq[u], rd<kBf16>(x[u].w), c3);
        }
        it.dq[d * WARP] = c0;
        it.dq[(d + 1) * WARP] = c1;
        it.dq[(d + 2) * WARP] = c2;
        it.dq[(d + 3) * WARP] = c3;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (on[u] && (wk[u] != 0.f || wc[u] != 0.f))
            add4(dkg + (size_t)gc[u] * a.D + d,
                 fmaf(wk[u], q0, -wc[u] * x[u].x),
                 fmaf(wk[u], q1, -wc[u] * x[u].y),
                 fmaf(wk[u], q2, -wc[u] * x[u].z),
                 fmaf(wk[u], q3, -wc[u] * x[u].w), true);
      }
    } else {
      for (int d = 0; d < a.D; ++d) {
        float x[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) x[u] = on[u] ? __ldg(kr[u] + d) : 0.f;
        const float qd = it.qs[d * WARP];
        float c = it.dq[d * WARP];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) c = fmaf(wq[u], rd<kBf16>(x[u]), c);
        it.dq[d * WARP] = c;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (on[u] && (wk[u] != 0.f || wc[u] != 0.f))
            atomicAdd(dkg + (size_t)gc[u] * a.D + d,
                      fmaf(wk[u], qd, -wc[u] * x[u]));
      }
    }
    // dv_j += rd(drop(p)) do_i
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!on[u] || pr[u] == 0.f) continue;
      float* dst = dvg + (size_t)gc[u] * a.Dv;
      if (v4) {
        for (int e = 0; e < a.Dv; e += 4)
          add4(dst + e, pr[u] * it.dos[e * WARP],
               pr[u] * it.dos[(e + 1) * WARP], pr[u] * it.dos[(e + 2) * WARP],
               pr[u] * it.dos[(e + 3) * WARP], true);
      } else {
        for (int e = 0; e < a.Dv; ++e)
          atomicAdd(dst + e, pr[u] * it.dos[e * WARP]);
      }
    }
  }
}

template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(WARP)
pairwalk_bwd_kernel(const Bwd a) {
  const int lane = threadIdx.x;
  const int R = a.R;
  // hg innermost, so that the head groups of one sub-tile read its mask
  // together
  const int hg = (int)(blockIdx.x % a.n_hg), sub = (int)(blockIdx.x / a.n_hg);
  const int g = blockIdx.y;
  const int ib = sub / (BM / R), row0 = sub * R;

  extern __shared__ __align__(16) uint8_t smem[];
  const WalkSmem sm = walk_smem(smem, R);
  float* q_s = reinterpret_cast<float*>(sm.rest);
  float* do_s = q_s + WARP * a.D;
  float* dq_s = do_s + WARP * a.Dv;

  Item it;
  const int rl = lane / a.HG, h = hg * a.HG + lane % a.HG;
  it.gr = row0 + rl;
  it.on = lane < R * a.HG && h < a.H && it.gr < a.N;
  it.gh = (size_t)g * a.H + (it.on ? h : 0);
  it.qs = q_s + lane;
  it.dos = do_s + lane;
  it.dq = dq_s + lane;
  it.qn = it.lse = it.delta = it.wsum = it.dsc = 0.f;
  it.sc = 1.f;
  it.mix = 0u;
  const size_t row = it.gh * a.N + it.gr;
  if (it.on) {
    const float* qr = a.q + row * a.D;
    for (int d = 0; d < a.D; ++d) {   // the norm, then the row (rounded)
      const float x = qr[d];
      it.qn += x * x;
      q_s[d * WARP + lane] = rd<kBf16>(x);
      dq_s[d * WARP + lane] = 0.f;
    }
    const float* dor = a.dout + row * a.Dv;
    for (int e = 0; e < a.Dv; ++e) do_s[e * WARP + lane] = rd<kBf16>(dor[e]);
    it.lse = a.lse[row];
    it.delta = a.delta[row];
    it.sc = a.scale[h];
    it.mix = (uint32_t)a.seed[g] ^ ((uint32_t)h * 0xC2B2AE3Du);
  }

  const int cnt = a.jcount[(size_t)g * a.n_i + ib];
  const int* jl = a.jlist + ((size_t)g * a.n_i + ib) * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  walk_mask<kVec16>(sm, mg, a.N, row0, R, jl, cnt, lane, [&]() {
    flush<kBf16>(a, it, sm.lists + rl * CAPR, it.on ? sm.rowcnt[rl] : 0);
  });

  if (it.on) {   // dead rows: no pair, dq = 0
    const bool sqm = is_sq_metric(a.metric);
    const float* qr = a.q + row * a.D;
    float* og = a.dq + row * a.D;
    for (int d = 0; d < a.D; ++d) {
      const float x = dq_s[d * WARP + lane];
      og[d] = sqm ? x - it.wsum * qr[d]
                  : chain_finish<kBf16>(a.metric, x, a.sqrt_d);
    }
  }
  if (a.need_dscale) {
    // the walk is done with the row counts: reduce over the warp's rows
    float* red = reinterpret_cast<float*>(sm.rowcnt);
    red[lane] = it.on ? it.dsc * dscale_factor(a.metric, it.sc) : 0.f;
    __syncwarp();
    if (lane < a.HG && h < a.H) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += red[r * a.HG + lane];
      atomicAdd(a.dscale + (size_t)g * a.H + h, s);
    }
  }
}

template <bool kBf16>
int launch(Bwd a, int G, void* stream) {
  if (G < 0 || a.H < 0 || a.N < 0 || a.D < 1 || a.D > MAX_D || a.Dv < 1 ||
      a.Dv > MAX_D || a.metric < 0 || a.metric > COS_DIST ||
      a.n_i != (a.N + BM - 1) / BM || a.W < 0)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  warp_items(a.H, &a.HG, &a.R);
  a.n_hg = (a.H + a.HG - 1) / a.HG;
  const int n_sub = a.n_i * (BM / a.R);
  const size_t smem = warp_bytes(a.R, a.D, a.Dv);
  const bool vec16 = a.N % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0;
  const auto kern = vec16 ? pairwalk_bwd_kernel<kBf16, true>
                          : pairwalk_bwd_kernel<kBf16, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)n_sub * a.n_hg, G);
  kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// B2: dq [G, H, N, D], dk [G, H, N, D] and dv [G, H, N, Dv]
// (both summed into the caller's zeroed buffers) and, with need_dscale,
// the d(scale) partials [G, H] (zeroed by the caller), over the forward
// walk (jlist, jcount [G, n_i, W], [G, n_i]) of the dense int8 mask
// [G, N, N], one hash seed per g.
extern "C" int tagan_flash_geometric_bwd_fused(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* scale, const void* seed, void* dq,
    void* dk, void* dv, void* dscale_part, int G, int H, int N, int D,
    int Dv, int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, int need_dscale,
    void* stream) {
  Bwd a{};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.mask = (const uint8_t*)mask;
  a.dout = (const float*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.jlist = (const int*)jlist;
  a.jcount = (const int*)jcount;
  a.scale = (const float*)scale;
  a.seed = (const int*)seed;
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.dscale = (float*)dscale_part;
  a.H = H; a.N = N; a.D = D; a.Dv = Dv; a.n_i = n_i; a.W = W;
  a.metric = metric; a.sqrt_d = sqrt_d; a.use_dropout = use_dropout;
  a.keep_thresh = keep_thresh; a.inv_keep = inv_keep;
  a.need_dscale = need_dscale;
  return launch<false>(a, G, stream);
}

// B2's bf16 form: dq [G, H, N, D], dk [G, H, N, D] and dv [G, H, N, Dv]
// (both summed into the caller's zeroed buffers) and, with need_dscale,
// the d(scale) partials [G, H] (zeroed by the caller), over the forward
// walk (jlist, jcount [G, n_i, W], [G, n_i]) of the dense int8 mask
// [G, N, N], one hash seed per g.
extern "C" int tagan_flash_geometric_bwd_fused_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, const void* jlist,
    const void* jcount, const void* scale, const void* seed, void* dq,
    void* dk, void* dv, void* dscale_part, int G, int H, int N, int D,
    int Dv, int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, int need_dscale,
    void* stream) {
  Bwd a{};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.mask = (const uint8_t*)mask;
  a.dout = (const float*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.jlist = (const int*)jlist;
  a.jcount = (const int*)jcount;
  a.scale = (const float*)scale;
  a.seed = (const int*)seed;
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.dscale = (float*)dscale_part;
  a.H = H; a.N = N; a.D = D; a.Dv = Dv; a.n_i = n_i; a.W = W;
  a.metric = metric; a.sqrt_d = sqrt_d; a.use_dropout = use_dropout;
  a.keep_thresh = keep_thresh; a.inv_keep = inv_keep;
  a.need_dscale = need_dscale;
  return launch<true>(a, G, stream);
}
