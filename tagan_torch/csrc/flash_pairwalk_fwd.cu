// Edge-masked geometric attention forwards as mask-driven pair walks, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// in their dense-mask forms:
//
//   B1       _flash_kernel         (host side _flash_forward), bf16=False
//   B1 bf16  _flash_kernel         bf16=True
//   B4 bf16  _lse1_kernel          (host side _flash_biased_forward)
//   B5 bf16  _flash_biased_kernel  (host side _flash_biased_forward)
//
// For each query row i and head h the walk takes the key tiles
// jlist[g, tile, :jcount[g, tile]] in that order: an online softmax whose
// running max is updated once per 64-key tile, the un-dropped denominator,
// the coordinate-hash dropout (keep_hash; B5's two seeds), out = 0 and
// lse = 1e30 on rows with no valid key. The squared-distance metrics use
// the norm expansion, the cosine metrics take q and k L2-normalised by the
// caller, gaussian and rbf a per-head scale (score_of). The precision is
// the template flag kBf16:
//  - fp32 (B1, bf16=False): q and k stay unrounded, q.k is an fp32 sum, p
//    is not rounded and multiplies unrounded v. This is the CPU's fp32
//    function up to the order of the sums.
//  - bf16 (bf16=True): q.k from q and k rounded to bf16 after their fp32
//    norms, drop(p) rounded to bf16 relative to the tile's running max and
//    multiplied by v rounded to bf16, fp32 sums.
// B5 takes lse1 as an input, forms z = drop1(exp(s - lse1)) +
// bias[g, i, j] on valid pairs only (a dropped w1 enters as z = bias), and
// runs the same online softmax over z. B4 keeps only the running max and
// the un-dropped sum of exp(s) and writes lse1 (1e30 on rows with no
// valid key); its result depends on no walk, so a flush folds its pairs
// into (m, l) at once.
//
// What bounds it on the H100. Each snapshot's int8 mask is N^2 bytes (100
// MB at N = 10,000), more than the 50 MB L2, and the function needs it read
// once; q, k, v, out (and B5's bias at the valid pairs) are small beside it.
// So the least time is the mask's bytes over the memory rate. A dense tile
// walk computes every pair of every walked 64 x 64 tile, once per head, and
// reads the mask once per head: at 16 edges a row over 10,000 nodes each
// tile holds ~6.5 valid pairs of its 4,096.
//
// Design. One warp is one block and one unit of work: R rows of one
// 64-row query tile of one folded snapshot g, for a group of HG heads
// (all H where H <= 32), R * HG <= 32, each lane one (row, head) item. No
// block barrier is taken. (Blocks of 4 independent warps measured up to
// 10% slower: shared memory is then granted 4 warps at a time.)
//  1. The mask is read once for all the group's heads, and each row's
//     valid columns are listed in shared memory (`walk_mask`,
//     flash_pairwalk.cuh, shared with B2's walk).
//  2. When a row's list could overflow, and at the end, the warp flushes,
//     computing only the valid pairs, in three passes (`flush`): the
//     scores of all listed pairs (q.k over D from q in shared memory and
//     k gathered from global memory: one snapshot's K and V stay in L2;
//     score_of; for B5 w1, drop1 and the bias at that pair), then the
//     online softmax tile by tile in shared memory, then drop(p) v into
//     the row's accumulator. The gathering passes step through the entries
//     together across the warp, 2 entries a lane at a time, so that the
//     gathers of all lanes are in flight at once: a lane walking its own
//     list alone left the warp's rows to diverge and their gathers to
//     follow one another. Rows with no pair in a tile are not touched,
//     which is exact (m unchanged, alpha = 1), so the dense template's
//     "p = 1 garbage" before a row's first valid key does not arise. B4
//     takes the first pass only.
//  3. Units are sub-tiles of R rows (8 at H = 4), so one 10K snapshot
//     gives 1,250 warps: every SM is busy at G = 1 as at G = 16.
// The fp32 form stages q and the accumulators in fp32 slots as the bf16
// form does (the bf16 form keeps its rounded values as floats), so both
// take the same shared memory: 57 KB a warp at D = Dv = 128 and H = 1.
//
// What it does not do: tensor cores. A tile whose rows hold many pairs is
// walked pair by pair on the CUDA cores, each pair's k and v rows gathered
// for each of its heads; it is correct at any density and its speed there
// is recorded, not targeted. For the fp32 form TF32's 10-bit mantissa
// would also break the fp32 contract (the 1e-4 gate against the CPU).
//
// Interface: plain C, loaded with ctypes; the same entry points and
// arguments as the dense templates had. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include "flash_pairwalk.cuh"

namespace {

using namespace tagan_pairwalk;

constexpr int UNROLL = 2;         // entries a lane gathers at once

// What a walk computes: B1's out and lse, B5's out and lse2 over the
// biased second softmax, or B4's lse1 alone.
enum Mode : int { OUT = 0, BIASED = 1, LSE = 2 };

// Bytes of one warp's (one block's) shared memory: the mask ring, the
// rows' lists and counts, and q (rounded in the bf16 form), the
// accumulators and the flush's per-entry values, each [width][32 lanes].
// B4 passes Dv = 0: it keeps no accumulator.
__host__ __device__ inline size_t warp_bytes(int R, int D, int Dv) {
  return walk_bytes(R) + (size_t)WARP * (D + Dv + CAPR) * 4;
}

// The pair walk's arguments.
struct Walk {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;
  const float* bias;
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

// z of up to UNROLL pairs (the item's row, gc[u]) where on[u]: the score
// from q and k (rounded in the bf16 form; the norms from the unrounded
// rows), and for B5
// drop1(exp(s - lse1)) + bias. The pairs' k rows are loaded together, so
// that their gathers are in flight at once.
template <bool kBiased, bool kBf16>
__device__ __forceinline__ void pair_z(const Walk& a, const Item& it,
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
      bias[u] = on[u] ? __ldg(a.bias + ((size_t)it.g * a.N + it.gr) * a.N +
                              gc[u])
                      : 0.f;
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
template <int kMode, bool kBf16>
__device__ __forceinline__ void flush(const Walk& a, Item& it,
                                      const int* list, int n, float* zbuf) {
  constexpr bool kBiased = kMode == BIASED;
  const bool k4 = (a.D & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(a.k) & 15) == 0;
  const bool v4 = (a.Dv & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(a.v) & 15) == 0;
  const int nmax = __reduce_max_sync(FULL, n);
  float mA = NEG_INF;
  for (int j0 = 0; j0 < nmax; j0 += UNROLL) {
    int gc[UNROLL];
    bool on[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      on[u] = j0 + u < n;
      gc[u] = on[u] ? list[j0 + u] : 0;
    }
    float z[UNROLL];
    pair_z<kBiased, kBf16>(a, it, gc, on, k4, z);
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
          const bool keep = keep_hash(mixp, (uint32_t)it.gr,
                                      (uint32_t)list[j]) < a.keep_thresh;
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
      vr[u] = vg + (size_t)(on[u] ? list[j0 + u] : 0) * a.Dv;
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

template <int kMode, bool kBf16, bool kVec16>
__global__ void __launch_bounds__(WARP)
pairwalk_fwd_kernel(const Walk a) {
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
  float* acc_s = q_s + WARP * a.D;
  float* zbuf = acc_s + WARP * a.Dv + lane;

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
    for (int d = 0; d < a.D; ++d) {   // the norm, then the row (rounded)
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

  const int cnt = a.jcount[(size_t)g * a.n_i + ib];
  const int* jl = a.jlist + ((size_t)g * a.n_i + ib) * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  walk_mask<kVec16>(sm, mg, a.N, row0, R, jl, cnt, lane, [&]() {
    flush<kMode, kBf16>(a, it, sm.lists + rl * CAPR,
                        it.on ? sm.rowcnt[rl] : 0, zbuf);
  });

  if (it.on) {
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

template <int kMode, bool kBf16>
int launch(Walk a, int G, void* stream) {
  const bool dv_ok = kMode == LSE ? a.Dv == 0 : a.Dv >= 1 && a.Dv <= MAX_D;
  if (G < 0 || a.H < 0 || a.N < 0 || a.D < 1 || a.D > MAX_D || !dv_ok ||
      a.metric < 0 || a.metric > COS_DIST ||
      a.n_i != (a.N + BM - 1) / BM || a.W < 0)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  warp_items(a.H, &a.HG, &a.R);
  a.n_hg = (a.H + a.HG - 1) / a.HG;
  a.n_sub = a.n_i * (BM / a.R);
  const size_t smem = warp_bytes(a.R, a.D, a.Dv);
  const bool vec16 = a.N % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0;
  const auto kern = vec16 ? pairwalk_fwd_kernel<kMode, kBf16, true>
                          : pairwalk_fwd_kernel<kMode, kBf16, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)a.n_sub * a.n_hg, G);
  kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// B1: out [G, H, N, Dv] and lse [G, H, N] of the forward walk
// over the dense int8 mask [G, N, N], one hash seed per g.
extern "C" int tagan_flash_geometric_fwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* jlist, const void* jcount, const void* scale,
    const void* seed, void* out, void* lse, int G, int H, int N, int D,
    int Dv, int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
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
  return launch<OUT, false>(a, G, stream);
}

// B1's bf16 form: out [G, H, N, Dv] and lse [G, H, N] of the forward walk
// over the dense int8 mask [G, N, N], one hash seed per g.
extern "C" int tagan_flash_geometric_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* jlist, const void* jcount, const void* scale,
    const void* seed, void* out, void* lse, int G, int H, int N, int D,
    int Dv, int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, void* stream) {
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
  return launch<OUT, true>(a, G, stream);
}

// B5's bf16 form: out [G, H, N, Dv] and lse2 [G, H, N] of the second
// softmax, given lse1 [G, H, N], the bias [G, N, N] and two seeds per g,
// [G, 2].
extern "C" int tagan_flash_biased_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* lse1, const void* jlist, const void* jcount,
    const void* scale, const void* seeds, void* out, void* lse2, int G, int H,
    int N, int D, int Dv, int n_i, int W, int metric, float sqrt_d,
    int use_dropout, unsigned int keep_thresh, float inv_keep, void* stream) {
  Walk a{};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.mask = (const uint8_t*)mask;
  a.bias = (const float*)bias;
  a.lse1 = (const float*)lse1;
  a.jlist = (const int*)jlist;
  a.jcount = (const int*)jcount;
  a.scale = (const float*)scale;
  a.seeds = (const int*)seeds;
  a.out = (float*)out;
  a.lse = (float*)lse2;
  a.H = H; a.N = N; a.D = D; a.Dv = Dv; a.n_i = n_i; a.W = W;
  a.metric = metric; a.sqrt_d = sqrt_d; a.use_dropout = use_dropout;
  a.keep_thresh = keep_thresh; a.inv_keep = inv_keep;
  return launch<BIASED, true>(a, G, stream);
}

// B4's bf16 form: lse1 [G, H, N] of the forward walk over the dense int8
// mask [G, N, N].
extern "C" int tagan_flash_lse1_bf16(const void* q, const void* k,
                                     const void* mask, const void* jlist,
                                     const void* jcount, const void* scale,
                                     void* lse1, int G, int H, int N, int D,
                                     int n_i, int W, int metric, float sqrt_d,
                                     void* stream) {
  Walk a{};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.mask = (const uint8_t*)mask;
  a.jlist = (const int*)jlist;
  a.jcount = (const int*)jcount;
  a.scale = (const float*)scale;
  a.lse = (float*)lse1;
  a.H = H; a.N = N; a.D = D; a.Dv = 0; a.n_i = n_i; a.W = W;
  a.metric = metric; a.sqrt_d = sqrt_d;
  a.inv_keep = 1.f;
  return launch<LSE, true>(a, G, stream);
}
