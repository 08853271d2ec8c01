// Edge-masked geometric attention forwards in bf16, as mask-driven pair
// walks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// in their dense-mask bf16 form (bf16=True):
//
//   B1 bf16  _flash_kernel         (host side _flash_forward)
//   B5 bf16  _flash_biased_kernel  (host side _flash_biased_forward)
//
// They compute what flash_geometric_fwd.cu (B1) and flash_biased_fwd.cu
// (B5) compute for bf16=True, over the same walk: for each query row i and
// head h, the key tiles jlist[g, tile, :jcount[g, tile]] in that order, an
// online softmax whose running max is updated once per 64-key tile, q.k
// from q and k rounded to bf16 after their fp32 norms, drop(p) rounded to
// bf16 relative to that running max and multiplied by v rounded to bf16,
// fp32 sums, the un-dropped denominator, the coordinate-hash dropout
// (keep_hash; B5's two seeds), out = 0 and lse = 1e30 on rows with no
// valid key. B5 takes lse1 as an input, forms z = drop1(exp(s - lse1)) +
// bias[g, i, j] on valid pairs only (a dropped w1 enters as z = bias), and
// runs the same online softmax over z.
//
// What bounds it on the H100. Each snapshot's int8 mask is N^2 bytes (100
// MB at N = 10,000), more than the 50 MB L2, and the function needs it read
// once; q, k, v, out (and B5's bias at the valid pairs) are small beside it.
// So the least time is the mask's bytes over the memory rate. The dense
// template walks every pair of every walked 64 x 64 tile in fp32 on the
// CUDA cores, once per head, and reads the mask once per head: at 16 edges
// a row over 10,000 nodes each tile holds ~6.5 valid pairs of its 4,096.
//
// Design. One warp is one block and one unit of work: R rows of one
// 64-row query tile of one folded snapshot g, for a group of HG heads
// (all H where H <= 32), R * HG <= 32, each lane one (row, head) item. No
// block barrier is taken. (Blocks of 4 independent warps measured up to
// 10% slower: shared memory is then granted 4 warps at a time.)
//  1. The mask is read once for all the group's heads: each walked tile's
//     R x 64 bytes are 16-byte chunks, one or more per lane, copied by
//     cp.async (16 bytes where N % 16 == 0 and the mask is 16-byte aligned,
//     else byte loads) into a 4-stage ring, 3 jlist steps ahead. A lane
//     reads back only the chunks it copied, so the ring needs no barrier.
//  2. A chunk becomes 16 bits (one per byte); a tile whose chunks are all
//     0 costs nothing more. Otherwise the popcounts and a prefix over each
//     row's 4 lanes append the tile's valid columns to the row's list in
//     shared memory (ascending, CAPR entries a row).
//  3. When a row's list could overflow, and at the end, the warp flushes,
//     computing only the valid pairs, in three passes (`flush`): the
//     scores of all listed pairs (q.k over D from q in shared memory,
//     rounded once, and k gathered from global memory: one snapshot's K
//     and V stay in L2; score_of; for B5 w1, drop1 and the bias at that
//     pair), then the online softmax tile by tile in shared memory, then
//     drop(p) v into the row's accumulator. The gathering passes step
//     through the entries together across the warp, 2 entries a lane at
//     a time, so that the gathers of all lanes are in flight at once: a
//     lane walking its own list alone left the warp's rows to diverge and
//     their gathers to follow one another. Rows with no pair in a tile are
//     not touched, which is exact (m unchanged, alpha = 1), so the dense
//     template's "p = 1 garbage" before a row's first valid key does not
//     arise.
//  4. Units are sub-tiles of R rows (8 at H = 4), so one 10K snapshot
//     gives 1,250 warps: every SM is busy at G = 1 as at G = 16.
//
// What it does not do yet: tensor cores for dense tiles. A tile whose rows
// hold many pairs is walked pair by pair on the CUDA cores, each pair's k
// and v rows gathered for each of its heads; it is correct at any density
// and its speed there is recorded, not targeted. An mma.sync m16n8k16 path
// with P in registers for dense tiles is later work.
//
// Interface: plain C, loaded with ctypes; the same entry points and
// arguments as the dense template's bf16 forms had. Launches on the given
// stream, allocates nothing, returns the cudaError_t of the launch.

#include "flash_geometric_common.cuh"

namespace {

using namespace tagan_flash;

constexpr int WARP = 32;
constexpr int NST = 4;            // mask ring stages: 3 walk steps ahead
constexpr int CAPR = 64;          // list entries a row between flushes
constexpr int UNROLL = 2;         // entries a lane gathers at once
constexpr int MAX_CPL = 4;        // 16-byte mask chunks a lane and step
constexpr unsigned FULL = 0xffffffffu;

static_assert(CAPR >= BN, "a row's list holds at least one whole tile");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 1) : "memory");
}

// Bytes of one warp's (one block's) shared memory: the mask ring, the
// rows' lists and counts, and q (rounded), the accumulators and the
// flush's per-entry values, each [width][32 lanes].
__host__ __device__ inline size_t warp_bytes(int R, int D, int Dv) {
  return (size_t)NST * R * BN + (size_t)R * CAPR * 4 + WARP * 4 +
         (size_t)WARP * (D + Dv + CAPR) * 4;
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

// Step tt's chunks of this lane into ring stage `stage`: chunk c = lane +
// 32 i holds bytes [16 p, 16 p + 16) of the tile's row r (c = 4 r + p).
// Rows and columns past N read as 0.
template <bool kVec16>
__device__ __forceinline__ void load_chunks(uint8_t* stage,
                                            const uint8_t* mg, int N,
                                            int row0, int R, int col0,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < MAX_CPL; ++i) {
    const int c = lane + WARP * i;
    if (c >= R * 4) break;
    const int gr = row0 + (c >> 2), gc = col0 + 16 * (c & 3);
    uint8_t* dst = stage + c * 16;
    if constexpr (kVec16) {
      const bool ok = gr < N && gc < N;   // N % 16 == 0: all 16 or none
      cp_async16(dst, ok ? mg + (size_t)gr * N + gc : mg, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gr < N) {
        const uint8_t* src = mg + (size_t)gr * N;
        for (int b = 0; b < 16 && gc + b < N; ++b)
          if (src[gc + b]) w[b >> 2] |= 0xffu << (8 * (b & 3));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Bit b of the result: byte b of chunk c of the stage is nonzero.
__device__ __forceinline__ uint32_t chunk_bits(const uint8_t* stage, int c) {
  const uint4 w = *reinterpret_cast<const uint4*>(stage + c * 16);
  if ((w.x | w.y | w.z | w.w) == 0u) return 0u;
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  uint32_t bits = 0u;
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if ((ws[b >> 2] >> (8 * (b & 3))) & 0xffu) bits |= 1u << b;
  return bits;
}

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
// from rounded q and k (norms from the unrounded rows), and for B5
// drop1(exp(s - lse1)) + bias. The pairs' k rows are loaded together, so
// that their gathers are in flight at once.
template <bool kBiased>
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
        qk[u] = fmaf(q0, rd<true>(x[u].x), qk[u]);
        kn[u] += x[u].y * x[u].y;
        qk[u] = fmaf(q1, rd<true>(x[u].y), qk[u]);
        kn[u] += x[u].z * x[u].z;
        qk[u] = fmaf(q2, rd<true>(x[u].z), qk[u]);
        kn[u] += x[u].w * x[u].w;
        qk[u] = fmaf(q3, rd<true>(x[u].w), qk[u]);
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
        qk[u] = fmaf(qd, rd<true>(x[u]), qk[u]);
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
//     p rounded to bf16 relative to that m_new, as the dense walk rounds
//     it; zbuf takes that rounded p times exp(m_new - m_fin), m_fin =
//     max(m, mA) the max after the flush, which is the product of the
//     later tiles' alphas;
//  C. acc = acc exp(m_before - m_fin) + sum of zbuf's weights times v
//     rounded to bf16, in the entries' order.
template <bool kBiased>
__device__ __forceinline__ void flush(const Walk& a, Item& it,
                                      const int* list, int n, float* zbuf) {
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
    pair_z<kBiased>(a, it, gc, on, k4, z);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (on[u]) {
        zbuf[(j0 + u) * WARP] = z[u];
        mA = fmaxf(mA, z[u]);
      }
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
        zbuf[j * WARP] = rd<true>(p) * later;
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
          c0 = fmaf(w[u], rd<true>(y[u].x), c0);
          c1 = fmaf(w[u], rd<true>(y[u].y), c1);
          c2 = fmaf(w[u], rd<true>(y[u].z), c2);
          c3 = fmaf(w[u], rd<true>(y[u].w), c3);
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
        for (int u = 0; u < UNROLL; ++u) c = fmaf(w[u], rd<true>(y[u]), c);
        it.acc[x * WARP] = c;
      }
    }
  }
}

template <bool kBiased, bool kVec16>
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
  uint8_t* ring = smem;
  int* lists = reinterpret_cast<int*>(ring + (size_t)NST * R * BN);
  int* rowcnt = lists + R * CAPR;
  float* q_s = reinterpret_cast<float*>(rowcnt + WARP);
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
    for (int d = 0; d < a.D; ++d) {   // the norm, then the row rounded
      const float x = qr[d];
      it.qn += x * x;
      q_s[d * WARP + lane] = rd<true>(x);
    }
    for (int x = 0; x < a.Dv; ++x) acc_s[x * WARP + lane] = 0.f;
    it.sc = a.scale[h];
    const uint32_t hmix = (uint32_t)h * 0xC2B2AE3Du;
    if constexpr (kBiased) {
      it.l1 = a.lse1[it.gh * a.N + it.gr];
      it.mix1 = (uint32_t)a.seeds[2 * g] ^ hmix;
      it.mix2 = (uint32_t)a.seeds[2 * g + 1] ^ hmix;
    } else {
      it.mix1 = (uint32_t)a.seeds[g] ^ hmix;
    }
  }

  const int cnt = a.jcount[(size_t)g * a.n_i + ib];
  const int* jl = a.jlist + ((size_t)g * a.n_i + ib) * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  const int stage_bytes = R * BN;
  const int p = lane & 3;
  const int cpl = R >= 8 ? R / 8 : 1;   // chunks a lane (uniform)
  int rcount[MAX_CPL];   // entries of chunk i's row (its 4 lanes agree)
#pragma unroll
  for (int i = 0; i < MAX_CPL; ++i) rcount[i] = 0;

  auto do_flush = [&]() {
    if (p == 0) {
#pragma unroll
      for (int i = 0; i < MAX_CPL; ++i) {
        const int r = (lane >> 2) + 8 * i;
        if (r < R) rowcnt[r] = rcount[i];
      }
    }
    __syncwarp();
    flush<kBiased>(a, it, lists + rl * CAPR, it.on ? rowcnt[rl] : 0, zbuf);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MAX_CPL; ++i) rcount[i] = 0;
  };

  for (int s = 0; s < NST - 1; ++s) {
    if (s < cnt)
      load_chunks<kVec16>(ring + s * stage_bytes, mg, a.N, row0, R,
                          jl[s] * BN, lane);
    cp_async_commit();
  }
  for (int t = 0; t < cnt; ++t) {
    const int tt = t + NST - 1;
    if (tt < cnt)
      load_chunks<kVec16>(ring + (tt % NST) * stage_bytes, mg, a.N, row0, R,
                          jl[tt] * BN, lane);
    cp_async_commit();
    cp_async_wait_ring();
    const uint8_t* stage = ring + (t % NST) * stage_bytes;
    uint32_t bits[MAX_CPL];
    bool any = false;
#pragma unroll
    for (int i = 0; i < MAX_CPL; ++i) {
      if (i >= cpl) break;
      const int c = lane + WARP * i;
      bits[i] = c < R * 4 ? chunk_bits(stage, c) : 0u;
      any |= bits[i] != 0u;
    }
    if (!__any_sync(FULL, any)) continue;
    // each row's 4 chunks lie in 4 adjacent lanes: their prefix and total
    int excl[MAX_CPL], tot[MAX_CPL];
    bool over = false;
#pragma unroll
    for (int i = 0; i < MAX_CPL; ++i) {
      if (i >= cpl) break;
      const int n = __popc(bits[i]);
      int x = n;
      int y = __shfl_up_sync(FULL, x, 1, 4);
      if (p >= 1) x += y;
      y = __shfl_up_sync(FULL, x, 2, 4);
      if (p >= 2) x += y;
      excl[i] = x - n;
      tot[i] = __shfl_sync(FULL, x, 3, 4);
      over |= rcount[i] + tot[i] > CAPR;
    }
    if (__any_sync(FULL, over)) do_flush();
    const int col0 = jl[t] * BN;
#pragma unroll
    for (int i = 0; i < MAX_CPL; ++i) {
      if (i >= cpl) break;
      uint32_t b = bits[i];
      if (b) {
        const int c = lane + WARP * i;
        int* dst = lists + (c >> 2) * CAPR + rcount[i] + excl[i];
        const int base = col0 + 16 * (c & 3);
        while (b) {
          *dst++ = base + __ffs(b) - 1;
          b &= b - 1u;
        }
      }
      rcount[i] += tot[i];
    }
  }
  do_flush();

  if (it.on) {
    const bool dead = it.m <= NEG_INF;
    const float l = dead ? 1.f : it.l;
    float* og = a.out + (it.gh * a.N + it.gr) * a.Dv;
    for (int x = 0; x < a.Dv; ++x)
      og[x] = dead ? 0.f : acc_s[x * WARP + lane] / l;
    a.lse[it.gh * a.N + it.gr] = dead ? LSE_DEAD : it.m + logf(l);
  }
}

template <bool kBiased>
int launch(Walk a, int G, void* stream) {
  if (G < 0 || a.H < 0 || a.N < 0 || a.D < 1 || a.D > MAX_D || a.Dv < 1 ||
      a.Dv > MAX_D || a.metric < 0 || a.metric > COS_DIST ||
      a.n_i != (a.N + BM - 1) / BM || a.W < 0)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  a.HG = a.H < WARP ? a.H : WARP;
  a.R = 1;
  while (a.R * 2 * a.HG <= WARP) a.R *= 2;   // R <= 32 divides BM
  a.n_hg = (a.H + a.HG - 1) / a.HG;
  a.n_sub = a.n_i * (BM / a.R);
  const size_t smem = warp_bytes(a.R, a.D, a.Dv);
  const bool vec16 = a.N % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0;
  const auto kern = vec16 ? pairwalk_fwd_kernel<kBiased, true>
                          : pairwalk_fwd_kernel<kBiased, false>;
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
  return launch<false>(a, G, stream);
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
  return launch<true>(a, G, stream);
}
