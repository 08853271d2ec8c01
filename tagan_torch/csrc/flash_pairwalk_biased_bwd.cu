// Edge-biased geometric attention, backward, as two mask-driven pair walks,
// for Hopper (sm_90a): a row walk and a key walk.
//
// Replaces the Pallas TPU kernels of tagan_tpu/ops/pallas/flash_geometric.py
// that differentiate the dense path's double softmax, in their dense-mask
// forms bf16=False and bf16=True (the template flag kBf16; host side
// flash_biased_attention_bwd):
//
//   row walk  B6   _biased_bwd_pre_kernel  delta1_i = sum_j w1 dw1,
//                                          dB_ij = sum_h dz
//             B7a  _biased_bwd_dq_kernel   dq_i, and d(scale)
//   key walk  B7b  _biased_bwd_dkv_kernel  dk_j, dv_j
//
// Per valid pair (i, j) and head h they recompute what the forward (B4, B5:
// flash_pairwalk_fwd.cu) formed, as _bwd_biased_common does:
//
//   s   = the metric score of q_i and k_j,  w1 = exp(s - lse1_i),
//   z   = drop1(w1) + B_ij,                 w2 = exp(z - lse2_i),
//   dp2 = drop2(do_i . v_j),
//   dz  = w2 (dp2 - delta2_i),              dw1 = drop1(dz),
//   ds  = w1 (dw1 - delta1_i),              W = the chain weight of ds,
//   dq_i += W k_j,  dk_j += W q_i,          dv_j += drop2(w2) do_i,
//
// and the squared-distance metrics subtract the row and column sums of W
// times the unrounded q_i and k_j; d(scale) sums ds s sq.
//  - fp32 (bf16=False): every operand unrounded, W = chain_weight (the
//    scaled dot's 1/sqrt(d) inside it), no TF32. The CPU's fp32 function
//    (flash_biased_backward_plain) up to the order of the sums.
//  - bf16 (bf16=True), at the rounding points of the plain bf16 version
//    (flash_biased_backward_plain(..., bf16=True)): q and k rounded to bf16
//    after their fp32 norms, do and v rounded, W = chain_weight_bf16 and
//    drop2(w2) rounded as operands of their products; the scaled dot
//    divides the dq and dk sums by sqrt(d) (chain_finish).
// In both, w1, z, w2, dz, delta1, dB, ds and the sums of W are fp32. The
// dropouts are the coordinate hash (keep_hash) with seeds[g, 0] and
// seeds[g, 1]. A dropped w1 is not a masked pair: z = B there, so dz and dB
// are set while dw1 = 0. Both softmaxes are normalised by the forward's
// lse1 and lse2, so no walk order enters the pairs' values; only the order
// of the sums does, and it is fixed: neither kernel has an atomic, and
// repeated calls are bit-identical.
//
// The row walk (B6 and B7a). B2's walk (flash_pairwalk_bwd.cu) over the
// forward plan (jlist, jcount): one warp is one block, R rows of one 64-row
// query tile for a group of HG heads, each lane one (row, head) item whose
// q_i and do_i (rounded in bf16) and dq_i accumulator stay in its shared
// slots. The mask is read once for all the group's heads and each row's
// valid columns are listed (`walk_mask`, flash_pairwalk.cuh).
//  Pass 1 (B6) at every listed pair: w1, w2, dz and dw1 from k_j, v_j and
//   the bias at (i, j), gathered at the valid pairs only (contiguous in row
//   i); delta1 += w1 dw1 in the lane; dB_ij = the row's HG lanes' dz summed
//   in head order by shuffles, stored once by the row's first lane.
//  Pass 2 (B7a), once delta1 is whole: the same recompute, then ds, W,
//   dq_i += W k_j and the d(scale) term.
//  When no list of the warp overflowed (CAPR entries a row), the lists are
//  still in shared memory after pass 1 and pass 2 walks them; otherwise the
//  warp walks its mask tiles again (the re-read comes from L2 where it
//  still holds them). d(scale) is written per item, [G, H, N], for torch to
//  sum in a fixed order. Past 32 heads the entry point launches the walk
//  once per group of 32 heads, in order on the stream, each group adding its
//  heads' dz into dB: still no atomic.
//
// The key walk (B7b), over the transposed plan (ilist, icount): one block
// owns KB keys (all 64 at head dim 16) of one 64-key tile of one snapshot
// for a group of HG heads (up to 8), each lane one (key, head) item whose
// k_j and v_j (rounded in bf16) and dk_j and dv_j accumulators stay in its
// shared slots; a warp holds R keys.
//  1. Each walked [64 rows x 64 keys] mask tile is copied whole, 64-byte row
//     segments (the sectors the row walk reads), by cp.async into an
//     NST-stage ring, NST - 1 steps ahead, one block barrier a step
//     (6 stages measured the same as 4 on the H100).
//  2. Each warp turns its R columns of the tile into a 64-bit row word a
//     key (two ballots a key: rows 0-31 and 32-63) and appends the key's
//     valid rows, ascending, to its list in shared memory, one step later.
//  3. When a key's list could overflow (the block votes at the step's
//     barrier, so that all warps flush together: a warp flushing alone
//     held the others at the next barrier), and at the end, the warp
//     flushes: its lanes step through their keys' lists together,
//     gathering q_i,
//     do_i, lse1_i, lse2_i, delta2_i, delta1_i (the row walk's) and the bias
//     at (i, j) (one sector a valid pair), recompute w1, w2, dz, dw1, ds
//     and W, and add into dk_j and dv_j in ascending row order.
//  dk_j and dv_j are written once at the end, with the squared-distance
//  column term (and, in bf16, the scaled dot's 1/sqrt(d)).
//
// Why the whole tile and not the R-byte pieces of each warp's keys (which
// flash_pairwalk_bwd.cu rejected for B2 at ~4x the mask's sectors): the
// block's warps share one copy of the tile, so each 64-byte row segment is
// read once. pairwalk_variants.py times the pieces (`KEY_PIECES`) against
// the whole tile.
//
// What bounds them on the H100. Each snapshot's int8 mask is N^2 bytes (100
// MB at N = 10,000), read once by each walk; q, k, v, do, the row
// statistics, the bias and dB at the valid pairs and the outputs are small
// beside it. So the least time of each is the mask's bytes over the memory
// rate, and the pairs' work (~2 to 3 products of head dim a pair and head)
// is far below the fp32 rate at the model's density.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the last launch.

#include "flash_pairwalk.cuh"

namespace {

using namespace tagan_pairwalk;

// the flushes: false leaves each walk streaming and listing the mask alone
// (pairwalk_variants.py; its outputs are then not the function)
constexpr bool ROW_FLUSH = true;
constexpr bool KEY_FLUSH = true;
// the key walk's mask read: false copies each walked tile whole, true each
// warp's R-byte column pieces of its 64 rows (pairwalk_variants.py)
constexpr bool KEY_PIECES = false;

constexpr int KROW = BN + 16;     // key walk ring row stride: 16-byte aligned,
                                  // and a warp's column reads spread banks
constexpr int KEY_WARPS = 16;     // warps of a key walk block, at most
constexpr int KEY_HG = 8;         // heads of a key walk block, at most
constexpr size_t MAX_SMEM = 227 * 1024;

// Both walks' arguments.
struct Bwd {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;
  const float* bias;
  const float* dout;
  const float* lse1;
  const float* lse2;
  const float* delta2;
  const float* delta1;    // key walk: the row walk's output
  const int* plan;        // row walk: jlist; key walk: ilist
  const int* pcount;
  const float* scale;
  const int* seeds;
  float* delta1_out;
  float* dbias;
  float* dq;
  float* dscale;          // [G, H, N]: each item's d(scale) term
  float* dk;
  float* dv;
  int H, N, D, Dv, n_t, W, HG, R, metric;
  float sqrt_d;
  int use_dropout;
  uint32_t keep_thresh;
  float inv_keep;
  int need_dscale;
  int hg;                 // row walk: this launch's head group
  int KB, n_kb, n_hg;     // key walk: keys a block, blocks a key tile, groups
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

// ---------------------------------------------------------------------------
// The row walk
// ---------------------------------------------------------------------------

// Bytes of one warp's (one block's) shared memory: the walk's, then q and
// do (rounded in bf16) and the dq accumulator, each [width][32 lanes].
__host__ __device__ inline size_t row_bytes(int R, int D, int Dv) {
  return walk_bytes(R) + (size_t)WARP * (2 * D + Dv) * 4;
}

// One lane's (row, head) item.
struct RowItem {
  bool on;
  int gr, base;          // base: the row's first lane
  size_t gh;             // g * H + h
  float qn, sc, lse1, lse2, delta2, d1, wsum, dsc;
  uint32_t mix1, mix2;
  const float* qs;       // q_s + lane, stride 32
  const float* dos;      // do_s + lane, stride 32
  float* dq;             // dq_s + lane, stride 32
  const float* brow;     // bias row g, i
  float* dbrow;          // dB row g, i
};

// One pass over a row list of n entries, every lane in step (to the
// longest list): kPass 1 sums delta1 and stores dB, kPass 2 adds dq.
template <int kPass, bool kBf16>
__device__ __forceinline__ void row_pass(const Bwd& a, RowItem& it,
                                         const int* list, int n, int HG) {
  const bool k4 = (a.D & 3) == 0 && aligned16(a.k);
  const bool v4 = (a.Dv & 3) == 0 && aligned16(a.v);
  const float* kg = a.k + it.gh * a.N * a.D;
  const float* vg = a.v + it.gh * a.N * a.Dv;
  const int nmax = __reduce_max_sync(FULL, n);
  for (int e = 0; e < nmax; ++e) {
    const bool on = e < n;
    const int gc = on ? list[e] : 0;
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
      const Pair p = recompute(a, qk, it.qn, kn, dp, __ldg(it.brow + gc),
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
      if (on && (int)(threadIdx.x) == it.base)
        it.dbrow[gc] = a.hg ? it.dbrow[gc] + sum : sum;
    } else if (on) {
      // dq_i += W k_j (bf16: rounded): the k row again, now in L1
      for (int d = 0; d < a.D; ++d)
        it.dq[d * WARP] = fmaf(wq, rd<kBf16>(__ldg(kr + d)), it.dq[d * WARP]);
    }
  }
}

template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(WARP) row_walk_kernel(const Bwd a) {
  const int lane = threadIdx.x;
  const int R = a.R, HG = a.HG;
  const int sub = (int)blockIdx.x, g = (int)blockIdx.y;
  const int ib = sub / (BM / R), row0 = sub * R;

  extern __shared__ __align__(16) uint8_t smem[];
  const WalkSmem sm = walk_smem(smem, R);
  float* q_s = reinterpret_cast<float*>(sm.rest);
  float* do_s = q_s + WARP * a.D;
  float* dq_s = do_s + WARP * a.Dv;

  RowItem it;
  const int rl = lane / HG, h = a.hg * HG + lane % HG;
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
  const size_t brow = ((size_t)g * a.N + (it.on ? it.gr : 0)) * a.N;
  it.brow = a.bias + brow;
  it.dbrow = a.dbias + brow;
  const size_t row = it.gh * a.N + it.gr;
  if (it.on) {
    const float* qr = a.q + row * a.D;
    for (int d = 0; d < a.D; ++d) {   // the norm, then the row (bf16: rounded)
      const float x = qr[d];
      it.qn += x * x;
      q_s[d * WARP + lane] = rd<kBf16>(x);
      dq_s[d * WARP + lane] = 0.f;
    }
    const float* dor = a.dout + row * a.Dv;
    for (int c = 0; c < a.Dv; ++c) do_s[c * WARP + lane] = rd<kBf16>(dor[c]);
    it.lse1 = a.lse1[row];
    it.lse2 = a.lse2[row];
    it.delta2 = a.delta2[row];
    it.sc = a.scale[h];
    const uint32_t hmix = (uint32_t)h * 0xC2B2AE3Du;
    it.mix1 = (uint32_t)a.seeds[2 * g] ^ hmix;
    it.mix2 = (uint32_t)a.seeds[2 * g + 1] ^ hmix;
  }

  const int cnt = a.pcount[(size_t)g * a.n_t + ib];
  const int* jl = a.plan + ((size_t)g * a.n_t + ib) * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  const int* list = sm.lists + (rl < R ? rl : 0) * CAPR;
  int flushes = 0;
  walk_mask<kVec16>(sm, mg, a.N, row0, R, jl, cnt, lane, [&]() {
    ++flushes;
    if constexpr (ROW_FLUSH)
      row_pass<1, kBf16>(a, it, list, it.on ? sm.rowcnt[rl] : 0, HG);
  });
  if (flushes == 1) {   // every list whole in shared memory: pass 2 there
    if constexpr (ROW_FLUSH)
      row_pass<2, kBf16>(a, it, list, it.on ? sm.rowcnt[rl] : 0, HG);
  } else {
    walk_mask<kVec16>(sm, mg, a.N, row0, R, jl, cnt, lane, [&]() {
      if constexpr (ROW_FLUSH)
        row_pass<2, kBf16>(a, it, list, it.on ? sm.rowcnt[rl] : 0, HG);
    });
  }

  if (it.on) {   // dead rows: no pair, delta1 = dq = 0
    a.delta1_out[row] = it.d1;
    const bool sqm = is_sq_metric(a.metric);
    const float* qr = a.q + row * a.D;
    float* og = a.dq + row * a.D;
    for (int d = 0; d < a.D; ++d) {
      const float x = dq_s[d * WARP + lane];
      og[d] = sqm ? x - it.wsum * qr[d]
                  : chain_finish<kBf16>(a.metric, x, a.sqrt_d);
    }
    if (a.need_dscale)
      a.dscale[row] = it.dsc * dscale_factor(a.metric, it.sc);
  }
}

// ---------------------------------------------------------------------------
// The key walk
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t key_walk_bytes(int KB) {
  return (size_t)NST * BM * KROW + (size_t)KB * CAPR * 4;
}

// Bytes of one block: the ring and the keys' lists, then k and v (rounded
// in bf16) and the dk and dv accumulators, each [width][threads].
__host__ __device__ inline size_t key_bytes(int KB, int R, int D, int Dv) {
  return key_walk_bytes(KB) + (size_t)(KB / R) * WARP * (2 * D + 2 * Dv) * 4;
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

// Step t's mask tile, rows [row0, row0 + 64) x keys [col0, col0 + 64), into
// `stage` (row stride KROW): the whole tile by all threads in 16-byte
// chunks, or (KEY_PIECES) each warp its keys' R-byte pieces of the 64 rows
// in 4-byte words. Rows and columns past N read as 0.
template <bool kVec16>
__device__ __forceinline__ void load_tile(uint8_t* stage, const uint8_t* mg,
                                          int N, int row0, int col0, int kc0,
                                          int R) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  if constexpr (KEY_PIECES) {
    const int lane = tid & (WARP - 1);
    const int wpr = R >= 4 ? R / 4 : 1;     // words a row piece
    for (int c = lane; c < BM * wpr; c += WARP) {
      const int r = c / wpr, off = kc0 + 4 * (c - r * wpr);
      const int gr = row0 + r, gcol = col0 + off;
      uint8_t* dst = stage + r * KROW + off;
      if (kVec16 && R >= 4) {
        const bool ok = gr < N && gcol < N;  // N % 16 == 0: all 4 or none
        const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                     "l"(ok ? mg + (size_t)gr * N + gcol : mg),
                     "r"(ok ? 4 : 0)
                     : "memory");
      } else {
        for (int b = 0; b < (R >= 4 ? 4 : R); ++b)
          dst[b] = gr < N && gcol + b < N
                       ? (uint8_t)(mg[(size_t)gr * N + gcol + b] != 0) : 0;
      }
    }
  } else {
    for (int c = tid; c < BM * 4; c += nthr) {
      const int r = c >> 2, off = 16 * (c & 3);
      const int gr = row0 + r, gcol = col0 + off;
      uint8_t* dst = stage + r * KROW + off;
      if constexpr (kVec16) {
        const bool ok = gr < N && gcol < N;  // N % 16 == 0: all 16 or none
        cp_async16(dst, ok ? mg + (size_t)gr * N + gcol : mg, ok);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (gr < N) {
          const uint8_t* src = mg + (size_t)gr * N;
          for (int b = 0; b < 16 && gcol + b < N; ++b)
            if (src[gcol + b]) w[b >> 2] |= 0xffu << (8 * (b & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

__device__ __forceinline__ void cp_async_wait_key() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2) : "memory");
}

// The flush of a key list of n rows (ascending), every lane of the warp in
// step (to the longest list): dk_j and dv_j in the lane's slots.
template <bool kBf16>
__device__ __forceinline__ void key_pass(const Bwd& a, KeyItem& it, int g,
                                         const int* list, int n, int nthr) {
  const bool q4 = (a.D & 3) == 0 && aligned16(a.q);
  const bool o4 = (a.Dv & 3) == 0 && aligned16(a.dout);
  const int nmax = __reduce_max_sync(FULL, n);
  for (int e = 0; e < nmax; ++e) {
    if (!(it.on && e < n)) continue;
    const int gr = list[e];
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
    const float b = __ldg(a.bias + ((size_t)g * a.N + gr) * a.N + it.gc);
    const Pair p = recompute(a, qk, qn, it.kn, dp, b, __ldg(a.lse1 + row),
                             __ldg(a.lse2 + row), __ldg(a.delta2 + row),
                             it.sc, it.mix1, it.mix2, (uint32_t)gr,
                             (uint32_t)it.gc);
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

template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(KEY_WARPS * WARP, 1)
key_walk_kernel(const Bwd a) {
  const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;
  const int nthr = blockDim.x;
  const int R = a.R, HG = a.HG;
  // head groups innermost, then the key blocks of one tile: the blocks
  // that read one mask tile run together
  const int hg = (int)(blockIdx.x % a.n_hg);
  const int rest = (int)(blockIdx.x / a.n_hg);
  const int kb = rest % a.n_kb, jb = rest / a.n_kb;
  const int g = (int)blockIdx.y;
  const int col0 = jb * BN;
  const int kc0 = kb * a.KB + warp * R;   // the warp's first key in the tile

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  int* lists = reinterpret_cast<int*>(smem + (size_t)NST * BM * KROW);
  float* k_s = reinterpret_cast<float*>(smem + key_walk_bytes(a.KB));
  float* v_s = k_s + (size_t)nthr * a.D;
  float* dk_s = v_s + (size_t)nthr * a.Dv;
  float* dv_s = dk_s + (size_t)nthr * a.D;

  KeyItem it;
  const int kl = lane / HG, h = hg * HG + lane % HG;
  it.gc = col0 + kc0 + kl;
  it.on = lane < R * HG && h < a.H && it.gc < a.N;
  it.gh = (size_t)g * a.H + (it.on ? h : 0);
  it.ks = k_s + tid;
  it.vs = v_s + tid;
  it.dk = dk_s + tid;
  it.dv = dv_s + tid;
  it.kn = it.wsum = 0.f;
  it.sc = 1.f;
  it.mix1 = it.mix2 = 0u;
  const size_t key = it.gh * a.N + it.gc;
  if (it.on) {
    const float* kr = a.k + key * a.D;
    for (int d = 0; d < a.D; ++d) {   // the norm, then the row (bf16: rounded)
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
    it.mix1 = (uint32_t)a.seeds[2 * g] ^ hmix;
    it.mix2 = (uint32_t)a.seeds[2 * g + 1] ^ hmix;
  }

  const size_t walk = (size_t)g * a.n_t + jb;
  const int cnt = a.pcount[walk];
  const int* il = a.plan + walk * a.W;
  const uint8_t* mg = a.mask + (size_t)g * a.N * a.N;
  const int stage_bytes = BM * KROW;
  int* list = lists + (warp * R + (kl < R ? kl : 0)) * CAPR;
  const bool writer = lane < R * HG && lane % HG == 0;
  int n = 0;                    // entries of the lane's key list
  // step t - 1's row word of the lane's key, appended at step t (after
  // the block's vote on a flush), and its popcount and first row
  uint64_t word = 0;
  int add = 0, row0 = 0;
  auto append = [&]() {
    if (writer && add) {
      int* dst = list + n;
      for (uint64_t w = word; w; w &= w - 1)
        *dst++ = row0 + __ffsll((long long)w) - 1;
    }
    n += add;
  };

  for (int s = 0; s < NST - 1; ++s) {
    if (s < cnt)
      load_tile<kVec16>(ring + s * stage_bytes, mg, a.N, il[s] * BM, col0,
                        kc0, R);
    cp_async_commit();
  }
  for (int t = 0; t < cnt; ++t) {
    cp_async_wait_key();        // this thread's copies of step t
    // everyone's copies of step t, everyone done with step t - 1's stage,
    // and the block's vote: could a list overflow with step t - 1's rows?
    // Then every warp flushes now, together, rather than one at a time
    // while the others wait at the next barrier
    const bool full = __syncthreads_or(n + add > CAPR);
    const int tt = t + NST - 1;   // into step t - 1's stage
    if (tt < cnt)
      load_tile<kVec16>(ring + (tt % NST) * stage_bytes, mg, a.N,
                        il[tt] * BM, col0, kc0, R);
    cp_async_commit();
    if (full) {
      if constexpr (KEY_FLUSH) key_pass<kBf16>(a, it, g, list, n, nthr);
      __syncwarp();
      n = 0;
    }
    append();
    const uint8_t* stage = ring + (t % NST) * stage_bytes + kc0;
    // the row word of each of the warp's R keys: bit r for row r
    word = 0;
    for (int c = 0; c < R; ++c) {
      const unsigned lo = __ballot_sync(FULL, stage[lane * KROW + c] != 0);
      const unsigned hi =
          __ballot_sync(FULL, stage[(lane + WARP) * KROW + c] != 0);
      if (c == kl) word = (uint64_t)lo | ((uint64_t)hi << 32);
    }
    add = kl < R ? __popcll(word) : 0;
    row0 = il[t] * BM;
  }
  if (__any_sync(FULL, n + add > CAPR)) {
    __syncwarp();
    if constexpr (KEY_FLUSH) key_pass<kBf16>(a, it, g, list, n, nthr);
    __syncwarp();
    n = 0;
  }
  append();
  __syncwarp();
  if constexpr (KEY_FLUSH) key_pass<kBf16>(a, it, g, list, n, nthr);

  if (it.on) {   // keys no row reaches: no pair, dk = dv = 0
    const bool sqm = is_sq_metric(a.metric);
    const float* kr = a.k + key * a.D;
    float* ok = a.dk + key * a.D;
    for (int d = 0; d < a.D; ++d) {
      const float x = dk_s[d * nthr + tid];
      ok[d] = sqm ? x - it.wsum * kr[d]
                  : chain_finish<kBf16>(a.metric, x, a.sqrt_d);
    }
    float* ov = a.dv + key * a.Dv;
    for (int c = 0; c < a.Dv; ++c) ov[c] = dv_s[c * nthr + tid];
  }
}

bool bad_args(const Bwd& a, int G) {
  return G < 0 || a.H < 0 || a.N < 0 || a.D < 1 || a.D > MAX_D ||
         a.Dv < 1 || a.Dv > MAX_D || a.metric < 0 || a.metric > COS_DIST ||
         a.n_t != (a.N + BM - 1) / BM || a.W < 0;
}

bool vec16_mask(const Bwd& a) {
  return a.N % 16 == 0 && (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool kBf16>
int launch_rows(Bwd a, int G, void* stream) {
  if (bad_args(a, G)) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  warp_items(a.H, &a.HG, &a.R);
  const int n_hg = (a.H + a.HG - 1) / a.HG;
  const size_t smem = row_bytes(a.R, a.D, a.Dv);
  const auto kern = vec16_mask(a) ? row_walk_kernel<kBf16, true>
                                  : row_walk_kernel<kBf16, false>;
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

template <bool kBf16>
int launch_keys(Bwd a, int G, void* stream) {
  if (bad_args(a, G)) return (int)cudaErrorInvalidValue;
  if (G == 0 || a.H == 0 || a.N == 0) return 0;
  a.HG = a.H < KEY_HG ? a.H : KEY_HG;
  a.R = 1;
  while (a.R * 2 * a.HG <= WARP) a.R *= 2;
  a.KB = BN < KEY_WARPS * a.R ? BN : KEY_WARPS * a.R;
  while (a.KB > a.R && key_bytes(a.KB, a.R, a.D, a.Dv) > MAX_SMEM) a.KB /= 2;
  const size_t smem = key_bytes(a.KB, a.R, a.D, a.Dv);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  a.n_kb = BN / a.KB;
  a.n_hg = (a.H + a.HG - 1) / a.HG;
  const auto kern = vec16_mask(a) ? key_walk_kernel<kBf16, true>
                                  : key_walk_kernel<kBf16, false>;
  const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.n_t * a.n_kb * a.n_hg), G);
  kern<<<grid, (a.KB / a.R) * WARP, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

Bwd common_args(const void* q, const void* k, const void* v,
                const void* mask, const void* bias, const void* dout,
                const void* lse1, const void* lse2, const void* delta2,
                const void* plan, const void* pcount, const void* scale,
                const void* seeds, int H, int N, int D, int Dv, int n_t,
                int W, int metric, float sqrt_d, int use_dropout,
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

template <bool kBf16>
int row_entry(const void* q, const void* k, const void* v, const void* mask,
              const void* bias, const void* dout, const void* lse1,
              const void* lse2, const void* delta2, const void* jlist,
              const void* jcount, const void* scale, const void* seeds,
              void* delta1, void* dbias, void* dq, void* dscale_part, int G,
              int H, int N, int D, int Dv, int n_i, int W, int metric,
              float sqrt_d, int use_dropout, unsigned int keep_thresh,
              float inv_keep, int need_dscale, void* stream) {
  Bwd a = common_args(q, k, v, mask, bias, dout, lse1, lse2, delta2, jlist,
                      jcount, scale, seeds, H, N, D, Dv, n_i, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1_out = (float*)delta1;
  a.dbias = (float*)dbias;
  a.dq = (float*)dq;
  a.dscale = (float*)dscale_part;
  a.need_dscale = need_dscale;
  return launch_rows<kBf16>(a, G, stream);
}

template <bool kBf16>
int key_entry(const void* q, const void* k, const void* v, const void* mask,
              const void* bias, const void* dout, const void* lse1,
              const void* lse2, const void* delta2, const void* delta1,
              const void* ilist, const void* icount, const void* scale,
              const void* seeds, void* dk, void* dv, int G, int H, int N,
              int D, int Dv, int n_j, int W, int metric, float sqrt_d,
              int use_dropout, unsigned int keep_thresh, float inv_keep,
              void* stream) {
  Bwd a = common_args(q, k, v, mask, bias, dout, lse1, lse2, delta2, ilist,
                      icount, scale, seeds, H, N, D, Dv, n_j, W, metric,
                      sqrt_d, use_dropout, keep_thresh, inv_keep);
  a.delta1 = (const float*)delta1;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  return launch_keys<kBf16>(a, G, stream);
}

}  // namespace

// The row walk, B6 and B7a: delta1 [G, H, N], dB [G, N, N] (written at the
// mask's valid pairs only), dq [G, H, N, D] and, with need_dscale, each
// item's d(scale) term [G, H, N], over the forward walk (jlist, jcount
// [G, n_i, W], [G, n_i]) of the dense int8 mask [G, N, N], given lse1, lse2
// and delta2 [G, H, N], the head-shared bias [G, N, N] and two seeds per g,
// [G, 2].
extern "C" int tagan_flash_biased_bwd_row(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* jlist, const void* jcount,
    const void* scale, const void* seeds, void* delta1, void* dbias,
    void* dq, void* dscale_part, int G, int H, int N, int D, int Dv,
    int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, int need_dscale,
    void* stream) {
  return row_entry<false>(q, k, v, mask, bias, dout, lse1, lse2, delta2,
                          jlist, jcount, scale, seeds, delta1, dbias, dq,
                          dscale_part, G, H, N, D, Dv, n_i, W, metric, sqrt_d,
                          use_dropout, keep_thresh, inv_keep, need_dscale,
                          stream);
}

// The row walk's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_bwd_row_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* jlist, const void* jcount,
    const void* scale, const void* seeds, void* delta1, void* dbias,
    void* dq, void* dscale_part, int G, int H, int N, int D, int Dv,
    int n_i, int W, int metric, float sqrt_d, int use_dropout,
    unsigned int keep_thresh, float inv_keep, int need_dscale,
    void* stream) {
  return row_entry<true>(q, k, v, mask, bias, dout, lse1, lse2, delta2,
                         jlist, jcount, scale, seeds, delta1, dbias, dq,
                         dscale_part, G, H, N, D, Dv, n_i, W, metric, sqrt_d,
                         use_dropout, keep_thresh, inv_keep, need_dscale,
                         stream);
}

// The key walk, B7b: dk [G, H, N, D] and dv [G, H, N, Dv] over the
// transposed walk (ilist, icount [G, n_j, W], [G, n_j]), given the row
// walk's delta1.
extern "C" int tagan_flash_biased_bwd_key(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* ilist,
    const void* icount, const void* scale, const void* seeds, void* dk,
    void* dv, int G, int H, int N, int D, int Dv, int n_j, int W, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return key_entry<false>(q, k, v, mask, bias, dout, lse1, lse2, delta2,
                          delta1, ilist, icount, scale, seeds, dk, dv, G, H,
                          N, D, Dv, n_j, W, metric, sqrt_d, use_dropout,
                          keep_thresh, inv_keep, stream);
}

// The key walk's bf16 form: the same arguments.
extern "C" int tagan_flash_biased_bwd_key_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* dout, const void* lse1, const void* lse2,
    const void* delta2, const void* delta1, const void* ilist,
    const void* icount, const void* scale, const void* seeds, void* dk,
    void* dv, int G, int H, int N, int D, int Dv, int n_j, int W, int metric,
    float sqrt_d, int use_dropout, unsigned int keep_thresh, float inv_keep,
    void* stream) {
  return key_entry<true>(q, k, v, mask, bias, dout, lse1, lse2, delta2,
                         delta1, ilist, icount, scale, seeds, dk, dv, G, H, N,
                         D, Dv, n_j, W, metric, sqrt_d, use_dropout,
                         keep_thresh, inv_keep, stream);
}
