// The mask walks shared by the dense pair walks. The row walk
// (`walk_mask`) serves flash_pairwalk_fwd.cu (B1, B4, B5 and their bf16
// forms), flash_pairwalk_bwd.cu (B2 and B2's bf16 form),
// flash_pairwalk_biased_bwd.cu (its row walk, B6 and B7a in both
// precisions), flash_pairwalk_two_walk.cu (B3a in both precisions) and
// ring_flash.cu (B9's fold over one hop's column block, in both
// precisions); the key walk (`walk_key_mask`, at the end) serves the key
// walks over the transposed plan, B7b's of flash_pairwalk_biased_bwd.cu
// and B3b's of flash_pairwalk_two_walk.cu, both in both precisions. The
// cp.async helpers also serve the compact walks of
// flash_pairwalk_slots.cuh, flash_pairwalk_fwd_compact.cu,
// flash_pairwalk_biased_bwd_compact.cu and flash_pairwalk_bwd_compact.cu.
//
// One warp walks R rows of one 64-row query tile of one snapshot's dense
// int8 mask [N, N] over the key tiles of its plan, jlist[g, tile, :cnt].
// Each walked tile's R x 64 bytes are 16-byte chunks, one or more per lane,
// copied by cp.async (16 bytes where N % 16 == 0 and the mask is 16-byte
// aligned, else byte loads) into an NST-stage ring, NST - 1 steps ahead. A
// lane reads back only the chunks it copied, so the ring needs no barrier.
// A chunk becomes 16 bits (one per byte); a tile whose chunks are all 0
// costs nothing more. Otherwise the popcounts and a prefix over each row's
// 4 lanes append the tile's valid columns to the row's list in shared
// memory (ascending, CAPR entries a row). When a row's list could overflow,
// and at the end, the walk calls the kernel's flush, which computes the
// listed pairs. The ring's fold walks a column window of a row slice of the
// mask instead (`ColumnWindow`): the walk then reads the tiles at absolute
// multiples of 64 columns and drops the bits outside the window.

#pragma once

#include "flash_geometric_common.cuh"

namespace tagan_pairwalk {

using namespace tagan_flash;

constexpr int WARP = 32;
constexpr int NST = 4;            // mask ring stages: 3 walk steps ahead
constexpr int CAPR = 64;          // list entries a row between flushes
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

// The key walks' wait: they commit step t + NST - 1's copies after their
// wait for step t's, so NST - 2 groups may still be in flight.
__device__ __forceinline__ void cp_async_wait_key() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2) : "memory");
}

// Step tt's chunks of this lane into ring stage `stage`: chunk c = lane +
// 32 i holds bytes [16 p, 16 p + 16) of the tile's row r (c = 4 r + p).
// The mask's rows are N bytes long; rows past `rows` and columns past N
// read as 0.
template <bool kVec16>
__device__ __forceinline__ void load_chunks(uint8_t* stage,
                                            const uint8_t* mg, int N,
                                            int rows, int row0, int R,
                                            int col0, int lane) {
#pragma unroll
  for (int i = 0; i < MAX_CPL; ++i) {
    const int c = lane + WARP * i;
    if (c >= R * 4) break;
    const int gr = row0 + (c >> 2), gc = col0 + 16 * (c & 3);
    uint8_t* dst = stage + c * 16;
    if constexpr (kVec16) {
      const bool ok = gr < rows && gc < N;   // N % 16 == 0: 16 or none
      cp_async16(dst, ok ? mg + (size_t)gr * N + gc : mg, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gr < rows) {
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

// The columns a walk lists: every column of its N x N mask (the dense
// walks), or those of a column window of a row slice (B9's hop).
struct WholeMask {
  __device__ __forceinline__ int rows(int N) const { return N; }
  __device__ __forceinline__ uint32_t keep(uint32_t bits, int) const {
    return bits;
  }
};

// Rows [0, n_rows) of a mask slice whose rows are N bytes long, columns
// [lo, hi).
struct ColumnWindow {
  int n_rows, lo, hi;
  __device__ __forceinline__ int rows(int) const { return n_rows; }
  // bit b of a chunk's bits stands for column base + b
  __device__ __forceinline__ uint32_t keep(uint32_t bits, int base) const {
    const int a = max(lo - base, 0), b = min(hi - base, 16);
    return a < b ? bits & ((1u << b) - 1u) & ~((1u << a) - 1u) : 0u;
  }
};

// A warp's shared memory begins with the walk's: the mask ring, the rows'
// lists and their counts; the kernel's own part follows, 16-byte aligned.
struct WalkSmem {
  uint8_t* ring;    // [NST][R][BN]
  int* lists;       // [R][CAPR]
  int* rowcnt;      // [WARP]: entries of row r's list at a flush
  uint8_t* rest;
};

// The dense row walks' list entries: the key index itself; a pair's
// bias lies at [g, i, j] of the bias [G, N, N]. A walk over another mask
// source lists other entries and maps them through a policy of the same
// shape (`CompactRowPairs`, flash_pairwalk_slots.cuh).
struct DenseRowPairs {
  size_t brow;            // (g * N + i) * N
  __device__ __forceinline__ int index(int x) const { return x; }
  __device__ __forceinline__ size_t bias(int x) const { return brow + x; }
};

// A warp's items: HG heads (all H up to 32) of R rows, R the largest power
// of two with R * HG <= 32, so that R divides BM.
__host__ inline void warp_items(int H, int* HG, int* R) {
  *HG = H < WARP ? H : WARP;
  *R = 1;
  while (*R * 2 * *HG <= WARP) *R *= 2;
}

__host__ __device__ inline size_t walk_bytes(int R) {
  return (size_t)NST * R * BN + (size_t)R * CAPR * 4 + WARP * 4;
}

__device__ __forceinline__ WalkSmem walk_smem(uint8_t* smem, int R) {
  WalkSmem w;
  w.ring = smem;
  w.lists = reinterpret_cast<int*>(smem + (size_t)NST * R * BN);
  w.rowcnt = w.lists + R * CAPR;
  w.rest = smem + walk_bytes(R);
  return w;
}

// The walk of rows [row0, row0 + R) of the snapshot's mask mg over the key
// tiles jl[0..cnt), by the whole warp (lane = threadIdx.x). flush() is
// called by every lane, after a __syncwarp, with row r's list at
// sm.lists + r * CAPR and its length at sm.rowcnt[r]. jl is the plan's
// row of tile indices, or any object whose [t] gives step t's tile; win
// says which rows and columns of mg the walk lists.
template <bool kVec16, class Flush, class Tiles, class Window = WholeMask>
__device__ __forceinline__ void walk_mask(const WalkSmem& sm,
                                          const uint8_t* mg, int N, int row0,
                                          int R, const Tiles& jl, int cnt,
                                          int lane, Flush&& flush,
                                          const Window& win = Window{}) {
  uint8_t* ring = sm.ring;
  int* lists = sm.lists;
  int* rowcnt = sm.rowcnt;
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
    flush();
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MAX_CPL; ++i) rcount[i] = 0;
  };

  for (int s = 0; s < NST - 1; ++s) {
    if (s < cnt)
      load_chunks<kVec16>(ring + s * stage_bytes, mg, N, win.rows(N), row0,
                          R, jl[s] * BN, lane);
    cp_async_commit();
  }
  for (int t = 0; t < cnt; ++t) {
    const int tt = t + NST - 1;
    if (tt < cnt)
      load_chunks<kVec16>(ring + (tt % NST) * stage_bytes, mg, N,
                          win.rows(N), row0, R, jl[tt] * BN, lane);
    cp_async_commit();
    cp_async_wait_ring();
    const uint8_t* stage = ring + (t % NST) * stage_bytes;
    uint32_t bits[MAX_CPL];
    bool any = false;
#pragma unroll
    for (int i = 0; i < MAX_CPL; ++i) {
      if (i >= cpl) break;
      const int c = lane + WARP * i;
      bits[i] = c < R * 4
                    ? win.keep(chunk_bits(stage, c), jl[t] * BN + 16 * (c & 3))
                    : 0u;
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

}

// ---------------------------------------------------------------------------
// The key walk
// ---------------------------------------------------------------------------

constexpr int KROW = BN + 16;     // key walk ring row stride: 16-byte aligned,
                                  // and a warp's column reads spread banks
// the key walk's mask read: false copies each walked tile whole, true each
// warp's R-byte column pieces of its 64 rows (pairwalk_variants.py)
constexpr bool KEY_PIECES = false;

// Bytes of a key walk block's walk: the ring [NST][64][KROW] of mask tiles
// and the keys' lists.
__host__ __device__ inline size_t key_walk_bytes(int KB) {
  return (size_t)NST * BM * KROW + (size_t)KB * CAPR * 4;
}

// Step t's mask tile, rows [row0, row0 + 64) x keys [col0, col0 + 64), into
// `stage` (row stride KROW): the whole tile by all threads in 16-byte
// chunks, or (KEY_PIECES) each warp its keys' R-byte pieces of the 64 rows
// in 4-byte words. Rows and columns past N read as 0.
template <bool kVec16>
__device__ __forceinline__ void load_key_tile(uint8_t* stage,
                                              const uint8_t* mg, int N,
                                              int row0, int col0, int kc0,
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

// The walk of a key walk block over the steps [0, cnt) of the transposed
// plan, row tiles il, of the snapshot's mask mg, for keys [col0, col0 + 64)
// of which each warp owns R from kc0 (its first in the tile), the lane's
// key kl = lane / HG (written by the key's `writer` lane).
//  1. Each walked [64 rows x 64 keys] mask tile is copied whole, 64-byte
//     row segments (the sectors the row walk reads), by cp.async into an
//     NST-stage ring, NST - 1 steps ahead, one block barrier a step (6
//     stages measured the same as 4 on the H100).
//  2. Each warp turns its R columns of the tile into a 64-bit row word a
//     key (two ballots a key: rows 0-31 and 32-63) and appends the key's
//     valid rows, ascending, to `list` in shared memory, one step later.
//  3. flush(n) is called by every lane with its key's list of n rows: by
//     every warp at once when the block votes at a step's barrier that a
//     list could pass CAPR (a warp flushing alone held the others at the
//     next barrier), and by each warp at the end.
// Rows and keys past N read as 0 and list nothing.
template <bool kVec16, class Flush>
__device__ __forceinline__ void walk_key_mask(uint8_t* ring, int* list,
                                              const uint8_t* mg, int N,
                                              int col0, int kc0, int kl,
                                              int R, bool writer,
                                              const int* il, int cnt,
                                              Flush&& flush) {
  const int lane = threadIdx.x & (WARP - 1);
  const int stage_bytes = BM * KROW;
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
      load_key_tile<kVec16>(ring + s * stage_bytes, mg, N, il[s] * BM, col0,
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
      load_key_tile<kVec16>(ring + (tt % NST) * stage_bytes, mg, N,
                            il[tt] * BM, col0, kc0, R);
    cp_async_commit();
    if (full) {
      flush(n);
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
    flush(n);
    __syncwarp();
    n = 0;
  }
  append();
  __syncwarp();
  flush(n);
}

}  // namespace tagan_pairwalk
