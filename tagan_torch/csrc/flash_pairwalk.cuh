// The mask walk shared by the pair walks of flash_pairwalk_fwd.cu (B1 and
// B1's, B4's and B5's bf16 forms), flash_pairwalk_bwd.cu (B2 and B2's bf16
// form) and flash_pairwalk_biased_bwd.cu (its row walk).
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
// listed pairs.

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

// A warp's shared memory begins with the walk's: the mask ring, the rows'
// lists and their counts; the kernel's own part follows, 16-byte aligned.
struct WalkSmem {
  uint8_t* ring;    // [NST][R][BN]
  int* lists;       // [R][CAPR]
  int* rowcnt;      // [WARP]: entries of row r's list at a flush
  uint8_t* rest;
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
// sm.lists + r * CAPR and its length at sm.rowcnt[r].
template <bool kVec16, class Flush>
__device__ __forceinline__ void walk_mask(const WalkSmem& sm,
                                          const uint8_t* mg, int N, int row0,
                                          int R, const int* jl, int cnt,
                                          int lane, Flush&& flush) {
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
      load_chunks<kVec16>(ring + s * stage_bytes, mg, N, row0, R,
                          jl[s] * BN, lane);
    cp_async_commit();
  }
  for (int t = 0; t < cnt; ++t) {
    const int tt = t + NST - 1;
    if (tt < cnt)
      load_chunks<kVec16>(ring + (tt % NST) * stage_bytes, mg, N, row0, R,
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

}

}  // namespace tagan_pairwalk
