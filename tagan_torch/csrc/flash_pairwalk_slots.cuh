// The slot walks over the hybrid band's compact store. The row slot walk
// (`walk_slots`) is shared by the walks that take one row list a lane
// group: the compact forward walk of flash_pairwalk_fwd_compact.cu (B1c and
// B5c in both precisions), the compact row walk of
// flash_pairwalk_biased_bwd_compact.cu (B6c and B7a c in both precisions)
// and the unbiased one of flash_pairwalk_bwd_compact.cu (B3a c, both
// precisions).
// The key slot walk (`walk_key_slots`, at the end) is shared by the key
// walks over the transposed walk: the compact biased key walk of
// flash_pairwalk_biased_bwd_compact.cu (B7b c) and the unbiased one of
// flash_pairwalk_bwd_compact.cu (B3b c), both in both precisions.
//
// The store holds a snapshot's occupied 64 x 64 tiles, slot s of batch
// index g at g * S + s, as 64 uint64 row words (bit c of word r for pair
// (r, c); COMPACT_BITS) or int8 [64][64] (COMPACT_I8). Each walk step t
// names its key tile jl[t] and its slot js[t]; a step past the walk's
// count is not taken, and a slot whose bits are all 0 lists nothing.
//
// One warp walks R rows of one 64-row query tile. At each step, lane
// r < R copies its row's word (8 bytes) of the step's slot by cp.async into
// an NST-stage ring, NST - 1 steps ahead (the int8 store: reads its 64-byte
// row and puts the row's word there), reads back only its own word, keeps
// the columns before N and appends its set bits, ascending, to its row's
// list in shared memory as entries t * 64 + c (CAPR entries a row: at the
// band's ~1 valid pair a row and walked tile, the whole walk). When a
// row's list could overflow, and at the end, the walk calls the kernel's
// flush. `CompactRowPairs` turns an entry back into its key and the offset
// of its pair in a store-shaped array (the bias, dB).

#pragma once

#include "flash_pairwalk.cuh"

namespace tagan_pairwalk {

// Bytes of a row's (a tile's) mask in the store.
template <int kForm>
__host__ __device__ constexpr int row_store_bytes() {
  return kForm == COMPACT_BITS ? 8 : BN;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// The set bits of a 64-bit word, keeping only columns (rows) below `n`.
__device__ __forceinline__ uint64_t below(uint64_t w, int n) {
  return n >= 64 ? w : n <= 0 ? 0ull : w & ((1ull << n) - 1ull);
}

// Bit b of the result: byte b of x is nonzero (each byte's low 7 bits
// carried into its top bit, or'd with the byte's own top bit).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  const uint32_t t = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) |
         ((t >> 28) & 8u);
}

// Bit b of the result: byte b of the 16 bytes x is nonzero.
__device__ __forceinline__ uint32_t nonzero_bits16(uint4 x) {
  return nonzero_bytes(x.x) | (nonzero_bytes(x.y) << 4) |
         (nonzero_bytes(x.z) << 8) | (nonzero_bytes(x.w) << 12);
}

// The 64-bit word of an int8 row of 64 bytes in device memory (16-byte
// aligned): bit c for a nonzero byte c.
__device__ __forceinline__ uint64_t i8_word(const uint8_t* row) {
  uint64_t w = 0;
#pragma unroll
  for (int part = 0; part < 4; ++part)
    w |= (uint64_t)nonzero_bits16(
             __ldg(reinterpret_cast<const uint4*>(row) + part))
         << (16 * part);
  return w;
}

// A row walk's list entries, t * 64 + c: walk step t (its key tile jl[t]
// and slot js[t]) and the column c in the tile; `bias` is the offset of the
// pair in an array shaped as the store, [G, S, 64, 64] (the bias, dB).
struct CompactRowPairs {
  const int* jl;          // the walk's key tiles
  const int* js;          // and slots
  size_t g_s;             // g * S
  int rloc;               // the row's place in its tile
  __device__ __forceinline__ int index(int x) const {
    return __ldg(jl + (x >> 6)) * BN + (x & (BN - 1));
  }
  __device__ __forceinline__ size_t bias(int x) const {
    return ((g_s + __ldg(js + (x >> 6))) * BM + rloc) * BN + (x & (BN - 1));
  }
};

// Bytes of a warp's slot walk: the ring [NST][R] of row words, the rows'
// lists and their counts.
__host__ __device__ inline size_t slot_walk_bytes(int R) {
  return (size_t)NST * R * 8 + (size_t)R * CAPR * 4 + WARP * 4;
}

// Lane r < R: row r's word of step s (slot js[s] of the snapshot's store
// st; rows from rr0 of the tile) into its place in ring stage s % NST: the
// bit store's word by cp.async, the int8 store's row read and turned into
// its word at once.
template <int kForm>
__device__ __forceinline__ void load_rows(uint64_t* ring, const uint8_t* st,
                                          const int* js, int s, int rr0,
                                          int R, int lane) {
  constexpr int RB = row_store_bytes<kForm>();
  if (lane >= R) return;
  const uint8_t* src = st + ((size_t)__ldg(js + s) * BM + rr0 + lane) * RB;
  uint64_t* dst = ring + (s % NST) * R + lane;
  if constexpr (kForm == COMPACT_BITS)
    cp_async8(dst, src);
  else
    *dst = i8_word(src);
}

// The walk of rows [row0, row0 + R) (rr0 their first place in their tile)
// over the steps [0, cnt) of slots js in the snapshot's store st, by the
// whole warp. flush() is called by every lane, after a __syncwarp, with
// row r's list at lists + r * CAPR and its length at rowcnt[r], when a
// list could overflow and at the end, from one place.
template <int kForm, class Flush>
__device__ __forceinline__ void walk_slots(uint64_t* ring, int* lists,
                                           int* rowcnt, const uint8_t* st,
                                           int N, int row0, int rr0, int R,
                                           const int* jl, const int* js,
                                           int cnt, int lane, Flush&& flush) {
  int rcount = 0;       // lane r < R: entries of row r's list
  const int rows_in = N - row0;   // rows of the warp before N

  for (int s = 0; s < NST - 1; ++s) {
    if (s < cnt) load_rows<kForm>(ring, st, js, s, rr0, R, lane);
    cp_async_commit();
  }
  for (int t = 0;; ++t) {
    const bool end = t == cnt;
    uint64_t w = 0;
    if (!end) {
      if (t + NST - 1 < cnt)
        load_rows<kForm>(ring, st, js, t + NST - 1, rr0, R, lane);
      cp_async_commit();
      cp_async_wait_ring();
      if (lane < R && lane < rows_in)   // the lane's own copy
        w = below(ring[(t % NST) * R + lane], N - __ldg(jl + t) * BN);
    }
    const int n = __popcll(w);
    if (!end && !__any_sync(FULL, n != 0)) continue;
    if (end || __any_sync(FULL, rcount + n > CAPR)) {
      if (lane < R) rowcnt[lane] = rcount;
      __syncwarp();
      flush();
      __syncwarp();
      rcount = 0;
    }
    if (end) break;
    if (n) {            // lanes past R hold no word
      int* dst = lists + lane * CAPR + rcount;
      for (; w; w &= w - 1) *dst++ = t * BN + __ffsll((long long)w) - 1;
    }
    rcount += n;
  }
}


// ---------------------------------------------------------------------------
// The key slot walk
// ---------------------------------------------------------------------------

// A key walk's list entries, t * 64 + r: walk step t (its row tile il[t]
// and slot isl[t]) and the row r in the tile; `bias` is the offset of the
// pair in an array shaped as the store, [G, S, 64, 64].
struct CompactKeyPairs {
  const int* il;          // the walk's row tiles
  const int* isl;         // and slots
  size_t g_s;
  int cloc;               // the key's place in its tile
  __device__ __forceinline__ int index(int x) const {
    return __ldg(il + (x >> 6)) * BM + (x & (BM - 1));
  }
  __device__ __forceinline__ size_t bias(int x) const {
    return ((g_s + __ldg(isl + (x >> 6))) * BM + (x & (BM - 1))) * BN + cloc;
  }
};

// Bytes of a key walk block's walk: the ring [NST][64] of the walked slots'
// row words and the keys' lists.
__host__ __device__ inline size_t slot_key_walk_bytes(int KB) {
  return (size_t)NST * BM * 8 + (size_t)KB * CAPR * 4;
}

// The slot's 64 row words into `stage`, by the block: the bit store's 512
// bytes in 16-byte chunks by cp.async; the int8 store's rows read 16 bytes
// a thread, each turned into 16 bits of its row's word at once.
template <int kForm>
__device__ __forceinline__ void load_slot(uint64_t* stage, const uint8_t* st,
                                          size_t slot) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const uint8_t* src = st + slot * BM * row_store_bytes<kForm>();
  if constexpr (kForm == COMPACT_BITS) {
    for (int c = tid; c < BM * 8 / 16; c += nthr)
      cp_async16(reinterpret_cast<uint8_t*>(stage) + 16 * c, src + 16 * c,
                 true);
  } else {
    uint16_t* parts = reinterpret_cast<uint16_t*>(stage);   // 4 a word
    for (int c = tid; c < BM * 4; c += nthr)
      parts[c] = (uint16_t)nonzero_bits16(
          __ldg(reinterpret_cast<const uint4*>(src) + c));
  }
}

// The walk of a key walk block over the steps [0, cnt) of the transposed
// walk, row tiles il and slots isl of the snapshot's store st. Each walked
// slot's 64 row words are copied whole into the block's ring (NST stages,
// NST - 1 steps ahead), one block barrier a step; each warp turns its R
// keys' columns (kc0 + [0, R) of the tile) into a 64-bit row word a key by
// two ballots (rows 0-31 and 32-63), keeps the rows before N (none for a
// key past N: key_in false) and, one step later, appends its lane's key's
// rows (key kl = lane / HG, written by the key's `writer` lane), ascending,
// to `list` as entries t * 64 + r. flush(n) is called by every lane with
// its key's list of n entries: by every warp at once when the block votes
// at a step's barrier that a list could pass CAPR (a warp flushing alone
// held the others at the next barrier), and by each warp at the end.
template <int kForm, class Flush>
__device__ __forceinline__ void walk_key_slots(
    uint64_t* ring, int* list, const uint8_t* st, int N, int kc0, int kl,
    int R, bool writer, bool key_in, const int* il, const int* isl, int cnt,
    Flush&& flush) {
  const int lane = threadIdx.x & (WARP - 1);
  int n = 0;                    // entries of the lane's key list
  // step t - 1's row word of the lane's key, appended at step t (after
  // the block's vote on a flush), its popcount and its step's first entry
  uint64_t word = 0;
  int add = 0, e0 = 0;
  auto append = [&]() {
    if (writer && add) {
      int* dst = list + n;
      for (uint64_t w = word; w; w &= w - 1)
        *dst++ = e0 + __ffsll((long long)w) - 1;
    }
    n += add;
  };

  for (int s = 0; s < NST - 1; ++s) {
    if (s < cnt) load_slot<kForm>(ring + s * BM, st, __ldg(isl + s));
    cp_async_commit();
  }
  for (int t = 0; t < cnt; ++t) {
    cp_async_wait_key();        // this thread's copies of step t
    // everyone's copies of step t, everyone done with step t - 1's stage,
    // and the block's vote on a flush
    const bool full = __syncthreads_or(n + add > CAPR);
    const int tt = t + NST - 1;   // into step t - 1's stage
    if (tt < cnt)
      load_slot<kForm>(ring + (tt % NST) * BM, st, __ldg(isl + tt));
    cp_async_commit();
    if (full) {
      flush(n);
      __syncwarp();
      n = 0;
    }
    append();
    // the row word of each of the warp's R keys: bit r for row r
    const uint64_t* rows = ring + (t % NST) * BM;
    const uint64_t wl = rows[lane], wh = rows[lane + WARP];
    word = 0;
    for (int c = 0; c < R; ++c) {
      const int bit = kc0 + c;
      const unsigned lo = __ballot_sync(FULL, (wl >> bit) & 1ull);
      const unsigned hi = __ballot_sync(FULL, (wh >> bit) & 1ull);
      if (c == kl) word = (uint64_t)lo | ((uint64_t)hi << 32);
    }
    // rows and keys past N carry no pair
    word = key_in ? below(word, N - __ldg(il + t) * BM) : 0ull;
    add = kl < R ? __popcll(word) : 0;
    e0 = t * BM;
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
