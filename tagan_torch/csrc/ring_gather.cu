// The ring all-gather (B8) and the ring's chunk copy, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tagan_tpu/ops/pallas/ring_gather.py::
// _ring_kernel (B8): every rank of the graph axis holds a row shard
// [chunk, D] and ends with all of them, [g * chunk, D] in rank order, after
// g - 1 hops around a ring. On the TPU that is one pallas_call a chip,
// whose hops are remote DMAs ordered by DMA semaphores. Here it is one
// launch a card, ring_gather_kernel, for all the ranks of the ring that
// live on that card, and its hops are ordered by flags in device memory: a
// 32-bit word per (rank, hop, tile) that one block releases and another
// acquires.
//
// Design. Each chunk's bytes are cut into T tiles of TILE bytes (the last
// one shorter; one tile of 0 bytes for an empty chunk). An item is
// (rank r, hop h, tile t), h in [0, g): h = 0 copies tile t of r's shard
// into r's out rows of chunk r; h >= 1 (hop h - 1 of the ring) waits until
// the left rank's flag (left, h - 1, t) holds this ring's epoch, then
// copies tile t of chunk c = (r - h) mod g from the left rank's out into
// the same rows of r's out. Every item then releases its own flag
// (r, h, t) with the epoch. A rank reads its left neighbour's memory and
// writes only its own (a pull; the TPU kernel pushes to the right, the
// same ring read from the other end, the same hops and bytes), so when a
// card's launch ends every out on that card is whole. Items are numbered
// hop-major (every own copy, then hop 0 of every rank and tile, ...), and
// block b takes items b, b + B, b + 2B, ...: an item waits only on one of
// a lower hop, and a block releases what it holds before it spins, so the
// ring cannot deadlock once every block is resident, which the
// cooperative launch guarantees (its grid is at most the blocks the card
// holds at once). ops/ring_gather.py::ring_schedule is the same numbering
// in Python; the CPU tests run it with random interleavings of the blocks.
//
// Flags are never reset between rings: the wrapper hands each ring the
// next epoch of its mesh, and rings on one card are ordered by its
// stream. A flag is released by one thread with st.release after the
// block's stores (bar.sync, then a fence) and acquired by one thread with
// ld.acquire and __nanosleep backoff, then bar.sync. A spin that sees no
// flag for about a second traps, so that a lost flag surfaces as a CUDA
// error at the next synchronise rather than a hang.
//
// A tile whose source and destination share their offset modulo 16 (every
// hop: all outs are whole allocations) moves by Hopper's bulk copy: one
// thread issues cp.async.bulk global -> shared (completion on an mbarrier)
// and then shared -> global, two tile buffers a block, so that one tile's
// store overlaps the next one's load; its flag is released after
// cp.async.bulk.wait_group 0 and fence.proxy.async (the bulk store belongs
// to the async proxy), and the consumer fences the same way between its
// acquire and its own bulk load. The tile's head up to the 16-byte grid and
// its tail go byte by byte; a tile whose source and destination differ in
// alignment (an own copy where chunk * row bytes is not a multiple of 16,
// as at D = 7 with odd chunks) goes word by word through copy_any, the
// copy that copy_kernel makes too: the widest word both share.
//
// Ranks on several cards: one launch a card, flags and the left rank's
// loads at .sys scope (kSys) through peer pointers (tagan_ring_enable_peer
// from the reading card).
//
// Why a ring: a rank reads only its left neighbour, so ranks on several
// cards need peer access between neighbours alone, as the TPU's ring needs
// links between neighbours alone (cards joined in a chain or over PCIe
// switches that pair only some of them). Where every rank can read every
// other (one card, or cards joined all to all by NVLink) a direct pull,
// out_r's chunk c read from shard c, moves the same bytes with no order
// between blocks; ROADMAP keeps it as a follow-up.
//
// What bounds it on the H100: bytes. Each rank reads the g - 1 chunks it
// does not own and writes g * chunk rows. What the design does about the
// host: the ring is one launch a card with its pointers in a struct passed
// by value as the kernel's parameter, so no ring copies anything from the
// host to the card, and nothing else is issued: no event, no stream wait,
// where all ranks share one card (the old schedule issued g * g copy
// launches and 2 g (g - 1) event records and waits a ring).
//
// copy_kernel, the ring flash's chunk mover (B9, ring_flash.cu; its
// schedule in ops/ring_flash.py), copies n bytes from src to dst, which may
// lie on another card (a store through a peer pointer), by copy_any with
// a grid stride: the widest word w in {16, 8, 4, 2, 1} bytes for which dst
// and src share their offset modulo w, the head bytes up to dst's
// w-alignment and the tail bytes one at a time, the body in w-byte words.
// Bound: 2n bytes.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;

// The widest word, of 16, 8, 4, 2 or 1 bytes, on whose grid dst and src
// lie alike: a copy between them moves in such words.
__host__ __device__ __forceinline__ int word_bytes(const void* dst,
                                                   const void* src) {
  const uintptr_t off = (uintptr_t)dst ^ (uintptr_t)src;
  return off % 16 == 0 ? 16 : off % 8 == 0 ? 8 : off % 4 == 0 ? 4
         : off % 2 == 0 ? 2 : 1;
}

// n bytes from src to dst in Word units, by the threads start, start +
// stride, ...: the head bytes up to dst's Word grid, the body in words,
// the tail bytes. Loads go through L2 (__ldcg): in the ring the source may
// have been written by another SM in the same launch.
template <typename Word>
__device__ __forceinline__ void copy_span(uint8_t* dst, const uint8_t* src,
                                          size_t n, size_t start,
                                          size_t stride) {
  constexpr size_t w = sizeof(Word);
  size_t head = (w - (uintptr_t)dst % w) % w;
  if (head > n) head = n;
  const size_t words = (n - head) / w, end = head + words * w;
  for (size_t i = start; i < head; i += stride) dst[i] = __ldcg(src + i);
  for (size_t i = start; i < n - end; i += stride)
    dst[end + i] = __ldcg(src + end + i);
  Word* d = reinterpret_cast<Word*>(dst + head);
  const Word* s = reinterpret_cast<const Word*>(src + head);
  for (size_t i = start; i < words; i += stride) d[i] = __ldcg(s + i);
}

// copy_span in the widest word dst and src share
__device__ __forceinline__ void copy_any(uint8_t* dst, const uint8_t* src,
                                         size_t n, size_t start,
                                         size_t stride) {
  switch (word_bytes(dst, src)) {
    case 16: copy_span<uint4>(dst, src, n, start, stride); break;
    case 8: copy_span<uint2>(dst, src, n, start, stride); break;
    case 4: copy_span<uint32_t>(dst, src, n, start, stride); break;
    case 2: copy_span<uint16_t>(dst, src, n, start, stride); break;
    default: copy_span<uint8_t>(dst, src, n, start, stride);
  }
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
            size_t n) {
  copy_any(dst, src, n, (size_t)blockIdx.x * THREADS + threadIdx.x,
           (size_t)gridDim.x * THREADS);
}

// -- the ring all-gather -------------------------------------------------------

constexpr int GATHER_THREADS = 128;
constexpr int TILE = 32 * 1024;          // ops/ring_gather.py TILE_BYTES
constexpr int SMEM = 2 * TILE;           // two tile buffers a block
constexpr int MAX_RANKS = 200;           // ops/ring_gather.py MAX_RANKS
constexpr int MAX_CARDS = 16;            // ops/ring_gather.py MAX_CARDS
constexpr unsigned long long SPIN_NS = 1000000000ull;

// The ring's pointers, passed by value as the kernel's parameter: rank r's
// shard and out, the flag words of each card (indexed (r * g + h) * T + t
// by global rank), the card of each rank, and the ranks of this launch's
// card in rank order.
struct RingPtrs {
  const uint8_t* x[MAX_RANKS];
  uint8_t* out[MAX_RANKS];
  uint32_t* flags[MAX_CARDS];
  uint8_t card[MAX_RANKS];
  uint8_t local[MAX_RANKS];
};
// a kernel's parameters may take 4 KB; the scalars after the struct
static_assert(sizeof(RingPtrs) + 64 <= 4096, "RingPtrs past 4 KB");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <bool kSys>
__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  if (kSys)
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <bool kSys>
__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  if (kSys)
    asm volatile("st.release.sys.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the 32-bit epoch may wrap: a flag is ready once it is not behind
__device__ __forceinline__ bool reached(uint32_t flag, uint32_t epoch) {
  return (int)(flag - epoch) >= 0;
}

template <bool kSys>
__device__ void spin(const uint32_t* flag, uint32_t epoch) {
  const unsigned long long t0 = now_ns();
  unsigned ns = 32;
  while (!reached(load_acquire<kSys>(flag), epoch)) {
    __nanosleep(ns);
    ns = ns < 512 ? 2 * ns : 512;
    if (now_ns() - t0 > SPIN_NS) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t n, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(n) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(src), "r"(n), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(n) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{ .reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// Thread 0's flag of the block's last item, released once the item's
// bytes are out: its bulk store complete (wait_group 0, then the proxy
// fence), its other threads' stores before a bar.sync since.
template <bool kSys>
__device__ __forceinline__ void release(uint32_t*& pending, bool& bulk,
                                        uint32_t epoch) {
  if (pending == nullptr) return;
  if (bulk) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    fence_proxy_async();
  }
  if (kSys) __threadfence_system();
  else __threadfence();
  store_release<kSys>(pending, epoch);
  pending = nullptr;
  bulk = false;
}

template <bool kSys>
__global__ void __launch_bounds__(GATHER_THREADS)
ring_gather_kernel(const __grid_constant__ RingPtrs p, const long long cb,
                   const int g,
                   const int n_local, const int T, const uint32_t epoch) {
  extern __shared__ __align__(128) uint8_t tiles[];
  __shared__ __align__(8) uint64_t bars[2];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&bars[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint32_t* pending = nullptr;            // thread 0's unreleased flag
  bool pending_bulk = false;
  uint32_t parity = 0;                    // bit b: buffer b's mbarrier phase
  const long long per_hop = (long long)n_local * T;
  const long long n_items = per_hop * g;
  int k = 0;                              // the block's item count
  for (long long i = blockIdx.x; i < n_items; i += gridDim.x, ++k) {
    // ring_schedule's numbering: hop-major, then rank, then tile
    const int h = (int)(i / per_hop);
    const long long rem = i - (long long)h * per_hop;
    const int r = p.local[rem / T];
    const int t = (int)(rem % T);
    const int left = (r + g - 1) % g;
    const long long c = (r + g - h) % g;
    const long long off = (long long)t * TILE;
    const size_t n = (size_t)(cb - off < TILE ? cb - off : TILE);
    uint8_t* dst = p.out[r] + c * cb + off;
    const uint8_t* src = h == 0 ? p.x[r] + off : p.out[left] + c * cb + off;
    __syncthreads();      // the last item's word stores are done
    if (tid == 0 && h > 0) {
      const uint32_t* f = p.flags[p.card[left]]
          + ((long long)left * g + h - 1) * T + t;
      if (!reached(load_acquire<kSys>(f), epoch)) {
        release<kSys>(pending, pending_bulk, epoch);   // before spinning
        spin<kSys>(f, epoch);
      }
      fence_proxy_async();  // the acquire before this block's bulk load
    }
    __syncthreads();      // every thread past the wait
    uint32_t* mine = p.flags[p.card[r]] + ((long long)r * g + h) * T + t;
    const uintptr_t mis = (uintptr_t)dst % 16;
    if (((uintptr_t)src ^ (uintptr_t)dst) % 16 == 0) {
      size_t head = (16 - mis) % 16;
      if (head > n) head = n;
      const size_t body = (n - head) / 16 * 16, end = head + body;
      if (tid == 0) {
        const int b = k & 1;
        const uint32_t buf = smem_addr(tiles + b * TILE);
        if (body > 0) {
          bulk_load(buf, src + head, (uint32_t)body, smem_addr(&bars[b]));
          mbar_wait(smem_addr(&bars[b]), (parity >> b) & 1);
          parity ^= 1u << b;
        }
        release<kSys>(pending, pending_bulk, epoch);   // the last item
        if (body > 0) bulk_store(dst + head, buf, (uint32_t)body);
        pending = mine;
        pending_bulk = body > 0;
      }
      if (tid < head) dst[tid] = __ldcg(src + tid);
      if (tid < n - end) dst[end + tid] = __ldcg(src + end + tid);
    } else {
      if (tid == 0) {
        release<kSys>(pending, pending_bulk, epoch);
        pending = mine;
      }
      copy_any(dst, src, n, tid, GATHER_THREADS);
    }
  }
  __syncthreads();
  if (tid == 0) release<kSys>(pending, pending_bulk, epoch);
}

template <bool kSys>
cudaError_t prepare(int* blocks) {
  auto* kern = ring_gather_kernel<kSys>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, per_sm = 0, sms = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))
      != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    GATHER_THREADS, SMEM);
  if (e != cudaSuccess) return e;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// Copies nbytes from src to dst on `stream` (a stream of src's card).
extern "C" int tagan_ring_copy(void* dst, const void* src, long long nbytes,
                               void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  const size_t n = (size_t)nbytes;
  size_t blocks = (n / word_bytes(dst, src) + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks;
  copy_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src), n);
  return (int)cudaGetLastError();
}

// The most blocks of ring_gather_kernel<sys> the current card holds at
// once (its cooperative launch's largest grid), into *blocks; also sets
// the kernel's shared memory size on this card. Call it on each card
// before tagan_ring_all_gather.
extern "C" int tagan_ring_gather_max_blocks(int sys, int* blocks) {
  return (int)(sys ? prepare<true>(blocks) : prepare<false>(blocks));
}

// One ring of the all-gather on the current card: the ranks
// ptrs->local[0 .. n_local) of a ring of g, chunk_bytes a shard, T tiles
// of TILE bytes a chunk, flags released with `epoch`, `grid` blocks (at
// most tagan_ring_gather_max_blocks'), .sys scope if sys (ranks on several
// cards). A refused cooperative launch returns its error.
extern "C" int tagan_ring_all_gather(const void* ptrs, long long chunk_bytes,
                                     int g, int n_local, int T,
                                     unsigned epoch, int grid, int sys,
                                     void* stream) {
  if (g < 1 || g > MAX_RANKS || n_local < 1 || n_local > g || grid < 1 ||
      chunk_bytes < 0 ||
      T != (chunk_bytes > TILE ? (chunk_bytes + TILE - 1) / TILE : 1))
    return (int)cudaErrorInvalidValue;
  long long cb = chunk_bytes;
  int gg = g, nl = n_local, tt = T;
  uint32_t ep = epoch;
  void* args[] = {const_cast<void*>(ptrs), &cb, &gg, &nl, &tt, &ep};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      sys ? (const void*)ring_gather_kernel<true>
          : (const void*)ring_gather_kernel<false>,
      dim3(grid), dim3(GATHER_THREADS), args, SMEM, (cudaStream_t)stream);
  if (e != cudaSuccess) cudaGetLastError();   // clear it: the wrapper raises
  return (int)e;
}

// Lets card `device` reach card `peer`'s memory (the ring's loads from the
// left rank, the ring flash's stores to the right). Returns
// cudaErrorPeerAccessUnsupported when the pair cannot, 0 when access is
// enabled (or already was).
extern "C" int tagan_ring_enable_peer(int device, int peer) {
  if (device == peer) return 0;
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();   // the call left it as the last error: clear it
    e = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : back);
}
