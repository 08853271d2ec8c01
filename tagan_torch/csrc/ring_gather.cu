// The ring all-gather's copy kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tagan_tpu/ops/pallas/ring_gather.py::
// _ring_kernel (B8): every rank of the graph axis holds a row shard
// [chunk, D] and ends with all of them, [g * chunk, D], after g - 1 hops
// around a ring with three communication slots per rank. On the TPU the
// moves are DMAs (make_async_copy for the local ones,
// make_async_remote_copy to the right neighbour) ordered by semaphores.
// Here every move is one launch of this kernel, and the schedule and its
// ordering live in the Python wrapper (tagan_torch/ops/ring_gather.py):
// each rank launches on its own stream and sends each chunk straight into
// the right neighbour's output rows (written once, so no slot is needed),
// and a chunk's arrival is ordered with CUDA events across the ranks'
// streams. The ring flash (B9, ring_flash.cu) circulates its K/V chunks
// through three slots with the same kernel.
//
// Design. A copy of n bytes from src to dst. The pointers are 16-byte
// aligned when the tensors are whole allocations, but a row block of a
// shard starts at r * chunk * D elements, which for odd chunk and D = 7 is
// only 4-byte aligned. The wrapper picks the widest word w in {16, 8, 4,
// 2, 1} bytes for which dst and src share their offset modulo w; the
// kernel copies the head bytes up to dst's w-alignment and the tail bytes
// one at a time, and the body in w-byte loads and stores, grid-stride.
// dst may lie on another card of the host (the right neighbour's rows):
// the store then goes through a peer pointer, after
// tagan_ring_enable_peer has enabled peer access from src's card.
//
// What bounds it on the H100: bytes. A copy reads n and writes n bytes, so
// one hop of one rank takes at least 2n / 3.35 TB/s; with virtual ranks
// on one card all ranks' copies share that rate.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;

template <typename Word>
__global__ void __launch_bounds__(THREADS)
copy_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
            size_t head, size_t words, size_t tail) {
  const size_t tid = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * THREADS;
  if (tid < head) dst[tid] = src[tid];
  const size_t end = head + words * sizeof(Word);
  if (tid < tail) dst[end + tid] = src[end + tid];
  Word* __restrict__ d = reinterpret_cast<Word*>(dst + head);
  const Word* __restrict__ s = reinterpret_cast<const Word*>(src + head);
  for (size_t i = tid; i < words; i += stride) d[i] = s[i];
}

template <typename Word>
int launch(uint8_t* dst, const uint8_t* src, size_t n, cudaStream_t stream) {
  constexpr size_t w = sizeof(Word);
  size_t head = (w - (uintptr_t)dst % w) % w;
  if (head > n) head = n;
  const size_t words = (n - head) / w, tail = (n - head) % w;
  size_t blocks = (words + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks;
  copy_kernel<Word><<<(unsigned)blocks, THREADS, 0, stream>>>(
      dst, src, head, words, tail);
  return (int)cudaGetLastError();
}

}  // namespace

// Copies nbytes from src to dst on `stream` (a stream of src's card).
extern "C" int tagan_ring_copy(void* dst, const void* src, long long nbytes,
                               void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  auto* d = static_cast<uint8_t*>(dst);
  const auto* s = static_cast<const uint8_t*>(src);
  const size_t n = (size_t)nbytes;
  const uintptr_t off = (uintptr_t)d - (uintptr_t)s;
  const cudaStream_t st = (cudaStream_t)stream;
  if (off % 16 == 0) return launch<uint4>(d, s, n, st);
  if (off % 8 == 0) return launch<uint2>(d, s, n, st);
  if (off % 4 == 0) return launch<uint32_t>(d, s, n, st);
  if (off % 2 == 0) return launch<uint16_t>(d, s, n, st);
  return launch<uint8_t>(d, s, n, st);
}

// Lets card `device` store into card `peer`'s memory. Returns
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
