// ring_exchange: the lexicographic minimum of one winner tuple per member of
// a process shard group's axis, passed around a ring of n - 1 steps through
// peer memory; the result lands on every member.
//
// Replaces the Pallas kernel `ring_winner_exchange` in
// armada_tpu/ops/pallas_kernels.py (loop at :532-563, `pallas_call` :566),
// where each step DMAs the running best to the right neighbour with
// `make_async_remote_copy` and waits on a semaphore.
//
// What it computes, exactly the reference loop: the running best starts as
// the member's own row; each of the n - 1 steps sends the running best to the
// right neighbour and receives the left neighbour's; the candidate replaces
// the running best, gid column included, only if it is strictly less,
// lexicographically over columns 0..w-2 (column 0, notfound, most
// significant). The last column, the gid, is not compared. So on a tie a
// member keeps the row it holds, and when every row is not-found each member
// ends with its own gid (winner_reduce keeps row 0 there instead).
//
// Peer memory: each member owns one buffer, allocated here with cudaMalloc
// (an IPC handle names a whole allocation) and opened by its left neighbour
// with cudaIpcOpenMemHandle: on another card over NVLink, or on the same
// card from another process. Layout, in 32-bit words:
//   slots: [2 parities][n - 1 steps][w]  the left neighbour's running best
//   flags: [2 parities][n - 1 steps]      the epoch whose slot has landed
// Call e (a per-buffer counter from 1, so the buffer is never reset) uses
// parity e & 1. Step s writes the running best into the right neighbour's
// slot (e & 1, s), then publishes the right neighbour's flag (e & 1, s) as e
// with a system-scope release; the member then waits until its own flag
// (e & 1, s) reads e with a system-scope acquire. Send and receive use
// separate slots (the reference DMAs out of and into the same buffer). Two
// parities suffice: a member finishes call e + 1 only after its last step's
// arrival, which carries its right neighbour's row of call e + 1, so the
// right neighbour has left call e and no longer reads its parity-e slots
// when call e + 2 writes them.
//
// The spin cannot hang: it reads %globaltimer and gives up after timeout_ns,
// writing the failed step + 1 into out[w] (0 on success); the wrapper reads
// that word with the result and raises. Several processes on one card
// without MPS time-slice it, so a spinning member waits for its neighbour's
// context to get its slice: a step costs a context switch there.
//
// Bound on the H100: latency. A member moves (n - 1) * w * 4 bytes (48 at
// n = 4, K = 3 over a 2-host ring) and compares a few words per step; the
// time is the flag round trip per step. One warp per member, lane c holding
// column c (w <= 32), so a compare is two ballots.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int32_t ld_relaxed_sys(const int32_t* p) {
  int32_t v;
  asm volatile("ld.relaxed.sys.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_sys(int32_t* p, int32_t v) {
  asm volatile("st.relaxed.sys.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One warp. row int32[w] is this member's tuple; mine/right are this
// member's and its right neighbour's ring buffers (unused when n == 1);
// out int32[w + 1] gets the result and the status word.
__global__ void ring_exchange_kernel(const int32_t* __restrict__ row, int w,
                                     int n, int32_t* mine, int32_t* right,
                                     unsigned epoch, long long timeout_ns,
                                     int32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  const bool col = lane < w;
  const bool compared = lane < w - 1;
  int32_t best = col ? row[lane] : 0;
  int32_t status = 0;
  const int steps = n - 1;
  const int parity = static_cast<int>(epoch & 1u);
  unsigned* my_flags = reinterpret_cast<unsigned*>(mine + 2 * steps * w);
  unsigned* right_flags = reinterpret_cast<unsigned*>(right + 2 * steps * w);
  for (int s = 0; s < steps; ++s) {
    const int slot = parity * steps + s;
    if (col) st_relaxed_sys(right + slot * w + lane, best);
    __syncwarp();
    if (lane == 0) {
      __threadfence_system();
      st_release_sys(right_flags + slot, epoch);
    }
    bool arrived = false;
    const unsigned long long start = global_ns();
    while (true) {
      if (ld_acquire_sys(my_flags + slot) == epoch) {
        arrived = true;
        break;
      }
      if (global_ns() - start > static_cast<unsigned long long>(timeout_ns)) break;
      __nanosleep(64);
    }
    if (!__all_sync(kFull, arrived)) {  // uniform across the warp
      status = s + 1;
      break;
    }
    const int32_t cand = col ? ld_relaxed_sys(mine + slot * w + lane) : 0;
    const unsigned differ = __ballot_sync(kFull, compared && cand != best);
    const unsigned less = __ballot_sync(kFull, compared && cand < best);
    // The first differing column decides; equal tuples keep the held row.
    if (differ != 0 && ((less >> (__ffs(differ) - 1)) & 1u)) best = cand;
  }
  if (col) out[lane] = best;
  if (lane == 0) out[w] = status;
}

}  // namespace

// Bytes of one member's ring buffer for an axis of n members and rows of w
// words (0 when n == 1: that ring takes no step).
extern "C" long long armada_ring_bytes(int n, int w) {
  if (n <= 1) return 0;
  return 2LL * (n - 1) * (w + 1) * static_cast<long long>(sizeof(int32_t));
}

// Allocate and zero a ring buffer of `bytes` on `device` and export it:
// *ptr gets the device pointer, handle (64 bytes) its cudaIpcMemHandle_t.
extern "C" int armada_ring_alloc(int device, long long bytes, void** ptr,
                                 void* handle) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  // The zeroes must be in place before a neighbour's first write, which
  // follows the handle exchange.
  if (rc == cudaSuccess) rc = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (rc == cudaSuccess) rc = cudaIpcGetMemHandle(&h, *ptr);
  if (rc != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return static_cast<int>(rc);
  }
  std::memcpy(handle, &h, sizeof(h));
  return 0;
}

// Open another process's exported buffer on `device`.
extern "C" int armada_ring_open(int device, const void* handle, void** ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int armada_ring_close(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int armada_ring_free(int device, void* ptr) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaFree(ptr));
}

// row int32[w] and out int32[w + 1] on the device, 2 <= w <= 32; mine and
// right as armada_ring_alloc / armada_ring_open gave them (null when n == 1).
// Launches one warp on `stream` and returns cudaGetLastError().
extern "C" int armada_ring_exchange(const void* row, int w, int n, void* mine,
                                    void* right, unsigned epoch,
                                    long long timeout_ns, void* out,
                                    void* stream) {
  if (w < 2 || w > 32 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 1 && (mine == nullptr || right == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ring_exchange_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row), w, n, static_cast<int32_t*>(mine),
      static_cast<int32_t*>(right), epoch, timeout_ns,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
