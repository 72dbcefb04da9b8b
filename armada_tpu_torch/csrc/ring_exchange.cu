// ring_exchange: the lexicographic minimum of one winner tuple per member of
// a process shard group's axis, exchanged in one shot through peer memory;
// the result lands on every member.
//
// Replaces the Pallas kernel `ring_winner_exchange` in
// armada_tpu/ops/pallas_kernels.py (loop at :532-563, `pallas_call` :566),
// where each of n - 1 steps DMAs the running best to the right neighbour
// with `make_async_remote_copy` and waits on a semaphore.
//
// What it computes, exactly the reference loop: there the running best
// starts as the member's own row, and each step hands member i the running
// best of member i - 1, which replaces the held row, gid column included,
// only if it is strictly less, lexicographically over columns 0..w-2
// (column 0, notfound, most significant; the gid is not compared). Unrolled,
// member i ends with its own row folded with rows i - 1, i - 2, ...,
// i - n + 1 (mod n), in that order, each replacing the held row only if
// strictly less: after s steps the ring's best of member i is the minimum
// over rows i..i-s, and on a tie its own row, else the nearest in that
// order, which is what the fold keeps. So on a tie a member keeps the row
// it holds, and when every row is not-found each member ends with its own
// gid (winner_reduce keeps row 0 there instead). ops/kernels.py
// `ring_oneshot_simulate` is this fold on the CPU, held to the loop.
//
// Peer memory: each member owns one buffer, allocated here with cudaMalloc
// (an IPC handle names a whole allocation) and opened by every other member
// with cudaIpcOpenMemHandle: on another card over NVLink, or on the same
// card from another process. cudaIpcOpenMemHandle refuses a handle that
// the calling process exported, so a member reaches its own buffer by its
// own pointer; its own row never leaves its registers. Layout, in 32-bit
// words:
//   slots: [2 parities][n][w]  member j's row in slot j
//   flags: [2 parities][n]     the epoch whose slot j has landed
// Call e (a per-buffer counter from 1, so the buffer is never reset) uses
// parity e & 1. Member i stores its row into slot (e & 1, i) of every
// peer's buffer, then, after a system fence, publishes flag (e & 1, i) of
// every peer as e with a system-scope release. It then waits, in one
// bounded spin with a system-scope acquire per peer (lane j spins on flag
// j), until its own n - 1 flags read e; lane j then reads slot j into
// shared memory, and the warp folds the n rows in the order above, a lane
// per column. Two parities suffice: a member finishes call e + 1 only after
// every peer has written its row of call e + 1, and a peer writes that row
// only after its own call e has ended, so after it read its parity-e slots;
// the stores of call e + 2 into a member's parity-e slots therefore follow
// that member's reads of call e.
//
// The spin cannot hang: it reads %globaltimer and gives up after
// timeout_ns, writing the lowest missing member + 1 into out[w] (0 on
// success); the wrapper reads that word with the result and raises. Several
// processes on one card without MPS time-slice it, so a spinning member
// waits for the others' contexts to get their slices: the call costs the
// slices until every row has landed, not a chain of one per step.
//
// Bound on the H100: latency. A member moves (n - 1) * w * 4 bytes out and
// as many in (60 each at n = 4, K = 3) and compares a few words per row;
// the time is one flag round trip (the ring took n - 1 serial ones). One
// warp per member, n <= 32 and w <= 32.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

constexpr int kMaxMembers = 32;
constexpr int kMaxWidth = 32;

// Every member's buffer as this process maps it, this member's own at its
// index; passed by value (ops/kernels.py _RingPeersC mirrors it).
struct RingPeers {
  int32_t* buf[kMaxMembers];
};

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

// One warp. row int32[w] is this member's tuple, me its index on the axis
// of n members; out int32[w + 1] gets the result and the status word.
__global__ void ring_exchange_kernel(const int32_t* __restrict__ row, int w,
                                     int n, int me, RingPeers peers,
                                     unsigned epoch, long long timeout_ns,
                                     int32_t* __restrict__ out) {
  __shared__ int32_t rows[kMaxMembers][kMaxWidth];
  const int lane = threadIdx.x;
  const bool col = lane < w;
  const bool compared = lane < w - 1;
  const int parity = static_cast<int>(epoch & 1u);
  const int32_t own = col ? row[lane] : 0;
  int32_t status = 0;
  if (n > 1) {
    // Store this member's row into its slot of every peer's buffer, a lane
    // per column, then publish the flags after one system fence.
    for (int j = 0; j < n; ++j) {
      if (j != me && col) {
        st_relaxed_sys(peers.buf[j] + (parity * n + me) * w + lane, own);
      }
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence_system();
      for (int j = 0; j < n; ++j) {
        if (j != me) {
          unsigned* flags = reinterpret_cast<unsigned*>(peers.buf[j] + 2 * n * w);
          st_release_sys(flags + parity * n + me, epoch);
        }
      }
    }
    // The one wait: lane j acquires flag j of this member's buffer.
    const unsigned* flags =
        reinterpret_cast<const unsigned*>(peers.buf[me] + 2 * n * w) + parity * n;
    bool arrived = lane >= n || lane == me;
    const unsigned long long start = global_ns();
    while (true) {
      if (!arrived) arrived = ld_acquire_sys(flags + lane) == epoch;
      if (__all_sync(kFull, arrived)) break;
      const bool late =
          global_ns() - start > static_cast<unsigned long long>(timeout_ns);
      if (__any_sync(kFull, late)) break;  // uniform across the warp
      __nanosleep(64);
    }
    const unsigned missing = __ballot_sync(kFull, !arrived);
    if (missing != 0) {
      status = __ffs(missing);
    } else {
      // Lane j read flag j, so it reads slot j.
      if (lane < n && lane != me) {
        const int32_t* slot = peers.buf[me] + (parity * n + lane) * w;
        for (int c = 0; c < w; ++c) rows[lane][c] = ld_relaxed_sys(slot + c);
      }
      __syncwarp();
    }
  }
  int32_t best = own;
  if (status == 0) {
    // Fold rows me - 1, me - 2, ..., me - n + 1 (mod n) into the own row.
    for (int s = 1; s < n; ++s) {
      const int j = (me - s + n) % n;
      const int32_t cand = col ? rows[j][lane] : 0;
      const unsigned differ = __ballot_sync(kFull, compared && cand != best);
      const unsigned less = __ballot_sync(kFull, compared && cand < best);
      // The first differing column decides; equal tuples keep the held row.
      if (differ != 0 && ((less >> (__ffs(differ) - 1)) & 1u)) best = cand;
    }
  }
  if (col) out[lane] = best;
  if (lane == 0) out[w] = status;
}

}  // namespace

// Bytes of one member's buffer for an axis of n members and rows of w
// words (0 when n == 1: that exchange moves nothing).
extern "C" long long armada_ring_bytes(int n, int w) {
  if (n <= 1) return 0;
  return 2LL * n * (w + 1) * static_cast<long long>(sizeof(int32_t));
}

// Allocate and zero a buffer of `bytes` on `device` and export it: *ptr
// gets the device pointer, handle (64 bytes) its cudaIpcMemHandle_t.
extern "C" int armada_ring_alloc(int device, long long bytes, void** ptr,
                                 void* handle) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  // The zeroes must be in place before a peer's first write, which follows
  // the handle exchange.
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

// row int32[w] and out int32[w + 1] on the device, 2 <= w <= 32; peers
// holds every member's buffer as armada_ring_alloc (this member's, at index
// me) and armada_ring_open (the others') gave them, unused when n == 1;
// 1 <= n <= 32. Launches one warp on `stream` and returns
// cudaGetLastError().
extern "C" int armada_ring_exchange(const void* row, int w, int n, int me,
                                    RingPeers peers, unsigned epoch,
                                    long long timeout_ns, void* out,
                                    void* stream) {
  if (w < 2 || w > kMaxWidth || n < 1 || n > kMaxMembers || me < 0 || me >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; n > 1 && j < n; ++j) {
    if (peers.buf[j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  ring_exchange_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row), w, n, me, peers, epoch, timeout_ns,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
