// fill_take: indices of the B smallest packed int64 keys, in stable-sort
// order (equal keys keep index order), with their keys.
//
// Replaces armada_tpu/ops/pallas_kernels.py::fill_take (a lax top-B
// selection that the reference's fused kernel path sends every fill sort
// through, via fill_sort_path and solver/dist.py::_fill_sort). The result
// equals a stable ascending sort's first min(B, N) entries, including the
// masked sentinel tail when fewer than B keys are real, duplicate keys,
// and B > N.
//
// Bound on the H100: bytes. The least work reads the N keys once and
// writes min(B, N) indices and keys. This first design is one thread block
// per call and reads the keys 8 + 1 times from L2 (the node axis is at most
// 64k keys, 512 KB, which stays in the 50 MB L2 between passes), so it is
// bound by one SM's load rate and its barriers rather than by HBM:
//   1. radix select: 8 passes over the keys, one per byte from the top,
//      each building a 256-bin shared histogram of the keys that share the
//      prefix chosen so far (warp-aggregated atomics, since packed keys
//      share their top bytes), which pins the exact B-th smallest key T
//      and how many keys equal to T the first B entries hold;
//   2. compaction: one pass in index order with two block-wide scans per
//      tile, keeping every key < T and the first-index keys == T, into
//      shared memory;
//   3. a bitonic sort of the <= 2048 survivors by (key, index) in shared
//      memory (2048 x 12 B).
// Keys are compared as unsigned after flipping the sign bit, so any int64
// orders as the signed value does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTake = 2048;
constexpr uint64_t kSign = 0x8000000000000000ull;

// Exclusive prefix sum of `v` over the block (in thread order); the block
// total lands in *total. Ends on a barrier, so scratch can be reused.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
    if (lane == n_warps - 1) *total = s;
  }
  __syncthreads();
  const int excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(kThreads)
fill_take_kernel(const int64_t* __restrict__ key, int n, int want,
                 int32_t* __restrict__ take, int64_t* __restrict__ take_key) {
  __shared__ unsigned int hist[256];
  __shared__ uint64_t s_key[kMaxTake];
  __shared__ int32_t s_idx[kMaxTake];
  __shared__ int warp_sums[32];
  __shared__ int s_total;
  __shared__ uint64_t s_prefix;
  __shared__ int s_rank;

  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_prefix = 0;
    s_rank = want;
  }
  // 1. Radix select of the want-th smallest key, one byte per pass.
  uint64_t mask = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    const uint64_t prefix = s_prefix;
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + threadIdx.x;
      unsigned int digit = 256;  // no bin
      if (i < n) {
        const uint64_t u = static_cast<uint64_t>(key[i]) ^ kSign;
        if ((u & mask) == prefix) digit = static_cast<unsigned int>((u >> shift) & 255u);
      }
      const unsigned int peers = __match_any_sync(0xffffffffu, digit);
      if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned int k = static_cast<unsigned int>(s_rank);
      unsigned int cum = 0;
      int d = 0;
      for (; d < 255; ++d) {
        if (cum + hist[d] >= k) break;
        cum += hist[d];
      }
      s_rank = static_cast<int>(k - cum);
      s_prefix = prefix | (static_cast<uint64_t>(d) << shift);
    }
    mask |= static_cast<uint64_t>(255) << shift;
    __syncthreads();
  }
  const uint64_t thr = s_prefix;  // the want-th smallest key
  const int need_eq = s_rank;     // keys == thr among the first want

  // 2. Compaction in index order: every key < thr, the first need_eq == thr.
  int eq_base = 0;
  int out_base = 0;
  for (int base = 0; base < n && out_base < want; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool lt = false;
    bool eq = false;
    uint64_t u = 0;
    if (i < n) {
      u = static_cast<uint64_t>(key[i]) ^ kSign;
      lt = u < thr;
      eq = u == thr;
    }
    const int eq_rank = block_exclusive_scan(eq ? 1 : 0, warp_sums, &s_total);
    const int eq_total = s_total;
    const bool keep = lt || (eq && eq_base + eq_rank < need_eq);
    const int pos = block_exclusive_scan(keep ? 1 : 0, warp_sums, &s_total);
    const int keep_total = s_total;
    if (keep) {
      s_key[out_base + pos] = u;
      s_idx[out_base + pos] = i;
    }
    eq_base += eq_total;
    out_base += keep_total;
  }

  // 3. Bitonic sort of the survivors by (key, index), padded to a power of 2.
  int p2 = 1;
  while (p2 < want) p2 <<= 1;
  for (int i = want + threadIdx.x; i < p2; i += blockDim.x) {
    s_key[i] = ~0ull;
    s_idx[i] = 0x7fffffff;
  }
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const bool gt = s_key[i] > s_key[ixj] ||
                          (s_key[i] == s_key[ixj] && s_idx[i] > s_idx[ixj]);
          if (gt == up) {
            const uint64_t tk = s_key[i];
            s_key[i] = s_key[ixj];
            s_key[ixj] = tk;
            const int32_t ti = s_idx[i];
            s_idx[i] = s_idx[ixj];
            s_idx[ixj] = ti;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < want; i += blockDim.x) {
    take[i] = s_idx[i];
    take_key[i] = static_cast<int64_t>(s_key[i] ^ kSign);
  }
}

}  // namespace

extern "C" int armada_fill_take(const void* key, int n, int want, void* take,
                                void* take_key, void* stream) {
  fill_take_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), n, want, static_cast<int32_t*>(take),
      static_cast<int64_t*>(take_key));
  return static_cast<int>(cudaGetLastError());
}
