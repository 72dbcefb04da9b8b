// segment_add: out = x.index_add(dim, index, values) for int32 or int64
// tensors, by integer atomic adds.
//
// Replaces the integer `jax.ops.segment_sum` calls of the reference's round
// (armada_tpu/solver/kernel.py: the fill loop's per-queue and per-group
// counts :1113, :1506, the eviction sums :1782, :1791, the running
// allocation :1965; solver/dist.py's node sums :168, :262), which XLA
// lowers to a scatter-add. Torch's own CUDA `index_add` sends every call
// through a sort while its process-wide deterministic switch is on, as it
// is for the round's float sums, and the switch cannot be turned off
// around one call without changing what other threads' float scatters do.
// An integer sum does not depend on the order of its terms, so atomic adds
// give the same bits as any order: this kernel is exact and deterministic
// and never reads the switch.
//
// The caller (ops/kernels.py segment_add) copies x into out, views it as
// [outer, n, inner] around the summed dimension and values as
// [outer, k, inner], and passes index int64[k]. One thread a value, in a
// grid-stride loop: a value of 0 is skipped (the round's sums are masked,
// most terms are 0), an index outside [0, n) is skipped (the callers clamp
// theirs; torch's index_add raises), every other value is added to
// out[o, index[j], i] with a 32-bit atomic add or a 64-bit one on its
// unsigned bit pattern. Both wrap in the type's width, as index_add does.
//
// Bound on the H100: bytes at the round's sizes (one read of values and
// index, one read and write of out), and latency below a few thousand
// values, where the launch costs most. Same-address atomics serialise in
// L2, which bounds a sum of many values into few segments.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

__device__ __forceinline__ void atomic_add(int32_t* dst, int32_t v) {
  atomicAdd(reinterpret_cast<int*>(dst), static_cast<int>(v));
}

__device__ __forceinline__ void atomic_add(int64_t* dst, int64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(dst),
            static_cast<unsigned long long>(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_add_kernel(T* __restrict__ out, const int64_t* __restrict__ index,
                       const T* __restrict__ values, long long n, long long k,
                       long long inner, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const T v = values[e];
    if (v == 0) continue;
    const long long i = e % inner;
    const long long row = e / inner;
    const long long j = row % k;
    const long long o = row / k;
    const long long dst = __ldg(index + j);
    if (dst < 0 || dst >= n) continue;
    atomic_add(out + (o * n + dst) * inner + i, v);
  }
}

template <typename T>
void launch(void* out, const void* index, const void* values, long long outer,
            long long n, long long k, long long inner, cudaStream_t stream) {
  const long long total = outer * k * inner;
  const long long blocks = (total + kThreads - 1) / kThreads;
  segment_add_kernel<T><<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                          kThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const int64_t*>(index),
      static_cast<const T*>(values), n, k, inner, total);
}

}  // namespace

// elem_bytes is 4 (int32) or 8 (int64); out holds x already. Returns a
// cudaError_t; an empty sum launches nothing.
extern "C" int armada_segment_add(void* out, const void* index, const void* values,
                                  int elem_bytes, long long outer, long long n,
                                  long long k, long long inner, void* stream) {
  if ((elem_bytes != 4 && elem_bytes != 8) || outer < 0 || n < 1 || k < 0 || inner < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (outer == 0 || k == 0 || inner == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    launch<int32_t>(out, index, values, outer, n, k, inner, s);
  } else {
    launch<int64_t>(out, index, values, outer, n, k, inner, s);
  }
  return static_cast<int>(cudaGetLastError());
}
