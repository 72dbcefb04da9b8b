// segment_add: out = x.index_add(dim, index, values), or the same sum into
// zeros (a segment sum), for int32 or int64 tensors, in one kernel launch
// chosen on the host.
//
// Replaces the integer `jax.ops.segment_sum` calls of the reference's round
// (armada_tpu/solver/kernel.py: the fill loop's per-queue and per-group
// counts :1113, :1506, the eviction sums :1782, :1791, the running
// allocation :1965; solver/dist.py's node sums :168, :262), which XLA
// lowers to a scatter-add. Torch's own CUDA `index_add` sends every call
// through a sort while its process-wide deterministic switch is on, as it
// is for the round's float sums, and the switch cannot be turned off
// around one call without changing what other threads' float scatters do.
// An integer sum does not depend on the order of its terms, so every
// strategy below gives the same bits as any order: exact and deterministic,
// and it never reads the switch. Sums wrap in the type's width, as
// index_add's do; an index outside [0, n) adds nothing; a value of 0 may be
// skipped.
//
// The caller (ops/kernels.py) views out and x as [outer, n, inner] around
// the summed dimension and values as [outer, k, inner], passes index
// int64[k], allocates out uninitialised, and picks the strategy, its grid
// and whether out is filled first with `segment_plan` (a plain Python
// function, so that the choice is tested on the CPU); the limits of each
// strategy live there too, and a launch this file cannot make (shared
// memory past the card's) returns the card's error:
//
// - rows: the direct path, for sums over many segments with few values
//   each (job rows into nodes, a fill's rows, queue counts). A thread takes
//   one (o, j) row: it reads index[j] once and all `inner` lanes of the
//   row, as 16-byte vectors where the row is a multiple of 16 bytes, two
//   rows in flight a lane. Within a warp, __ballot_sync drops rows that
//   are all zero or out of range, and where some row's destination repeats
//   its neighbour's (sorted or clustered indices), __match_any_sync groups
//   the rows that share a destination and each group of several is summed
//   by warp reductions into its leader. At 4 lanes (the round's R) the
//   warp's adds then pass through shared memory, so that one atomic
//   instruction covers 8 whole rows, their lanes adjacent: one L2 request
//   a row, not one a lane.
// - shared: privatised accumulation, for outputs that fit one CTA's shared
//   memory and are far outnumbered by the values (the setup's class and
//   queue sums, every row into one segment). Each CTA sums its rows into
//   its own copy in shared memory, with the same warp aggregation before
//   the shared atomics, then adds its nonzero entries to out, one global
//   atomic each.
// - gather: the copy-add gather, for an add of a few rows (a gang bind's
//   one node column, the rescue pass's rebinds): the index and the values
//   (the contributions) are staged in shared memory, and each output
//   element is written once as x (or 0) plus the contributions at its
//   index. No atomics and no separate copy.
//
// Rows and shared add into an output filled first on the stream
// (cudaMemsetAsync for a segment sum, cudaMemcpyAsync from x for an
// index_add), as the caller's `init` says. Index arithmetic is 32-bit when
// every offset is below 2^31 (all of the round's sums); a 64-bit
// instantiation serves larger ones, chosen on the host, never per element.
// Each launch is checked with cudaGetLastError; nothing falls back.
//
// Bound on the H100: bytes (each input read once, the output written once)
// at the round's sizes; below some thousands of values the launch. The
// rows path's atomics on distinct addresses cost about what the bytes do;
// same-address atomics serialise in L2, which the warp aggregation and the
// privatised strategy take off the contention cases.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 256;
constexpr int kSharedThreads = 1024;
constexpr int kGatherThreads = 256;
constexpr int kDepth = 2;  // rows a lane loads before it adds any

enum Strategy { kRows = 0, kShared = 1, kGather = 2 };

// ---------------------------------------------------------------------------
// Adds that wrap: atomics on the unsigned pattern, sums in unsigned types.

__device__ __forceinline__ void atomic_add(int32_t* dst, int32_t v) {
  atomicAdd(reinterpret_cast<unsigned*>(dst), static_cast<unsigned>(v));
}

__device__ __forceinline__ void atomic_add(int64_t* dst, int64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(dst), static_cast<unsigned long long>(v));
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int64_t wrap_add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<unsigned long long>(a) +
                              static_cast<unsigned long long>(b));
}

// The sum of v over the lanes of `mask`, every lane of which calls it.
__device__ __forceinline__ int32_t warp_sum(unsigned mask, int32_t v) {
  return static_cast<int32_t>(__reduce_add_sync(mask, static_cast<unsigned>(v)));
}

// 64 bits from three 32-bit reductions: the low word as two 16-bit halves
// (at most 32 x 65,535 each, exact), the high word modulo 2^32, which is
// all the sum modulo 2^64 needs of it.
__device__ __forceinline__ int64_t warp_sum(unsigned mask, int64_t v) {
  const unsigned long long u = static_cast<unsigned long long>(v);
  const unsigned lo = static_cast<unsigned>(u);
  const unsigned long long a = __reduce_add_sync(mask, lo & 0xffffu);
  const unsigned long long b = __reduce_add_sync(mask, lo >> 16);
  const unsigned long long c = __reduce_add_sync(mask, static_cast<unsigned>(u >> 32));
  return static_cast<int64_t>((c << 32) + (b << 16) + a);
}

// Read-only loads (int64_t is `long` here, which __ldg does not overload)
// and 16-byte vectors taken apart and put together in registers.
__device__ __forceinline__ int32_t ld(const int32_t* p) { return __ldg(p); }

__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

__device__ __forceinline__ void unpack(const int4& w, int32_t* v) {
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}

__device__ __forceinline__ int64_t join(int lo, int hi) {
  return static_cast<int64_t>((static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) |
                              static_cast<unsigned>(lo));
}

__device__ __forceinline__ void unpack(const int4& w, int64_t* v) {
  v[0] = join(w.x, w.y);
  v[1] = join(w.z, w.w);
}

__device__ __forceinline__ int4 pack(const int32_t* v) { return make_int4(v[0], v[1], v[2], v[3]); }

__device__ __forceinline__ int4 pack(const int64_t* v) {
  const unsigned long long a = static_cast<unsigned long long>(v[0]);
  const unsigned long long b = static_cast<unsigned long long>(v[1]);
  return make_int4(static_cast<int>(a), static_cast<int>(a >> 32), static_cast<int>(b),
                   static_cast<int>(b >> 32));
}

// ---------------------------------------------------------------------------
// Destinations of the aggregated adds.

template <typename T, typename I>
struct GlobalSink {
  T* out;
  __device__ __forceinline__ void add(I e, T v) const { atomic_add(out + e, v); }
};

// Adds into shared memory. A 64-bit add is two native
// 32-bit atomics, the low word's carry added to the high word (the words
// are read only after a barrier), where a 64-bit shared atomic would be a
// compare-and-swap loop.
__device__ __forceinline__ void shared_add(int32_t* dst, int32_t v) { atomic_add(dst, v); }

__device__ __forceinline__ void shared_add(int64_t* dst, int64_t v) {
  unsigned* w = reinterpret_cast<unsigned*>(dst);
  const unsigned long long u = static_cast<unsigned long long>(v);
  const unsigned lo = static_cast<unsigned>(u);
  unsigned hi = static_cast<unsigned>(u >> 32);
  if (lo != 0) {
    const unsigned old = atomicAdd(w, lo);
    hi += old + lo < old ? 1u : 0u;
  }
  if (hi != 0) atomicAdd(w + 1, hi);
}

template <typename T, typename I>
struct LocalSink {  // this CTA's copy of every entry
  T* acc;
  __device__ __forceinline__ void add(I e, T v) const { shared_add(acc + e, v); }
};

// ---------------------------------------------------------------------------
// One warp's rows: row r = r0 + lane of [outer * k], its destination row
// key = o * n + index[j] of [outer * n], its lanes' values v.

template <typename T, int kLanes>
struct RowValues {
  T v[kLanes > 0 ? kLanes : 1];
};

// Load row r's kLanes values; as 16-byte vectors when the row is a
// multiple of 16 bytes and values is 16-byte aligned (`vec`).
template <typename T, int kLanes, typename I>
__device__ __forceinline__ void load_row(const T* __restrict__ values, I r, bool vec,
                                         RowValues<T, kLanes>& row) {
  const T* p = values + r * static_cast<I>(kLanes);
  if constexpr ((kLanes * sizeof(T)) % 16 == 0) {
    if (vec) {
      const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
      for (int c = 0; c < static_cast<int>(kLanes * sizeof(T) / 16); ++c) {
        unpack(__ldg(q + c), row.v + c * static_cast<int>(16 / sizeof(T)));
      }
      return;
    }
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l) row.v[l] = ld(p + l);
}

// One lane's row: r, its destination row `key` = o * n + index[j] of
// [outer * n], whether it adds anything, and (kLanes > 0) its values.
template <typename T, typename I, int kLanes>
struct RowLoad {
  bool active;
  I key;
  I r;
  RowValues<T, kLanes> row;
};

// Issue row r's loads: index[j] and the values, neither waiting on the
// other.
template <typename T, typename I, int kLanes>
__device__ __forceinline__ void load_one(const long long* __restrict__ index,
                                         const T* __restrict__ values, I n, I k, I rows, I r,
                                         bool vec, RowLoad<T, I, kLanes>& x) {
  x.r = r;
  x.active = r < rows;
  x.key = 0;
  x.row = RowValues<T, kLanes>{};
  if (x.active) {
    const I j = rows == k ? r : r % k;
    const I o = rows == k ? I(0) : r / k;
    const long long d = __ldg(index + j);
    if constexpr (kLanes > 0) load_row<T, kLanes>(values, r, vec, x.row);
    x.active = d >= 0 && d < static_cast<long long>(n);
    x.key = o * n + static_cast<I>(d);
  }
}

// Add one warp's rows to `sink`, every lane of the warp calling it. Rows
// that share a destination are summed by warp reductions into their
// lowest lane (the group's leader). With kLanes == 4 the adds then go
// through the warp's stage in shared memory, so that one atomic
// instruction covers 8 whole rows, each row's 4 lanes adjacent, where a
// lane a row would spread every row over 4 instructions and 4 requests.
template <typename T, typename I, int kLanes, typename Sink>
__device__ __forceinline__ void warp_add(RowLoad<T, I, kLanes>& x, const T* __restrict__ values,
                                         I inner, T* stage_v, I* stage_k, const Sink& sink) {
  bool active = x.active;
  if constexpr (kLanes > 0) {
    if (active) {
      bool any = false;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) any |= x.row.v[l] != 0;
      active = any;
    }
  }
  const unsigned act = __ballot_sync(kFull, active);
  if (act == 0) return;
  const unsigned lane = threadIdx.x & 31u;
  // Aggregate only where some lane's destination repeats its neighbour's
  // (sorted and clustered indices); elsewhere every row adds itself, and
  // __match_any_sync, the costliest step, is skipped. Either way is exact.
  const I prev = __shfl_up_sync(kFull, x.key, 1);
  const bool prev_active = lane > 0 && ((act >> (lane - 1)) & 1u) != 0;
  const bool runs = __any_sync(kFull, active && prev_active && prev == x.key);
  bool emit = false;
  if (active && !runs) {
    emit = true;
    if constexpr (kLanes == 0) {
      for (I l = 0; l < inner; ++l) {
        const T v = ld(values + x.r * inner + l);
        if (v != 0) sink.add(x.key * inner + l, v);
      }
    }
  } else if (active) {
    const unsigned peers = __match_any_sync(act, x.key);
    const bool alone = peers == (1u << lane);
    emit = alone;
    if constexpr (kLanes == 0) {
      if (alone) {
        for (I l = 0; l < inner; ++l) {
          const T v = ld(values + x.r * inner + l);
          if (v != 0) sink.add(x.key * inner + l, v);
        }
      }
    }
    // Groups of several, one at a time.
    unsigned todo = __ballot_sync(act, !alone);
    while (todo) {
      const int leader = __ffs(todo) - 1;
      const I lead_key = __shfl_sync(act, x.key, leader);
      const bool mine = x.key == lead_key;
      const bool lead = lane == static_cast<unsigned>(leader);
      if constexpr (kLanes > 0) {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          const T s = warp_sum(act, mine ? x.row.v[l] : T(0));
          if (lead) x.row.v[l] = s;
        }
      } else {
        for (I l = 0; l < inner; ++l) {
          const T s = warp_sum(act, mine ? ld(values + x.r * inner + l) : T(0));
          if (lead && s != 0) sink.add(lead_key * inner + l, s);
        }
      }
      emit |= lead;
      todo &= ~__ballot_sync(act, mine);
    }
  }
  if constexpr (kLanes == 4) {
    constexpr I kNone = ~I(0);
    __syncwarp();  // the stage's last readers are done
    T* sv = stage_v + (threadIdx.x >> 5) * 128;
    I* sk = stage_k + (threadIdx.x >> 5) * 32;
    int4* dst = reinterpret_cast<int4*>(sv + lane * 4);
    if constexpr (sizeof(T) == 4) {
      dst[0] = pack(x.row.v);
    } else {
      dst[0] = pack(x.row.v);
      dst[1] = pack(x.row.v + 2);
    }
    sk[lane] = emit ? x.key : kNone;
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned src = t * 8 + (lane >> 2);
      const I key = sk[src];
      if (key != kNone) {
        const T v = sv[src * 4 + (lane & 3u)];
        if (v != 0) sink.add(key * 4 + (lane & 3u), v);
      }
    }
  } else if constexpr (kLanes > 0) {
    if (emit) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        if (x.row.v[l] != 0) sink.add(x.key * kLanes + l, x.row.v[l]);
      }
    }
  }
}

// Every row of [outer * k] in a grid-stride loop over warps, kDepth rows a
// lane loaded before any is added; the loop's bounds are the same for all
// lanes of a warp.
template <typename T, typename I, int kLanes, typename Sink>
__device__ __forceinline__ void add_rows(const long long* __restrict__ index,
                                         const T* __restrict__ values, I n, I k, I inner, I rows,
                                         bool vec, T* stage_v, I* stage_k, const Sink& sink) {
  const unsigned lane = threadIdx.x & 31u;
  const I warps_per_block = static_cast<I>(blockDim.x >> 5);
  const I warp = static_cast<I>(blockIdx.x) * warps_per_block + static_cast<I>(threadIdx.x >> 5);
  const I stride = static_cast<I>(gridDim.x) * warps_per_block * 32;
  for (I r0 = warp * 32; r0 < rows; r0 += stride * kDepth) {
    RowLoad<T, I, kLanes> x[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      load_one<T, I, kLanes>(index, values, n, k, rows, r0 + d * stride + lane, vec, x[d]);
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) warp_add<T, I, kLanes>(x[d], values, inner, stage_v, stage_k, sink);
  }
}

// ---------------------------------------------------------------------------
// Kernels.

template <typename T, typename I, int kLanes>
__global__ void __launch_bounds__(kRowThreads)
    segment_rows_kernel(T* __restrict__ out, const long long* __restrict__ index,
                        const T* __restrict__ values, I n, I k, I inner, I rows, int vec) {
  constexpr int kStage = kLanes == 4 ? kRowThreads / 32 : 0;
  __shared__ __align__(16) T stage_v[kStage * 128 + 1];
  __shared__ I stage_k[kStage * 32 + 1];
  add_rows<T, I, kLanes>(index, values, n, k, inner, rows, vec != 0, stage_v, stage_k,
                         GlobalSink<T, I>{out});
}

// Each CTA sums its share of the rows into its copy of every entry, then
// adds the nonzero ones to out.
template <typename T, typename I, int kLanes>
__global__ void __launch_bounds__(kSharedThreads)
    segment_shared_kernel(T* __restrict__ out, const long long* __restrict__ index,
                          const T* __restrict__ values, I n, I k, I inner, I rows, I entries,
                          int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);
  constexpr int kStage = kLanes == 4 ? kSharedThreads / 32 : 0;
  __shared__ __align__(16) T stage_v[kStage * 128 + 1];
  __shared__ I stage_k[kStage * 32 + 1];
  for (I e = threadIdx.x; e < entries; e += blockDim.x) acc[e] = 0;
  __syncthreads();
  add_rows<T, I, kLanes>(index, values, n, k, inner, rows, vec != 0, stage_v, stage_k,
                         LocalSink<T, I>{acc});
  __syncthreads();
  for (I e = threadIdx.x; e < entries; e += blockDim.x) {
    const T a = acc[e];
    if (a != 0) atomic_add(out + e, a);
  }
}

// Each thread writes V consecutive entries (one 16-byte vector when `vec`).
// Shared memory holds the k indices, then the outer * k * inner values.
template <typename T, typename I>
__global__ void __launch_bounds__(kGatherThreads)
    segment_gather_kernel(T* __restrict__ out, const T* __restrict__ x,
                          const long long* __restrict__ index, const T* __restrict__ values, I n,
                          I k, I inner, I entries, int vec) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  long long* sidx = reinterpret_cast<long long*>(smem);
  T* svals = reinterpret_cast<T*>(sidx + k);
  const I nvals = entries / n * k;  // outer * k * inner
  for (I i = threadIdx.x; i < k; i += blockDim.x) sidx[i] = index[i];
  for (I i = threadIdx.x; i < nvals; i += blockDim.x) svals[i] = ld(values + i);
  __syncthreads();
  const I stride = static_cast<I>(gridDim.x) * blockDim.x * V;
  for (I e0 = (static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x) * V; e0 < entries;
       e0 += stride) {
    T acc[V];
    const bool whole = vec && e0 + V <= entries;
    if (whole) {
      if (x != nullptr) {
        unpack(__ldg(reinterpret_cast<const int4*>(x + e0)), acc);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = (x != nullptr && e0 + i < entries) ? ld(x + e0 + i) : T(0);
    }
    // (o, m, l) of e0, then stepped lane by lane.
    I l = e0 % inner;
    I row = e0 / inner;
    I m = row % n;
    I o = row / n;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      for (I j = 0; j < k && e0 + i < entries; ++j) {
        if (sidx[j] == static_cast<long long>(m)) acc[i] = wrap_add(acc[i], svals[(o * k + j) * inner + l]);
      }
      if (++l == inner) {
        l = 0;
        if (++m == n) {
          m = 0;
          ++o;
        }
      }
    }
    if (whole) {
      *reinterpret_cast<int4*>(out + e0) = pack(acc);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (e0 + i < entries) out[e0 + i] = acc[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

struct Args {
  void* out;
  const void* x;
  const long long* index;
  const void* values;
  long long outer, n, k, inner;
  int grid;
  cudaStream_t stream;
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Opt `kernel` in to `bytes` of dynamic shared memory where that passes
// the 48 KB default; the card refuses what it cannot hold.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, typename I, int kLanes>
cudaError_t launch_rows(const Args& a) {
  const bool vec = aligned16(a.values);
  segment_rows_kernel<T, I, kLanes><<<a.grid, kRowThreads, 0, a.stream>>>(
      static_cast<T*>(a.out), a.index, static_cast<const T*>(a.values), static_cast<I>(a.n),
      static_cast<I>(a.k), static_cast<I>(a.inner), static_cast<I>(a.outer * a.k), vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, typename I, int kLanes>
cudaError_t launch_shared(const Args& a) {
  const long long entries = a.outer * a.n * a.inner;
  const long long smem = entries * static_cast<long long>(sizeof(T));
  auto kernel = segment_shared_kernel<T, I, kLanes>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid, kSharedThreads, static_cast<size_t>(smem), a.stream>>>(
      static_cast<T*>(a.out), a.index, static_cast<const T*>(a.values), static_cast<I>(a.n),
      static_cast<I>(a.k), static_cast<I>(a.inner), static_cast<I>(a.outer * a.k),
      static_cast<I>(entries), aligned16(a.values) ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_gather(const Args& a) {
  const long long smem = a.k * static_cast<long long>(sizeof(long long)) +
                         a.outer * a.k * a.inner * static_cast<long long>(sizeof(T));
  auto kernel = segment_gather_kernel<T, I>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(a.out) && (a.x == nullptr || aligned16(a.x));
  kernel<<<a.grid, kGatherThreads, static_cast<size_t>(smem), a.stream>>>(
      static_cast<T*>(a.out), static_cast<const T*>(a.x), a.index,
      static_cast<const T*>(a.values), static_cast<I>(a.n), static_cast<I>(a.k),
      static_cast<I>(a.inner), static_cast<I>(a.outer * a.n * a.inner), vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, typename I, int kLanes>
cudaError_t launch_lanes(const Args& a, int strategy) {
  return strategy == kRows ? launch_rows<T, I, kLanes>(a) : launch_shared<T, I, kLanes>(a);
}

template <typename T, typename I>
cudaError_t launch(const Args& a, int strategy) {
  if (strategy == kGather) return launch_gather<T, I>(a);
  if (a.inner == 1) return launch_lanes<T, I, 1>(a, strategy);
  if (a.inner == 4) return launch_lanes<T, I, 4>(a, strategy);
  return launch_lanes<T, I, 0>(a, strategy);
}

}  // namespace

// out = x.index_add over [outer, n, inner] (x NULL: a segment sum into
// zeros) by `strategy` (0 rows, 1 shared, 2 gather) on `grid` CTAs, with
// 32-bit index arithmetic unless `wide`. out is uninitialised; with `init`
// it is first filled on the stream (a memset, or a copy of x). Returns a
// cudaError_t; an empty sum launches nothing.
extern "C" int armada_segment_add(void* out, const void* x, const void* index,
                                  const void* values, int elem_bytes, long long outer,
                                  long long n, long long k, long long inner, int strategy,
                                  int grid, int init, int wide, void* stream) {
  if ((elem_bytes != 4 && elem_bytes != 8) || outer < 0 || n < 1 || k < 0 || inner < 0 ||
      strategy < kRows || strategy > kGather || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long entries = outer * n * inner;
  const long long most = entries > outer * k * inner ? entries : outer * k * inner;
  if (!wide && most >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(entries) * elem_bytes;
  if (init && bytes > 0) {
    const cudaError_t err = x != nullptr
                                ? cudaMemcpyAsync(out, x, bytes, cudaMemcpyDeviceToDevice, s)
                                : cudaMemsetAsync(out, 0, bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (outer == 0 || k == 0 || inner == 0) return static_cast<int>(cudaGetLastError());
  const Args a{out, x, static_cast<const long long*>(index), values, outer, n, k, inner, grid, s};
  cudaError_t err;
  if (elem_bytes == 4) {
    err = wide ? launch<int32_t, unsigned long long>(a, strategy) : launch<int32_t, unsigned>(a, strategy);
  } else {
    err = wide ? launch<int64_t, unsigned long long>(a, strategy) : launch<int64_t, unsigned>(a, strategy);
  }
  return static_cast<int>(err);
}
