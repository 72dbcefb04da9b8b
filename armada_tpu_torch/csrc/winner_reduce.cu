// winner_reduce: the lexicographic minimum of the gathered per-host winner
// tuples of one candidate selection on a (hosts, chips) mesh.
//
// Replaces the Pallas kernel `_winner_kernel` in
// armada_tpu/ops/pallas_kernels.py, launched there by `winner_reduce`
// from PallasHierarchicalDist.lex_argmin_nodes (solver/dist_pallas.py)
// once per select, after the host-axis all_gather.
//
// rows is int32[P, W] row-major, W = K + 2: (notfound, keys..., gid) per
// host, P the host count rounded up to a power of two (pad rows are
// not-found rows with sentinel keys). out is int32[W], the row whose
// columns 0..W-2 are lexicographically smallest; the gid column is carried,
// not compared. On a tie the lower row index wins. The reference's halving
// tree keeps the left row on a tie; ties occur only between not-found rows,
// whose compared columns are all equal, because the last key is the
// globally unique node rank. So both keep row 0 when no host found a node,
// and both pick the unique found minimum otherwise.
//
// Bound on the H100: neither bytes nor operations. The work is P * W
// int32 reads (64 bytes at the round's P = 2, K = 3) and a few compares, so
// a call costs one launch. The design carries row indices, not rows: each
// thread takes rows threadIdx.x, threadIdx.x + blockDim.x, ... in index
// order, then the warp combines by shuffles and, when P > 32, the warps
// combine through shared memory. Every combine compares (columns, row
// index), so the result does not depend on how the reduction associates.
// One block of at most 1024 threads; P <= 32 is a single warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// True when row a precedes row b: columns 0..w-2 lexicographically, then
// the lower row index.
__device__ __forceinline__ bool row_less(const int32_t* __restrict__ rows,
                                         int w, int a, int b) {
  const int32_t* ra = rows + static_cast<int64_t>(a) * w;
  const int32_t* rb = rows + static_cast<int64_t>(b) * w;
  for (int c = 0; c < w - 1; ++c) {
    const int32_t x = __ldg(ra + c);
    const int32_t y = __ldg(rb + c);
    if (x != y) return x < y;
  }
  return a < b;
}

// The best row index over the 32 lanes of a warp (-1 for none); every lane
// of the warp must take part.
__device__ __forceinline__ int warp_best(const int32_t* __restrict__ rows,
                                         int w, int best) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const int other = __shfl_down_sync(0xffffffffu, best, offset);
    if (other >= 0 && (best < 0 || row_less(rows, w, other, best))) best = other;
  }
  return best;
}

__global__ void winner_reduce_kernel(const int32_t* __restrict__ rows, int p,
                                     int w, int32_t* __restrict__ out) {
  __shared__ int per_warp[32];
  int best = -1;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    if (best < 0 || row_less(rows, w, i, best)) best = i;
  }
  best = warp_best(rows, w, best);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (n_warps > 1) {  // uniform across the block
    if (lane == 0) per_warp[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < n_warps ? per_warp[lane] : -1;
      best = warp_best(rows, w, best);
    }
  }
  if (threadIdx.x == 0) {
    const int32_t* win = rows + static_cast<int64_t>(best) * w;
    for (int c = 0; c < w; ++c) out[c] = win[c];
  }
}

}  // namespace

// rows int32[p, w] and out int32[w] on the device; 1 <= p <= 1024, w >= 2.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int armada_winner_reduce(const void* rows, int p, int w, void* out,
                                    void* stream) {
  if (p < 1 || p > 1024 || w < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((p + 31) / 32) * 32;
  winner_reduce_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), p, w, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
