// winner_reduce: the lexicographic minimum of gathered winner tuples, one
// per member of a mesh axis. It closes both stages of a candidate selection
// of the node-sharded round on a (hosts, chips) mesh.
//
// Replaces the Pallas kernel `_winner_kernel` in
// armada_tpu/ops/pallas_kernels.py, launched there by `winner_reduce` from
// PallasHierarchicalDist.lex_argmin_nodes (solver/dist_pallas.py) once per
// select, after the host-axis all_gather. The reference leaves the chip
// stage (gather within the host and argmin) to XLA, which fuses it; eager
// PyTorch fuses nothing, so the port runs that stage through this kernel
// too (solver/dist_cuda.py): a launch per stage of each select, on each
// shard.
//
// rows is int32[P, W] row-major, W = K + 2: (notfound, keys..., gid) per
// member, keys of a not-found member the int32 sentinel. out is int32[W],
// the row whose columns 0..W-2 are lexicographically smallest; the gid
// column is carried, not compared. On a tie the lower row index wins. The
// reference's halving tree over P rounded up to a power of two keeps the
// left row on a tie; ties occur only between not-found rows, whose compared
// columns are all equal, because the last key is the globally unique node
// rank. So both keep row 0 when no member found a node, and both pick the
// unique found minimum otherwise; the reference's pad rows (not found,
// sentinel keys, at the end) never win, so the kernel needs none. When
// asked, it also writes (found ? gid : 0) as int32 to *gid and found as bool
// to *found: the select's result, so the caller runs nothing after it.
//
// Bound on the H100: latency. The work is P * W int32 reads (40 bytes at
// the round's P = 2, K = 3) and a few compares, so a call costs a launch,
// one load and the shuffles. The design keeps that chain short with one
// kernel for every P: thread i holds row i in registers, starting all of
// its loads together (one 16-byte or 8-byte load per 4 or 2 words where
// the rows' stride and base allow; W = 5 rows lie 20 bytes apart, so there
// each word is a 4-byte load, all in flight at once); then rounds of
// shuffles pass (row words, row index) down to lane 0 of each warp. For
// P <= 32, which covers every mesh the port runs, that is one warp, log2(P)
// rounds and no shared memory or block barrier. Up to P = 1024 rows the
// warps' winners then meet in dynamic shared memory behind one barrier, and
// warp 0 shuffles them down the same way. Every combine compares (columns,
// row index), so the result does not depend on how the reduction
// associates. The width W is a template parameter (2 to kMaxWidth words),
// so that each instantiation's unrolled code is as short as its rows: one
// kernel written for the widest row, the width read at run time, took about
// half as long again on the device of an H100 at W = 5.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 1024;  // ops/kernels.py WINNER_MAX_ROWS: a row per thread
constexpr int kMaxWidth = 16;   // ops/kernels.py WINNER_MAX_WIDTH

// Row i's W words into registers, with the widest loads the base allows.
template <int W>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ rows,
                                         int i, int32_t (&r)[W]) {
  const int32_t* src = rows + i * W;
  const uintptr_t base = reinterpret_cast<uintptr_t>(rows);
  if constexpr (W % 4 == 0) {
    if ((base & 15) == 0) {
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(src) + q);
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
      return;
    }
  }
  if constexpr (W % 2 == 0) {
    if ((base & 7) == 0) {
#pragma unroll
      for (int q = 0; q < W / 2; ++q) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(src) + q);
        r[2 * q] = v.x;
        r[2 * q + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < W; ++c) r[c] = __ldg(src + c);
}

// True when (a, ia) precedes (b, ib): columns 0..W-2, then the row index.
template <int W>
__device__ __forceinline__ bool row_less(const int32_t (&a)[W], int ia,
                                         const int32_t (&b)[W], int ib) {
#pragma unroll
  for (int c = 0; c < W - 1; ++c) {
    if (a[c] != b[c]) return a[c] < b[c];
  }
  return ia < ib;
}

// The largest power of two below m (0 for m <= 1): the shuffle offsets
// top, top / 2, ..., 1 bring lanes 0..m-1 to lane 0.
__device__ __forceinline__ int top_offset(int m) {
  return m > 1 ? 1 << (31 - __clz(m - 1)) : 0;
}

// Shuffles (row, index) down to lane 0 from offsets offset, offset / 2,
// ..., 1, keeping the lesser; index -1 marks a lane without a row. Every
// lane of the warp takes part, with the same offset.
template <int W>
__device__ __forceinline__ void warp_min(int32_t (&r)[W], int& idx, int offset) {
  for (; offset > 0; offset >>= 1) {
    int32_t o[W];
#pragma unroll
    for (int c = 0; c < W; ++c) o[c] = __shfl_down_sync(kFull, r[c], offset);
    const int oi = __shfl_down_sync(kFull, idx, offset);
    if (oi >= 0 && (idx < 0 || row_less<W>(o, oi, r, idx))) {
#pragma unroll
      for (int c = 0; c < W; ++c) r[c] = o[c];
      idx = oi;
    }
  }
}

// One block of ceil(P / 32) warps; thread i holds row i.
template <int W>
__global__ void __launch_bounds__(kMaxRows)
winner_reduce_kernel(const int32_t* __restrict__ rows, int p,
                     int32_t* __restrict__ out, int32_t* gid, bool* found) {
  // Dynamic, and none for one warp: n_warps rows, then n_warps indices.
  extern __shared__ int32_t warp_rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int32_t r[W] = {};
  int idx = -1;
  if (static_cast<int>(threadIdx.x) < p) {
    load_row<W>(rows, threadIdx.x, r);
    idx = threadIdx.x;
  }
  warp_min<W>(r, idx, top_offset(p < 32 ? p : 32));
  if (n_warps > 1) {  // uniform across the block
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < W; ++c) warp_rows[warp * W + c] = r[c];
      warp_rows[n_warps * W + warp] = idx;
    }
    __syncthreads();
    if (warp != 0) return;
    idx = lane < n_warps ? warp_rows[n_warps * W + lane] : -1;
    if (idx >= 0) {
#pragma unroll
      for (int c = 0; c < W; ++c) r[c] = warp_rows[lane * W + c];
    }
    warp_min<W>(r, idx, top_offset(n_warps));
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < W; ++c) out[c] = r[c];
    // The select's result, (found ? gid : 0) and found, from the winner.
    const bool f = r[0] == 0;
    if (gid != nullptr) *gid = f ? r[W - 1] : 0;
    if (found != nullptr) *found = f;
  }
}

// Launches the kernel written for width w, trying W = 2, 3, ... in turn.
template <int W = 2>
void launch(const int32_t* rows, int p, int w, int32_t* out, int32_t* gid,
            bool* found, cudaStream_t stream) {
  if (w != W) {
    if constexpr (W < kMaxWidth) launch<W + 1>(rows, p, w, out, gid, found, stream);
    return;
  }
  const int n_warps = (p + 31) / 32;
  const size_t smem = n_warps > 1 ? n_warps * (W + 1) * sizeof(int32_t) : 0;
  winner_reduce_kernel<W><<<1, n_warps * 32, smem, stream>>>(rows, p, out, gid, found);
}

}  // namespace

// rows int32[p, w] and out int32[w] on the device, 1 <= p <= 1024,
// 2 <= w <= 16; gid (int32) and found (bool) are single elements on the
// device, or null where the caller does not want them. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int armada_winner_reduce(const void* rows, int p, int w, void* out,
                                    void* gid, void* found, void* stream) {
  if (p < 1 || p > kMaxRows || w < 2 || w > kMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch(static_cast<const int32_t*>(rows), p, w, static_cast<int32_t*>(out),
         static_cast<int32_t*>(gid), static_cast<bool*>(found),
         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
