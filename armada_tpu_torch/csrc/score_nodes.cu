// score_nodes: one job scored against every node of the pool.
//
// Replaces the Pallas kernel `_score_kernel` (body `_score_values`) in
// armada_tpu/ops/pallas_kernels.py, launched there by `_pallas_score`
// through `fill_score` once per batched-fill loop.
//
// Per node n it writes
//   fit0[n] = static feasibility (taints tolerated, selector within the
//             labels, request within the node total, gid not in the job's
//             excluded list, affinity bit set, node schedulable, job
//             possible) and a row-0 fit (request within alloc0);
//   caps[n] = min over resources with req > 0 of alloc0 // req, clipped
//             to [0, batch_window] (2^30 when the job requests nothing);
//   key[n]  = the best-fit order keys alloc0[:, oidx[k]] // ores[k], then
//             the node rank, each clipped to its bit width and packed
//             mixed-radix into one int64 (<= 62 bits). That equals the
//             reference's (hi << 31) | lo pair bit for bit.
//
// Bound on the H100: bytes. Each node is read once (alloc0 and node_total
// rows, taint and label words, rank, gid, the unschedulable byte) and three
// outputs are written; the arithmetic is a few integer ops per byte. The
// design is one thread per node in a grid-stride loop, reading each node's
// row once with neighbouring threads on neighbouring rows, so the reads
// coalesce; the per-job vectors are a few dozen bytes that every thread
// reads through the cache. No shared memory and no cross-thread step.
//
// Division: alloc0 can be negative on an over-allocated node, and C++ `/`
// truncates toward zero where the reference's `//` floors, so the kernel
// floors explicitly (floor_div) rather than relying on the later clip.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 1 << 30;  // the reference's BIG_I32

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  int32_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

__device__ __forceinline__ int64_t clip_bits(int64_t v, int b) {
  const int64_t hi = (int64_t(1) << b) - 1;
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void score_nodes_kernel(
    const int32_t* __restrict__ alloc0, const int32_t* __restrict__ node_total,
    const uint32_t* __restrict__ taints, const uint32_t* __restrict__ labels,
    const int32_t* __restrict__ rank, const int32_t* __restrict__ gid,
    const bool* __restrict__ unsched, const uint32_t* __restrict__ aff_row,
    const uint32_t* __restrict__ tolerated, const uint32_t* __restrict__ selector,
    const int32_t* __restrict__ req_fit, const int32_t* __restrict__ excl,
    const int32_t* __restrict__ oidx, const int32_t* __restrict__ ores,
    const int32_t* __restrict__ bits, int n, int r, int wt, int wl, int k_excl,
    int n_order, int batch_window, int job_ok, bool* __restrict__ fit0,
    int32_t* __restrict__ caps, int64_t* __restrict__ key) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    bool ok = job_ok != 0 && !unsched[i];
    for (int w = 0; w < wt; ++w) ok = ok && (taints[i * wt + w] & ~tolerated[w]) == 0u;
    for (int w = 0; w < wl; ++w) ok = ok && (selector[w] & ~labels[i * wl + w]) == 0u;
    const int32_t g = gid[i];
    for (int k = 0; k < k_excl; ++k) ok = ok && g != excl[k];
    if (aff_row != nullptr) ok = ok && ((aff_row[g >> 5] >> (g & 31)) & 1u) != 0u;
    int32_t cap = kBig;
    bool fits = true;
    for (int c = 0; c < r; ++c) {
      const int32_t q = req_fit[c];
      const int32_t a = alloc0[i * r + c];
      ok = ok && q <= node_total[i * r + c];
      fits = fits && q <= a;
      if (q > 0) {
        const int32_t v = floor_div(a, q);
        cap = v < cap ? v : cap;
      }
    }
    cap = cap < 0 ? 0 : (cap > batch_window ? batch_window : cap);
    int64_t acc = 0;
    for (int k = 0; k < n_order; ++k) {
      const int32_t v = floor_div(alloc0[i * r + oidx[k]], ores[k]);
      acc = (acc << bits[k]) | clip_bits(v, bits[k]);
    }
    acc = (acc << bits[n_order]) | clip_bits(rank[i], bits[n_order]);
    fit0[i] = ok && fits;
    caps[i] = cap;
    key[i] = acc;
  }
}

}  // namespace

extern "C" int armada_score_nodes(
    const void* alloc0, const void* node_total, const void* taints,
    const void* labels, const void* rank, const void* gid, const void* unsched,
    const void* aff_row, const void* tolerated, const void* selector,
    const void* req_fit, const void* excl, const void* oidx, const void* ores,
    const void* bits, int n, int r, int wt, int wl, int k_excl, int n_order,
    int batch_window, int job_ok, void* fit0, void* caps, void* key,
    void* stream) {
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  score_nodes_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(alloc0), static_cast<const int32_t*>(node_total),
      static_cast<const uint32_t*>(taints), static_cast<const uint32_t*>(labels),
      static_cast<const int32_t*>(rank), static_cast<const int32_t*>(gid),
      static_cast<const bool*>(unsched), static_cast<const uint32_t*>(aff_row),
      static_cast<const uint32_t*>(tolerated), static_cast<const uint32_t*>(selector),
      static_cast<const int32_t*>(req_fit), static_cast<const int32_t*>(excl),
      static_cast<const int32_t*>(oidx), static_cast<const int32_t*>(ores),
      static_cast<const int32_t*>(bits), n, r, wt, wl, k_excl, n_order,
      batch_window, job_ok, static_cast<bool*>(fit0), static_cast<int32_t*>(caps),
      static_cast<int64_t*>(key));
  return static_cast<int>(cudaGetLastError());
}
