// score_nodes: one job scored against every node of the pool.
//
// Replaces the Pallas kernel `_score_kernel` (body `_score_values`) in
// armada_tpu/ops/pallas_kernels.py, launched there by `_pallas_score`
// through `fill_score` once per batched-fill loop. As the reference's
// `fill_score` takes the job's index and gathers its rows itself
// (`_score_inputs`), this kernel takes a per-round plan (struct ScorePlan:
// the round's node and job tables, checked once by ops/kernels.py
// ScorePlan) and the job index j, and reads job j's rows on the device.
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
// outputs are written; the arithmetic is a few integer ops per byte. At the
// round's node counts that is about a microsecond, so the launch and the
// host's per-call work weigh more, and the plan takes the host's work out
// of the fill loop: one struct passed by value and five pointers per call.
// On the device, each block first stages job j's vectors (request,
// toleration and selector words, excluded gids, order indices and
// resolutions, bits) into shared memory, so the node loop reads them from
// there and not from global memory in every inner loop; each thread then
// takes one node in a grid-stride loop, neighbouring threads on
// neighbouring rows, and reads its alloc0 and node_total rows as one
// 16-byte load each where R = 4 and both tables are 16-byte aligned (a
// scalar loop over the row otherwise). A thread reads its first node
// before the block's barrier on the staged job, and the next one before
// it scores the current one, so the staging adds no round trip to device
// memory.
//
// Division: alloc0 can be negative on an over-allocated node, and C++ `/`
// truncates toward zero where the reference's `//` floors, so the kernel
// floors explicitly (floor_div) rather than relying on the later clip.

#include <cstdint>
#include <cuda_runtime.h>

// The round's tables, as ops/kernels.py _ScorePlanC lays them out (same
// fields, same order; tests/test_torch_kernels.py holds the two together).
// Bitset words are uint32 bit patterns; affinity may be null when no job
// has an affinity group.
struct ScorePlan {
  const int32_t* node_total;  // [n, r]
  const uint32_t* taints;     // [n, wt]
  const uint32_t* labels;     // [n, wl]
  const int32_t* rank;        // [n]
  const int32_t* gid;         // [n]
  const bool* unsched;        // [n]
  const uint32_t* tolerated;  // [jobs, wt]
  const uint32_t* selector;   // [jobs, wl]
  const int32_t* req_fit;     // [jobs, r]
  const int32_t* excl;        // [jobs, k_excl]
  const int32_t* aff_group;   // [jobs], -1: no group
  const bool* possible;       // [jobs]
  const uint32_t* affinity;   // [n_aff, aff_words]
  const int32_t* oidx;        // [n_order]
  const int32_t* ores;        // [n_order]
  const int32_t* bits;        // [n_order + 1]
  int n;
  int r;
  int wt;
  int wl;
  int k_excl;
  int n_order;
  int n_aff;
  int aff_words;
  int batch_window;
};

namespace {

constexpr int kThreads = 256;
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

// Shared-memory words the staged job takes (ints).
__host__ __device__ inline int staged_words(const ScorePlan& p) {
  return p.wt + p.wl + p.r + p.k_excl + 3 * p.n_order + 1;
}

// One node's reads: its alloc0 and node_total rows (registers on the
// vector path, read in score_node on the scalar one), its first taint and
// label words, gid, rank and unschedulable flag.
struct NodeIn {
  int32_t al[4];
  int32_t tot[4];
  uint32_t taint0;
  uint32_t label0;
  int32_t gid;
  int32_t rank;
  bool unsched;
};

template <bool kVec4>
__device__ __forceinline__ NodeIn load_node(const ScorePlan& p, const int32_t* alloc0, int i) {
  NodeIn v;
  if constexpr (kVec4) {
    const int4 av = reinterpret_cast<const int4*>(alloc0)[i];
    const int4 tv = reinterpret_cast<const int4*>(p.node_total)[i];
    v.al[0] = av.x; v.al[1] = av.y; v.al[2] = av.z; v.al[3] = av.w;
    v.tot[0] = tv.x; v.tot[1] = tv.y; v.tot[2] = tv.z; v.tot[3] = tv.w;
  }
  v.taint0 = p.wt > 0 ? p.taints[i * p.wt] : 0u;
  v.label0 = p.wl > 0 ? p.labels[i * p.wl] : ~0u;
  v.gid = p.gid[i];
  v.rank = p.rank[i];
  v.unsched = p.unsched[i];
  return v;
}

__device__ __forceinline__ int32_t pick4(const int32_t (&v)[4], int c) {
  // Selected, not indexed, so the row stays out of local memory.
  return c == 0 ? v[0] : (c == 1 ? v[1] : (c == 2 ? v[2] : v[3]));
}

// kVec4: R = 4 with 16-byte aligned alloc0 and node_total rows.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
score_nodes_kernel(ScorePlan p, const int32_t* __restrict__ alloc0, int j,
                   int64_t* __restrict__ key, int32_t* __restrict__ caps,
                   bool* __restrict__ fit0) {
  extern __shared__ int32_t s_job[];
  uint32_t* s_tol = reinterpret_cast<uint32_t*>(s_job);
  uint32_t* s_sel = s_tol + p.wt;
  int32_t* s_req = reinterpret_cast<int32_t*>(s_sel + p.wl);
  int32_t* s_excl = s_req + p.r;
  int32_t* s_oidx = s_excl + p.k_excl;
  int32_t* s_ores = s_oidx + p.n_order;
  int32_t* s_bits = s_ores + p.n_order;

  // This thread's first node is read before the block waits for the
  // staged job, so the two reads from device memory overlap.
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  NodeIn cur = {};
  if (i < p.n) cur = load_node<kVec4>(p, alloc0, i);
  const bool job_ok = p.possible[j];
  const int a = p.aff_group[j];

  for (int w = threadIdx.x; w < p.wt; w += blockDim.x) s_tol[w] = p.tolerated[j * p.wt + w];
  for (int w = threadIdx.x; w < p.wl; w += blockDim.x) s_sel[w] = p.selector[j * p.wl + w];
  for (int c = threadIdx.x; c < p.r; c += blockDim.x) s_req[c] = p.req_fit[j * p.r + c];
  for (int k = threadIdx.x; k < p.k_excl; k += blockDim.x) s_excl[k] = p.excl[j * p.k_excl + k];
  for (int k = threadIdx.x; k < p.n_order; k += blockDim.x) {
    s_oidx[k] = p.oidx[k];
    s_ores[k] = p.ores[k];
  }
  for (int k = threadIdx.x; k <= p.n_order; k += blockDim.x) s_bits[k] = p.bits[k];
  __syncthreads();

  const uint32_t* aff_row =
      (a >= 0 && p.affinity != nullptr)
          ? p.affinity + static_cast<int64_t>(min(a, p.n_aff - 1)) * p.aff_words
          : nullptr;

  for (; i < p.n; i += stride) {
    NodeIn next = {};
    if (i + stride < p.n) next = load_node<kVec4>(p, alloc0, i + stride);
    // Resource c of this node: registers on the vector path, global memory
    // on the scalar one.
    auto alloc_at = [&](int c) -> int32_t {
      if constexpr (kVec4) {
        return pick4(cur.al, c);
      } else {
        return alloc0[static_cast<int64_t>(i) * p.r + c];
      }
    };
    auto total_at = [&](int c) -> int32_t {
      if constexpr (kVec4) {
        return pick4(cur.tot, c);
      } else {
        return p.node_total[static_cast<int64_t>(i) * p.r + c];
      }
    };

    bool ok = job_ok && !cur.unsched;
    if (p.wt > 0) ok = ok && (cur.taint0 & ~s_tol[0]) == 0u;
    for (int w = 1; w < p.wt; ++w) ok = ok && (p.taints[i * p.wt + w] & ~s_tol[w]) == 0u;
    if (p.wl > 0) ok = ok && (s_sel[0] & ~cur.label0) == 0u;
    for (int w = 1; w < p.wl; ++w) ok = ok && (s_sel[w] & ~p.labels[i * p.wl + w]) == 0u;
    const int32_t g = cur.gid;
    for (int k = 0; k < p.k_excl; ++k) ok = ok && g != s_excl[k];
    if (aff_row != nullptr) ok = ok && ((aff_row[g >> 5] >> (g & 31)) & 1u) != 0u;
    int32_t cap = kBig;
    bool fits = true;
    const int r = kVec4 ? 4 : p.r;
    for (int c = 0; c < r; ++c) {
      const int32_t q = s_req[c];
      const int32_t av = alloc_at(c);
      ok = ok && q <= total_at(c);
      fits = fits && q <= av;
      if (q > 0) {
        const int32_t v = floor_div(av, q);
        cap = v < cap ? v : cap;
      }
    }
    cap = cap < 0 ? 0 : (cap > p.batch_window ? p.batch_window : cap);
    int64_t acc = 0;
    for (int k = 0; k < p.n_order; ++k) {
      const int32_t v = floor_div(alloc_at(s_oidx[k]), s_ores[k]);
      acc = (acc << s_bits[k]) | clip_bits(v, s_bits[k]);
    }
    acc = (acc << s_bits[p.n_order]) | clip_bits(cur.rank, s_bits[p.n_order]);
    fit0[i] = ok && fits;
    caps[i] = cap;
    key[i] = acc;
    cur = next;
  }
}

}  // namespace

// Job j of the plan against every node, into key int64[n], caps
// int32[n] and fit0 bool[n].
extern "C" int armada_score_plan(ScorePlan plan, const void* alloc0, int j, void* key_out,
                                 void* caps_out, void* fit0_out, void* stream) {
  int blocks = (plan.n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(staged_words(plan));
  int64_t* key = static_cast<int64_t*>(key_out);
  int32_t* caps = static_cast<int32_t*>(caps_out);
  bool* fit0 = static_cast<bool*>(fit0_out);
  const int32_t* a = static_cast<const int32_t*>(alloc0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = plan.r == 4 && (reinterpret_cast<uintptr_t>(alloc0) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(plan.node_total) & 15) == 0;
  if (vec4) {
    score_nodes_kernel<true><<<blocks, kThreads, smem, s>>>(plan, a, j, key, caps, fit0);
  } else {
    score_nodes_kernel<false><<<blocks, kThreads, smem, s>>>(plan, a, j, key, caps, fit0);
  }
  return static_cast<int>(cudaGetLastError());
}
