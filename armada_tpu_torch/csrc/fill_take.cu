// fill_take: indices of the B smallest packed int64 keys, in stable-sort
// order (equal keys keep index order), with their keys.
//
// Replaces armada_tpu/ops/pallas_kernels.py::fill_take (a lax top-B
// selection that the reference's fused kernel path sends every fill sort
// through, via fill_sort_path and solver/dist.py::_fill_sort). The result
// equals a stable ascending sort's first want = min(B, N) entries,
// including the masked sentinel tail when fewer than B keys are real,
// duplicate keys, and B > N.
//
// Bound on the H100: bytes. The least work reads the N keys once and
// writes want indices and keys, under a microsecond at the round's node
// counts, so what costs is latency: passes over the keys, barriers and the
// launch. The design spreads one radix select over a thread block cluster
// of C = 1, 2, 4 or 8 CTAs on neighbouring SMs (ops/kernels.py
// fill_take_config picks C from N: at most about 8,192 keys a CTA), which
// talk through distributed shared memory (DSMEM) and nothing else:
//   1. load once: CTA r owns the index slice [r*c, min((r+1)*c, N)) and
//      copies it into its shared memory with one asynchronous bulk copy
//      (cp.async.bulk, completing on an mbarrier) for the 16-byte-aligned
//      body and plain loads for a ragged head or tail; c is even, so every
//      slice of an aligned tensor starts aligned. This is the only read of
//      the keys from device memory (the one-block design read them 9 times);
//   2. radix select, one byte per pass from the top: each CTA builds a
//      256-bin histogram of its keys that match the prefix chosen so far.
//      Packed keys share their top bytes and masked ones are one sentinel,
//      so in the first passes one or two bins take almost every key: each
//      thread counts its keys in two (digit, count) slots and a slot goes
//      to the shared histogram only when a third digit displaces it, the
//      last two through warp-aggregated adds (__match_any_sync). After a
//      cluster barrier every CTA reads all C histograms through DSMEM and
//      scans them in rank order, so each picks the same digit and residual
//      rank with no broadcast. Histograms are double-buffered by pass
//      parity, so one barrier per pass suffices: a CTA zeroes a buffer only
//      after every CTA has passed the barrier that follows its reads. The
//      passes end at the exact want-th key T and need_eq, the keys == T
//      among the first want, or earlier: when the k-th key is the last of
//      its bin, the first want keys are all keys up to that bin, and T
//      becomes the bin's largest possible key, every key <= T kept;
//   3. compaction in index order across CTAs: each CTA counts its keys
//      < T and == T and the counts go round the cluster through DSMEM; CTA
//      r keeps its keys < T and its first max(0, need_eq - (keys == T in
//      slices < r)) keys == T, and writes them in index order (ballots of
//      32-key chunks and one block scan per tile of 8,192) straight into
//      CTA 0's shared memory at the count of survivors of the slices before
//      it. A cluster barrier follows: CTA 0 reads the survivors only after
//      it, and no CTA exits while another may still touch its shared
//      memory;
//   4. CTA 0 sorts the <= 2,048 survivors by (key, index): each warp sorts
//      32 with a bitonic network over shuffles (no barrier), then
//      log2(p2 / 32) merge levels place each at its index in its run plus
//      the count of the partner run's survivors below it (a binary search).
//      The survivors arrive in index order, so ranking each by counting all
//      the survivors below it would give the same order, but that is
//      want^2 / 1,024 comparisons a thread (4,096 at want = 2,048); a
//      bitonic sort in shared memory needs a block barrier for each of its
//      45 steps at want = 512, where the merges need two per level (four
//      levels at 512).
// Past kMaxTake survivors (want > 2,048: a batch window above 2,048 on a
// device with more nodes) they do not fit CTA 0's shared memory. Steps 1
// to 3 run as above, but the compaction writes exactly want survivors, in
// index order, to a global scratch that the wrapper allocates once per
// call (two ping-pong buffers of want keys and indices); then two more
// kernels of this file sort them by (key, index):
//   5. sort_runs_kernel: block b sorts survivors [2,048 b, 2,048 (b + 1))
//      in shared memory with step 4's sort;
//   6. merge_kernel, once per level w = 2,048, 4,096, ...: every survivor
//      moves to its index in its run plus the count of the partner run's
//      survivors below it (a binary search in global memory, the partner
//      run cut at want), so two sorted runs of w become one of 2w; the
//      last level writes the outputs. (key, index) pairs are distinct, so
//      the ranks form a permutation.
// Each level is one read and one write of want pairs (12 bytes each) with
// log2(w) + 1 probes a survivor: a few microseconds at want = 8,192.
// When the cluster is one CTA, its barriers are the block's own. Beyond the
// cluster's shared memory (more than kResidentKeys keys a CTA, N > 131,072;
// no round in the repository reaches it, the flagship pads to 65,536) the
// same kernel, instantiated with kResident = false, runs every pass over
// its slice from global memory (L2) instead.
// Keys are compared as unsigned after flipping the sign bit, so any int64
// orders as the signed value does.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTake = 2048;
constexpr int kMaxCluster = 8;
constexpr int kBins = 256;
constexpr int kScanWarps = kBins / 32;
constexpr int kChunks = 8;                     // compaction: 32-key chunks a warp, per tile
constexpr int kTile = kThreads * kChunks;      // compaction: keys a tile
constexpr int32_t kPadIndex = 0x7fffffff - kMaxTake;  // sorts after every real index
constexpr int kResidentKeys = 16384;  // ops/kernels.py FILL_TAKE_RESIDENT_KEYS
constexpr int kBulkChunk = 32768;     // bytes per cp.async.bulk
constexpr uint64_t kSign = 0x8000000000000000ull;

// Dynamic shared memory layout (ops/kernels.py fill_take_config mirrors it):
// survivor keys [p2] u64, survivor indices [p2] i32, then from a 16-byte
// boundary the resident keys, [c + 1] u64 (one slot of slack to align the
// bulk copy's destination with its source).
__host__ __device__ constexpr int keys_offset(int p2) { return (p2 * 12 + 15) / 16 * 16; }
constexpr int kMaxDynamicSmem = keys_offset(kMaxTake) + (kResidentKeys + 1) * 8;

__device__ __forceinline__ int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the bulk copy's phase; a copy that never completes (a fault in
// this kernel) traps after kCopyTimeoutNs instead of hanging the card.
constexpr uint64_t kCopyTimeoutNs = 2000000000ull;

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const uint64_t t0 = global_ns();
  while (!done) {
    if (global_ns() - t0 > kCopyTimeoutNs) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool item_less(uint64_t ka, int32_t ia, uint64_t kb, int32_t ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// Items of the sorted run a[0, w) (w a power of two) less than (k, i):
// a branchless binary search, log2(w) + 1 probes.
__device__ __forceinline__ int count_less(const uint64_t* ak, const int32_t* ai, int w,
                                          uint64_t k, int32_t i) {
  int pos = 0;
  for (int step = w >> 1; step > 0; step >>= 1) {
    if (item_less(ak[pos + step - 1], ai[pos + step - 1], k, i)) pos += step;
  }
  return pos + (item_less(ak[pos], ai[pos], k, i) ? 1 : 0);
}

// Items of the sorted run a[0, len) less than (k, i), len any count up to
// a run's width: a binary search (lower bound) in global memory.
__device__ __forceinline__ int count_less_n(const uint64_t* __restrict__ ak,
                                            const int32_t* __restrict__ ai, int len, uint64_t k,
                                            int32_t i) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (item_less(ak[mid], ai[mid], k, i)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Sorts the items [0, want) of s_skey/s_sidx (want <= kMaxTake, p2 the
// power of two at least want) by (key, index), in place, with the whole
// block of kThreads: thread t holds items t and t + 1,024; each warp sorts
// its 32 with a bitonic network over shuffles, then log2(p2 / 32) merge
// levels place each at its rank in the merged run (its index in its own
// run plus the count of the partner run's items less than it, by binary
// search). Padding items past want sort last: key ~0 and indices above
// every real index. Ends with a block barrier.
__device__ __forceinline__ void sort_items(uint64_t* s_skey, int32_t* s_sidx, int want, int p2) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = p2 > kThreads ? 2 : 1;
  uint64_t ek[2];
  int32_t ei[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * kThreads;
    const bool real = i < want;
    ek[e] = real ? s_skey[i] : ~0ull;
    ei[e] = real ? s_sidx[i] : kPadIndex + i;
  }
  for (int kk = 2; kk <= 32 && kk <= p2 && warp * 32 < p2; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e < per) {
          const uint64_t pk = __shfl_xor_sync(0xffffffffu, ek[e], j);
          const int32_t pi = __shfl_xor_sync(0xffffffffu, ei[e], j);
          const bool up = (lane & kk) == 0;
          const bool lower = (lane & j) == 0;
          // The lower slot of an ascending pair (the upper of a descending
          // one) keeps the smaller item.
          if (item_less(ek[e], ei[e], pk, pi) != (lower == up)) {
            ek[e] = pk;
            ei[e] = pi;
          }
        }
      }
    }
  }
  __syncthreads();  // every item has been read into registers
  int at[2];  // where each of this thread's items sits now (-1: none)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * kThreads;
    at[e] = (e < per && i < p2) ? i : -1;
    if (at[e] >= 0) {
      s_skey[i] = ek[e];
      s_sidx[i] = ei[e];
    }
  }
  for (int w = 32; w < p2; w <<= 1) {
    __syncthreads();
    int dst[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dst[e] = at[e];
      if (at[e] >= 0) {
        const int run0 = at[e] & ~(2 * w - 1);          // the merged run's start
        const int partner = run0 + ((at[e] & w) ^ w);  // the other half's start
        dst[e] = run0 + (at[e] & (w - 1)) +
                 count_less(s_skey + partner, s_sidx + partner, w, ek[e], ei[e]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      at[e] = dst[e];
      if (at[e] >= 0) {
        s_skey[at[e]] = ek[e];
        s_sidx[at[e]] = ei[e];
      }
    }
  }
  __syncthreads();
}

// g_skey/g_sidx: null, or the global survivor scratch of the want > kMaxTake
// path (step 3 writes there and the kernel ends; see the top of the file).
template <bool kResident>
__global__ void __launch_bounds__(kThreads)
fill_take_kernel(const int64_t* __restrict__ key, int n, int want, int keys_per_cta,
                 int64_t* __restrict__ take_key, int32_t* __restrict__ take,
                 uint64_t* __restrict__ g_skey, int32_t* __restrict__ g_sidx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned int hist[2][kBins];
  __shared__ unsigned int warp_tot[kThreads / 32];
  __shared__ unsigned int warp_eq[kThreads / 32];
  __shared__ unsigned int s_mine[2];          // this slice: keys < T, == T
  __shared__ unsigned int s_lt[kMaxCluster];  // per slice: keys < T
  __shared__ unsigned int s_eq[kMaxCluster];  // per slice: keys == T
  __shared__ uint64_t s_prefix;
  __shared__ unsigned int s_rank;
  __shared__ unsigned int s_done;
  __shared__ unsigned int s_tile;
  __shared__ __align__(8) uint64_t s_bar;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool global_sort = g_skey != nullptr;
  const int p2 = global_sort ? 0 : pow2_at_least(want);  // no survivors in shared memory
  uint64_t* s_skey = reinterpret_cast<uint64_t*>(smem);
  int32_t* s_sidx = reinterpret_cast<int32_t*>(smem + p2 * 8);

  const int start = me * keys_per_cta;
  const int len = max(0, min(keys_per_cta, n - start));
  const int64_t* g = key + start;

  if (tid == 0) {
    s_prefix = 0;
    s_rank = static_cast<unsigned int>(want);
    s_done = 0;
  }
  if (tid < kBins) hist[0][tid] = 0;

  // 1. Load the slice once (resident): bulk copy of the aligned body,
  // plain loads for the ragged ends.
  uint64_t* s_keys = nullptr;
  if constexpr (kResident) {
    const int head = min(len, (reinterpret_cast<uintptr_t>(g) & 15) ? 1 : 0);
    const int body = (len - head) & ~1;  // keys, an even count: 16-byte multiple
    // &s_keys[head] is 16-byte aligned, as g + head is.
    s_keys = reinterpret_cast<uint64_t*>(smem + keys_offset(p2)) + head;
    if (tid == 0 && body > 0) mbar_init(&s_bar, 1);
    __syncthreads();
    if (tid == 0 && body > 0) {
      const uint32_t bytes = static_cast<uint32_t>(body) * 8u;
      mbar_expect_tx(&s_bar, bytes);
      for (uint32_t off = 0; off < bytes; off += kBulkChunk) {
        bulk_load(reinterpret_cast<unsigned char*>(s_keys + head) + off,
                  reinterpret_cast<const unsigned char*>(g + head) + off,
                  min(static_cast<uint32_t>(kBulkChunk), bytes - off), &s_bar);
      }
    }
    if (tid < head) s_keys[tid] = static_cast<uint64_t>(g[tid]);
    for (int i = head + body + tid; i < len; i += kThreads) s_keys[i] = static_cast<uint64_t>(g[i]);
    if (body > 0) mbar_wait(&s_bar, 0);
  }
  __syncthreads();

  auto load = [&](int i) -> uint64_t {
    if constexpr (kResident) {
      return s_keys[i] ^ kSign;
    } else {
      return static_cast<uint64_t>(g[i]) ^ kSign;
    }
  };

  // A barrier over the cluster's CTAs: the cluster barrier, or the block's
  // own when the cluster is this one CTA (the same ordering, at a fraction
  // of the cost).
  auto cluster_barrier = [&]() {
    if (n_ctas == 1) {
      __syncthreads();
    } else {
      cluster.sync();
    }
  };

  // 2. Radix select of the want-th smallest key, one byte per pass.
  uint64_t mask = 0;
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = 56 - 8 * pass;
    const int buf = pass & 1;
    unsigned int* h_own = hist[buf];
    const uint64_t prefix = s_prefix;
    const unsigned int k = s_rank;
    {
      // Each thread counts its keys per digit in two slots and adds a slot
      // to the histogram only when a third digit takes it over; the slots
      // left at the end go through warp-aggregated adds. Packed keys share
      // their top bytes, and masked ones are one sentinel, so in the first
      // passes one or two bins take almost every key.
      unsigned int d0 = kBins, c0 = 0, d1 = kBins, c1 = 0;
      for (int i = tid; i < len; i += kThreads) {
        const uint64_t u = load(i);
        if ((u & mask) != prefix) continue;
        const unsigned int digit = static_cast<unsigned int>((u >> shift) & 255u);
        if (digit == d0) {
          ++c0;
        } else if (digit == d1) {
          ++c1;
        } else {
          if (c1 != 0) atomicAdd(&h_own[d1], c1);
          d1 = d0;
          c1 = c0;
          d0 = digit;
          c0 = 1;
        }
      }
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        const unsigned int d = slot == 0 ? d0 : d1;
        const unsigned int c = slot == 0 ? c0 : c1;
        const unsigned int peers = __match_any_sync(0xffffffffu, d);
        const unsigned int sum = __reduce_add_sync(peers, c);
        if (d < kBins && lane == __ffs(peers) - 1) atomicAdd(&h_own[d], sum);
      }
    }
    cluster_barrier();  // every histogram of this pass is complete

    // Every CTA sums all C histograms (bin b in thread b, slices in rank
    // order) and finds the bin of the k-th key. The other buffer was last
    // read in the previous pass, before every CTA reached this barrier, so
    // it is zeroed for the next pass meanwhile.
    unsigned int tot = 0;
    unsigned int incl = 0;
    if (tid < kBins) {
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < n_ctas) tot += cluster.map_shared_rank(h_own, q)[tid];
      }
      incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) warp_tot[warp] = incl;
    } else if (tid < 2 * kBins) {
      hist[buf ^ 1][tid - kBins] = 0;
    }
    __syncthreads();
    if (tid < kBins) {
      unsigned int below = incl - tot;
#pragma unroll
      for (int w = 0; w < kScanWarps; ++w) below += w < warp ? warp_tot[w] : 0u;
      if (below < k && k <= below + tot) {  // exactly one bin
        if (k == below + tot) {
          // The k-th key is the last of its bin: the first want keys are
          // all keys up to this bin, whatever their lower bytes. Stop here,
          // with T the bin's largest possible key and every key <= T kept.
          s_done = 1;
          s_rank = 0;
          s_prefix = prefix | (static_cast<uint64_t>(tid) << shift) |
                     ((static_cast<uint64_t>(1) << shift) - 1);
        } else {
          s_rank = k - below;
          s_prefix = prefix | (static_cast<uint64_t>(tid) << shift);
        }
      }
    }
    __syncthreads();
    if (s_done != 0) break;
    mask |= static_cast<uint64_t>(255) << shift;
  }
  // T, the want-th smallest key, and need_eq, the keys == T among the first
  // want; or, when the select stopped early (inclusive), the bound that
  // every kept key is <= to, with no key == T budgeted.
  const uint64_t thr = s_prefix;
  const bool inclusive = s_done != 0;
  const int need_eq = static_cast<int>(s_rank);
  auto is_lt = [&](uint64_t u) { return u < thr || (inclusive && u == thr); };
  auto is_eq = [&](uint64_t u) { return !inclusive && u == thr; };

  // 3. Each CTA counts its keys < T and == T; the counts go round the
  // cluster through DSMEM, and each CTA derives its share of the survivors
  // and its offset from them, in rank order.
  {
    unsigned int lt = 0, eq = 0;
    for (int i = tid; i < len; i += kThreads) {
      const uint64_t u = load(i);
      lt += is_lt(u) ? 1u : 0u;
      eq += is_eq(u) ? 1u : 0u;
    }
    lt = __reduce_add_sync(0xffffffffu, lt);
    eq = __reduce_add_sync(0xffffffffu, eq);
    if (lane == 0) {
      warp_tot[warp] = lt;
      warp_eq[warp] = eq;
    }
    __syncthreads();
    if (warp == 0) {
      const unsigned int lt_all = __reduce_add_sync(0xffffffffu, warp_tot[lane]);
      const unsigned int eq_all = __reduce_add_sync(0xffffffffu, warp_eq[lane]);
      if (lane == 0) {
        s_mine[0] = lt_all;
        s_mine[1] = eq_all;
      }
    }
  }
  cluster_barrier();
  if (tid < n_ctas) {
    const unsigned int* theirs = cluster.map_shared_rank(s_mine, tid);
    s_lt[tid] = theirs[0];
    s_eq[tid] = theirs[1];
  }
  __syncthreads();
  int my_off = 0, my_budget = 0, my_kept = 0;
  {
    int off = 0, eq_before = 0;
    for (int q = 0; q < n_ctas; ++q) {
      const int budget = max(0, need_eq - eq_before);
      const int kept = static_cast<int>(s_lt[q]) + min(static_cast<int>(s_eq[q]), budget);
      if (q == me) {
        my_off = off;
        my_budget = budget;
        my_kept = kept;
      }
      off += kept;
      eq_before += static_cast<int>(s_eq[q]);
    }
  }
  // Compaction in index order, in tiles of kTile keys: warp w takes chunks
  // of 32 consecutive keys, so ballots give each key's rank among its
  // warp's; one scan over the warps places the warps.
  uint64_t* dst_key = global_sort ? g_skey : cluster.map_shared_rank(s_skey, 0);
  int32_t* dst_idx = global_sort ? g_sidx : cluster.map_shared_rank(s_sidx, 0);
  const unsigned int below_lane = (1u << lane) - 1u;
  int placed = 0;
  int eq_seen = 0;
  for (int base = 0; base < len && placed < my_kept; base += kTile) {
    const int first = base + warp * kChunks * 32 + lane;
    unsigned int lt_bits[kChunks];
    unsigned int eq_bits[kChunks];
    unsigned int lt_w = 0, eq_w = 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = first + c * 32;
      const uint64_t u = i < len ? load(i) : 0;
      lt_bits[c] = __ballot_sync(0xffffffffu, i < len && is_lt(u));
      eq_bits[c] = __ballot_sync(0xffffffffu, i < len && is_eq(u));
      lt_w += __popc(lt_bits[c]);
      eq_w += __popc(eq_bits[c]);
    }
    // keys < thr in the high half, == thr in the low (each at most kTile)
    if (lane == 0) warp_tot[warp] = (lt_w << 16) | eq_w;
    __syncthreads();
    if (warp == 0) {
      const unsigned int v = warp_tot[lane];
      unsigned int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      warp_tot[lane] = x - v;
      if (lane == 31) s_tile = x;
    }
    __syncthreads();
    const unsigned int before = warp_tot[warp];
    const unsigned int tile = s_tile;
    const int rem = max(0, my_budget - eq_seen);
    int lt_r = static_cast<int>(before >> 16);
    int eq_r = static_cast<int>(before & 0xffffu);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int lt_me = lt_r + __popc(lt_bits[c] & below_lane);
      const int eq_me = eq_r + __popc(eq_bits[c] & below_lane);
      int pos = -1;
      if ((lt_bits[c] >> lane) & 1u) pos = lt_me + min(eq_me, rem);
      if (((eq_bits[c] >> lane) & 1u) && eq_me < rem) pos = lt_me + eq_me;
      if (pos >= 0) {
        const int i = first + c * 32;
        dst_key[my_off + placed + pos] = load(i);
        dst_idx[my_off + placed + pos] = start + i;
      }
      lt_r += __popc(lt_bits[c]);
      eq_r += __popc(eq_bits[c]);
    }
    placed += static_cast<int>(tile >> 16) + min(static_cast<int>(tile & 0xffffu), rem);
    eq_seen += static_cast<int>(tile & 0xffffu);
    __syncthreads();  // warp_tot is reused by the next tile
  }
  cluster_barrier();  // every survivor is in place; no CTA reads another's after this
  if (me != 0 || global_sort) return;

  // 4. Sort the survivors by (key, index) in CTA 0.
  sort_items(s_skey, s_sidx, want, p2);
  for (int i = tid; i < want; i += kThreads) {
    take_key[i] = static_cast<int64_t>(s_skey[i] ^ kSign);
    take[i] = s_sidx[i];
  }
}

// 5. Block b sorts the global survivors [b kMaxTake, min(want, (b + 1)
// kMaxTake)) in place.
__global__ void __launch_bounds__(kThreads)
sort_runs_kernel(uint64_t* __restrict__ g_skey, int32_t* __restrict__ g_sidx, int want) {
  __shared__ uint64_t s_skey[kMaxTake];
  __shared__ int32_t s_sidx[kMaxTake];
  const int base = blockIdx.x * kMaxTake;
  const int len = min(kMaxTake, want - base);
  for (int i = threadIdx.x; i < len; i += kThreads) {
    s_skey[i] = g_skey[base + i];
    s_sidx[i] = g_sidx[base + i];
  }
  __syncthreads();
  sort_items(s_skey, s_sidx, len, pow2_at_least(len));
  for (int i = threadIdx.x; i < len; i += kThreads) {
    g_skey[base + i] = s_skey[i];
    g_sidx[base + i] = s_sidx[i];
  }
}

constexpr int kMergeThreads = 256;

// 6. One merge level: the sorted runs of w (the last one cut at want) pair
// up into sorted runs of 2w, src to dst; out_key/out_idx, when given,
// receive the last level's result as the kernel's outputs instead.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const uint64_t* __restrict__ src_k, const int32_t* __restrict__ src_i,
             uint64_t* __restrict__ dst_k, int32_t* __restrict__ dst_i, int want, int w,
             int64_t* __restrict__ out_key, int32_t* __restrict__ out_idx) {
  const long long at = static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (at >= want) return;
  const uint64_t k = src_k[at];
  const int32_t i = src_i[at];
  const long long ww = w;
  const long long run0 = at & ~(2 * ww - 1);
  const long long half = at & ww;
  const long long partner = run0 + (half ^ ww);
  const int partner_len = static_cast<int>(max(0ll, min(ww, want - partner)));
  const long long dst = at - half +
                        count_less_n(src_k + partner, src_i + partner, partner_len, k, i);
  if (out_key != nullptr) {
    out_key[dst] = static_cast<int64_t>(k ^ kSign);
    out_idx[dst] = i;
  } else {
    dst_k[dst] = k;
    dst_i[dst] = i;
  }
}

cudaLaunchConfig_t launch_config(int cluster, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kResident>
int prepare(int cluster, int smem, int* max_clusters) {
  cudaError_t e = cudaFuncSetAttribute(fill_take_kernel<kResident>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kMaxDynamicSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, smem, nullptr, &attr);
  e = cudaOccupancyMaxActiveClusters(max_clusters, fill_take_kernel<kResident>, &cfg);
  return static_cast<int>(e);
}

template <bool kResident>
int launch(const int64_t* key, int n, int want, int keys_per_cta, int cluster, int smem,
           int64_t* take_key, int32_t* take, unsigned char* scratch, cudaStream_t stream) {
  // The global path's scratch: keys A, keys B, indices A, indices B.
  uint64_t* ka = nullptr;
  uint64_t* kb = nullptr;
  int32_t* ia = nullptr;
  int32_t* ib = nullptr;
  if (scratch != nullptr) {
    ka = reinterpret_cast<uint64_t*>(scratch);
    kb = ka + want;
    ia = reinterpret_cast<int32_t*>(kb + want);
    ib = ia + want;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, smem, stream, &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, fill_take_kernel<kResident>, key, n, want,
                                     keys_per_cta, take_key, take, ka, ia);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || scratch == nullptr) return static_cast<int>(e);
  sort_runs_kernel<<<(want + kMaxTake - 1) / kMaxTake, kThreads, 0, stream>>>(ka, ia, want);
  e = cudaGetLastError();
  const int blocks = (want + kMergeThreads - 1) / kMergeThreads;
  for (long long w = kMaxTake; e == cudaSuccess && w < want; w *= 2) {
    const bool last = 2 * w >= want;
    merge_kernel<<<blocks, kMergeThreads, 0, stream>>>(ka, ia, kb, ib, want, static_cast<int>(w),
                                                       last ? take_key : nullptr,
                                                       last ? take : nullptr);
    e = cudaGetLastError();
    uint64_t* tk = ka;
    ka = kb;
    kb = tk;
    int32_t* ti = ia;
    ia = ib;
    ib = ti;
  }
  return static_cast<int>(e);
}

}  // namespace

// Once per device and launch shape: raise the kernel's dynamic shared
// memory limit and ask how many clusters of this shape can be resident at
// once (0: the shape does not fit). Returns a cudaError_t.
extern "C" int armada_fill_take_prepare(int cluster, int smem, int resident, int* max_clusters) {
  return resident ? prepare<true>(cluster, smem, max_clusters)
                  : prepare<false>(cluster, smem, max_clusters);
}

// take: want int32 indices; take_key: their want int64 keys; scratch: null
// for want <= kMaxTake, else 24 x want bytes (16-byte aligned) for the
// global sort.
extern "C" int armada_fill_take(const void* key, int n, int want, int keys_per_cta, int cluster,
                                int resident, int smem, void* take, void* take_key, void* scratch,
                                void* stream) {
  const int64_t* k = static_cast<const int64_t*>(key);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* tk = static_cast<int64_t*>(take_key);
  int32_t* ti = static_cast<int32_t*>(take);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  return resident ? launch<true>(k, n, want, keys_per_cta, cluster, smem, tk, ti, sc, s)
                  : launch<false>(k, n, want, keys_per_cta, cluster, smem, tk, ti, sc, s);
}
