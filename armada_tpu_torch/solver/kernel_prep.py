"""Host-side preparation of the device tensors for the torch round kernel.

Flattens a RoundSnapshot into fixed-shape arrays:

- The per-queue candidate order becomes a global *slot* table: one slot per
  gang (running gangs grouped for potential eviction, queued gangs from the
  snapshot's gang table), sorted by (queue, segment, order) where segment 0
  is the evicted stream and segment 1 the queued stream — mirroring the
  evicted-then-queued iterator chaining in the reference
  (preempting_queue_scheduler.go:719-726).
- Scheduling keys are interned into dense groups so the unfeasible-key skip
  (gang_scheduler.go:80-95) is a boolean table lookup on device.
- All quantities are int32 device lanes (requests ceil-scaled, allocatable
  floor-scaled by the factory's device divisors).

Shapes are static per snapshot; pad_device_round buckets J/N/S to powers
of two.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..snapshot.round import RoundSnapshot
from . import policy

NO_NODE = -1

# The static fields of a round: config constants and the paths the solve
# takes (Python branches in solver/kernel.py). Every other field is data,
# an array or a runtime scalar. A device-resident round
# (snapshot/residency.py) delta-syncs data fields only, and resets when
# one of these changes.
_META_FIELDS = (
    "protected_fraction",
    "max_lookback",
    "global_burst",
    "queue_burst",
    "prefer_large",
    "num_key_groups",
    "market_driven",
    "has_away",
    "batch_window",
    "fast_fill",
    "fill_groups",
    "order_key_bits",
    "fairness_policy",
    "kernel_path",
)


@dataclass
class DeviceRound:
    """Everything solve_round needs, as host numpy arrays and scalars;
    solver/kernel.py moves the arrays onto the solve's device."""

    # priorities
    priorities: np.ndarray  # int32[P]

    # nodes
    alloc0: np.ndarray  # int32[P, N, R]
    node_total: np.ndarray  # int32[N, R]
    node_taints: np.ndarray  # uint32[N, Wt]
    node_labels: np.ndarray  # uint32[N, Wl]
    node_id_rank: np.ndarray  # int32[N]
    node_unschedulable: np.ndarray  # bool[N]
    # Global node ids (arange(N)); under node sharding each shard holds its
    # slice, giving kernels the global id of every local node.
    node_gid: np.ndarray  # int32[N]
    order_res_idx: np.ndarray  # int32[K]
    order_res_resolution: np.ndarray  # int32[K]
    # Static bit width of each best-fit order key (allocatable // res of
    # an in-mask node is within [0, max node total // res]): lets the
    # fill sort fuse its K+1 keys into ONE packed int64 when they fit
    # (kernel._pack_fill_keys). Padding adds zero-total rows, node-axis
    # sharding only slices — neither raises the bound.
    order_key_bits: tuple  # int per order key

    # jobs
    job_req: np.ndarray  # int32[J, R] full requests (costs, accounting)
    job_req_fit: np.ndarray  # int32[J, R] floating columns zeroed (node fit)
    job_tolerated: np.ndarray  # uint32[J, Wt]
    job_selector: np.ndarray  # uint32[J, Wl]
    job_possible: np.ndarray  # bool[J]
    job_queue: np.ndarray  # int32[J]
    job_prio: np.ndarray  # int32[J]
    job_preemptible: np.ndarray  # bool[J]
    job_is_running: np.ndarray  # bool[J]
    job_node: np.ndarray  # int32[J]
    job_key_group: np.ndarray  # int32[J]
    job_pc: np.ndarray  # int32[J] priority-class index
    job_excluded_nodes: np.ndarray  # int32[J, K] retry anti-affinity
    job_affinity_group: np.ndarray  # int32[J]
    affinity_allowed: np.ndarray  # uint32[A, ceil(N/32)]
    # Slot containing this job as a member (-1 if none): the reverse of
    # slot_members, used by the hot-window gather (solver/hotwindow.py)
    # to test whether an evicted job's slot falls inside the window.
    job_slot: np.ndarray  # int32[J]

    # slots
    slot_members: np.ndarray  # int32[S, M] (-1 pad)
    slot_count: np.ndarray  # int32[S]
    slot_queue: np.ndarray  # int32[S]
    slot_is_running: np.ndarray  # bool[S]
    slot_req: np.ndarray  # int32[S, R]
    slot_key_group: np.ndarray  # int32[S] (-1 if N/A)
    slot_jobs_before: np.ndarray  # int32[S] queued jobs before this slot in its queue
    # Batched-fill runs: for each slot, the number of consecutive slots
    # (including itself) holding identical batchable singleton gangs — same
    # queue + scheduling key, no per-job anti-affinity. 0 = not batchable.
    slot_run_len: np.ndarray  # int32[S]
    # Fast-fill batchability per slot (heterogeneous window fill): queued
    # singleton, interned scheduling key, no anti-affinity/affinity/
    # uniformity. Unlike slot_run_len, neighbours need NOT share a key.
    slot_batchable: np.ndarray  # bool[S]
    # Gang node-uniformity search (gang_scheduler.go:150-224): per slot a
    # range [start, end) into the uniformity-value table; start==end means
    # no uniformity constraint. Each value is a selector bitset.
    slot_uni_start: np.ndarray  # int32[S]
    slot_uni_end: np.ndarray  # int32[S]
    slot_price: np.ndarray  # float[S] market gang price (min member bid)
    # Cross-pool away slot: members are away jobs (floating-resource
    # limits were checked by their home pool's round; skip here —
    # context/scheduling.go:546-557).
    slot_away: np.ndarray  # bool[S]
    uni_value_bits: np.ndarray  # uint32[V, Wl]
    queue_slot_start: np.ndarray  # int32[Q]
    queue_slot_end: np.ndarray  # int32[Q]

    # queues
    queue_weight: np.ndarray  # float[Q]
    queue_cordoned: np.ndarray  # bool[Q]
    queue_name_rank: np.ndarray  # int32[Q]
    queue_alloc0: np.ndarray  # sum[Q, R] running allocation (device units)
    queue_short_penalty: np.ndarray  # sum[Q, R] anti-churn cost add-on
    queue_demand_pc: np.ndarray  # sum[Q, C, R] demand by priority class
    queue_pc_limit: np.ndarray  # float[Q, C, R] caps (+inf none)

    # priority classes
    pc_priority: np.ndarray  # int32[C]
    pc_preemptible: np.ndarray  # bool[C]
    # Away scheduling tables (nodedb.go:487-501)
    pc_away_count: np.ndarray  # int32[C]
    pc_away_prio: np.ndarray  # int32[C, Amax]
    pc_away_tol: np.ndarray  # uint32[C, Amax, Wt]

    # totals / limits
    total_resources: np.ndarray  # float[R]
    drf_multipliers: np.ndarray  # float[R]
    max_round_resources: np.ndarray  # float[R]
    floating_mask: np.ndarray  # bool[R]
    floating_total: np.ndarray  # float[R] pool caps (device units)

    # scalars (static or runtime)
    protected_fraction: float
    max_lookback: int
    global_burst: int
    queue_burst: int
    global_tokens: float
    queue_tokens: np.ndarray  # float[Q]
    prefer_large: bool
    num_key_groups: int
    market_driven: bool
    has_away: bool
    batch_window: int
    fast_fill: bool
    fill_groups: int
    spot_price_cutoff: np.ndarray  # float scalar
    job_bid: np.ndarray  # float64[J]

    # Pluggable fairness (solver/policy.py). queue_deadline is the
    # earliest job deadline per queue (+inf when absent; None is allowed
    # when the policy ignores deadlines — only the deadline-specialized
    # program reads it, and prep always materializes it). fairness_policy
    # is the spec tuple (solver/policy.py): ("drf",), ("proportional",),
    # ("priority",) or ("deadline", boost, horizon); the port solves each.
    queue_deadline: np.ndarray | None = None  # float64[Q]
    fairness_policy: tuple = ("drf",)
    # Solve-kernel selection (ops/kernels.py): "lax" runs the unfused
    # reference graph; "cuda" fuses the pass-1 scoring chain and swaps the
    # fill sort for the top-B selection.
    kernel_path: str = "cuda"


def _shrink(arr: np.ndarray, kept: np.ndarray, size: int, fill=0) -> np.ndarray:
    """Filter rows by index list, re-padding to `size` rows."""
    out = np.full((size, *arr.shape[1:]), fill, dtype=arr.dtype)
    out[: len(kept)] = arr[kept]
    return out


def _pow2(n: int, floor: int = 8) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def pad_device_round(dev: DeviceRound) -> DeviceRound:
    """Pad J/N/S/Q/M axes to powers of two so differently sized snapshots
    share compiled programs. Padded entries are inert:

    - nodes: unschedulable, zero resources, id-rank after all real nodes
    - jobs: impossible, queue -1, bound nowhere
    - slots: count 0 (validity and rank assignment skip count-0 slots)
    - queues: weight 0, no demand, no slot range (start=end=0)
    """
    J, R = dev.job_req.shape
    N = dev.node_total.shape[0]
    S, M = dev.slot_members.shape
    Q = dev.queue_weight.shape[0]
    P = dev.priorities.shape[0]
    Jp, Np, Sp, Qp, Mp = _pow2(J), _pow2(N), _pow2(S), _pow2(Q, 2), _pow2(M, 1)
    Gp = _pow2(dev.num_key_groups, 8)
    if (Jp, Np, Sp, Qp, Mp, Gp) == (J, N, S, Q, M, dev.num_key_groups):
        _assert_pad_rows_inert(dev, J, S)
        return dev

    def pad(arr, axis, n_new, fill=0):
        arr = np.asarray(arr)
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, n_new - arr.shape[axis])
        return np.pad(arr, widths, constant_values=fill)

    out = dataclasses.replace(
        dev,
        alloc0=pad(dev.alloc0, 1, Np),
        node_total=pad(dev.node_total, 0, Np),
        node_taints=pad(dev.node_taints, 0, Np),
        node_labels=pad(dev.node_labels, 0, Np),
        node_id_rank=np.concatenate(
            [np.asarray(dev.node_id_rank), np.arange(N, Np, dtype=np.int32)]
        ),
        node_unschedulable=pad(dev.node_unschedulable, 0, Np, fill=True),
        node_gid=np.arange(Np, dtype=np.int32),
        job_req=pad(dev.job_req, 0, Jp),
        job_req_fit=pad(dev.job_req_fit, 0, Jp),
        job_tolerated=pad(dev.job_tolerated, 0, Jp),
        job_selector=pad(dev.job_selector, 0, Jp),
        job_possible=pad(dev.job_possible, 0, Jp, fill=False),
        job_queue=pad(dev.job_queue, 0, Jp, fill=-1),
        job_prio=pad(dev.job_prio, 0, Jp),
        job_preemptible=pad(dev.job_preemptible, 0, Jp, fill=False),
        job_is_running=pad(dev.job_is_running, 0, Jp, fill=False),
        job_node=pad(dev.job_node, 0, Jp, fill=NO_NODE),
        job_key_group=pad(dev.job_key_group, 0, Jp, fill=-1),
        job_pc=pad(dev.job_pc, 0, Jp),
        job_excluded_nodes=pad(dev.job_excluded_nodes, 0, Jp, fill=-1),
        job_affinity_group=pad(dev.job_affinity_group, 0, Jp, fill=-1),
        job_slot=pad(dev.job_slot, 0, Jp, fill=-1),
        affinity_allowed=pad(
            pad(dev.affinity_allowed, 1, (Np + 31) // 32),
            0,
            _pow2(dev.affinity_allowed.shape[0], 1),
        ),
        slot_members=pad(pad(dev.slot_members, 1, Mp, fill=-1), 0, Sp, fill=-1),
        slot_count=pad(dev.slot_count, 0, Sp),
        slot_queue=pad(dev.slot_queue, 0, Sp, fill=-1),
        slot_is_running=pad(dev.slot_is_running, 0, Sp, fill=False),
        slot_req=pad(dev.slot_req, 0, Sp),
        slot_key_group=pad(dev.slot_key_group, 0, Sp, fill=-1),
        slot_jobs_before=pad(dev.slot_jobs_before, 0, Sp),
        slot_run_len=pad(dev.slot_run_len, 0, Sp),
        slot_batchable=pad(dev.slot_batchable, 0, Sp, fill=False),
        slot_uni_start=pad(dev.slot_uni_start, 0, Sp),
        slot_uni_end=pad(dev.slot_uni_end, 0, Sp),
        slot_price=pad(dev.slot_price, 0, Sp),
        slot_away=pad(dev.slot_away, 0, Sp, fill=False),
        job_bid=pad(dev.job_bid, 0, Jp),
        queue_slot_start=pad(dev.queue_slot_start, 0, Qp),
        queue_slot_end=pad(dev.queue_slot_end, 0, Qp),
        queue_weight=pad(dev.queue_weight, 0, Qp),
        queue_cordoned=pad(dev.queue_cordoned, 0, Qp, fill=False),
        queue_name_rank=np.concatenate(
            [np.asarray(dev.queue_name_rank), np.arange(Q, Qp, dtype=np.int32)]
        ),
        queue_alloc0=pad(dev.queue_alloc0, 0, Qp),
        queue_short_penalty=pad(dev.queue_short_penalty, 0, Qp),
        queue_demand_pc=pad(dev.queue_demand_pc, 0, Qp),
        queue_pc_limit=pad(dev.queue_pc_limit, 0, Qp, fill=np.inf),
        queue_tokens=pad(dev.queue_tokens, 0, Qp),
        queue_deadline=(
            pad(dev.queue_deadline, 0, Qp, fill=np.inf)
            if dev.queue_deadline is not None
            else None
        ),
        num_key_groups=Gp,
    )
    _assert_pad_rows_inert(out, J, S)
    return out


def _assert_pad_rows_inert(dev: DeviceRound, n_jobs: int, n_slots: int):
    """Every padded row must be masked out of the kernel's predicates:
    pad jobs impossible (no select/fill can choose them) and pad slots
    count-0 (validity and rank assignment skip them). The hot-window
    gather (solver/hotwindow.py) builds its compacted axes straight off
    these tables, so a live pad row would silently join a window."""
    assert not np.asarray(dev.job_possible[n_jobs:]).any(), (
        "pad_device_round: padded job rows leaked into job_possible"
    )
    assert not (np.asarray(dev.slot_count[n_slots:]) > 0).any(), (
        "pad_device_round: padded slot rows carry a nonzero slot_count"
    )


@dataclass
class PrepCache:
    """Precomputed per-job/per-queue tensors for the incremental path.

    `snapshot.incremental.IncrementalRound` maintains these across cycles
    (O(delta) updates); passing them here skips the O(J) recompute blocks —
    the key-group interning lexsort, the pc-name resolution listcomp, the
    request device-scaling, and the queue-demand bincounts — which dominate
    warm prep at 1M jobs.
    """

    req_dev: np.ndarray  # int32[J, R]
    req_fit_dev: np.ndarray  # int32[J, R]
    job_pc: np.ndarray  # int32[J]
    job_key_group: np.ndarray  # int32[J] (-1 for running)
    num_key_groups: int
    queue_alloc0: np.ndarray  # int64[Q, R] device units
    queue_demand_pc: np.ndarray  # int64[Q, C, R] device units


def compute_key_groups(
    job_queue: np.ndarray,
    job_priority: np.ndarray,
    job_pc: np.ndarray,
    job_req: np.ndarray,
    job_tolerated: np.ndarray,
    job_selector: np.ndarray,
    qm: np.ndarray,
) -> tuple[np.ndarray, int]:
    """Scheduling-key grouping over the row subset `qm` (non-running jobs):
    intern (queue, priority, pc, requests, tolerations, selector) tuples
    into dense group ids via a column lexsort + adjacent-difference pass.

    Shared by the cold prep path and the incremental state's adoption /
    compaction (snapshot/incremental.py) so the two can never diverge.
    Returns (int32[J] group per row, -1 off-subset; group count)."""
    J = len(job_queue)
    job_key_group = np.full(J, -1, dtype=np.int32)
    if not len(qm):
        return job_key_group, 1
    cols = [
        job_queue[qm].astype(np.int64),
        job_priority[qm].astype(np.int64),
        job_pc[qm].astype(np.int64),
    ]
    cols += [job_req[qm, r].astype(np.int64) for r in range(job_req.shape[1])]
    cols += [
        job_tolerated[qm, c].astype(np.int64)
        for c in range(job_tolerated.shape[1])
    ]
    cols += [
        job_selector[qm, c].astype(np.int64)
        for c in range(job_selector.shape[1])
    ]
    order = np.lexsort(cols[::-1])
    new_group = np.zeros(len(qm), dtype=bool)
    new_group[0] = True
    for col in cols:
        sorted_col = col[order]
        new_group[1:] |= sorted_col[1:] != sorted_col[:-1]
    gid_sorted = np.cumsum(new_group, dtype=np.int64) - 1
    inverse = np.empty(len(qm), dtype=np.int32)
    inverse[order] = gid_sorted.astype(np.int32)
    job_key_group[qm] = inverse
    return job_key_group, int(gid_sorted[-1]) + 1


def compute_queue_device_accounting(
    job_queue: np.ndarray,
    job_pc: np.ndarray,
    job_is_running: np.ndarray,
    req_dev: np.ndarray,
    Q: int,
    C: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(queue_alloc0[Q,R], queue_demand_pc[Q,C,R]) in device units — the
    running allocation and by-priority-class demand bincounts. Shared by
    the cold prep path and the incremental state's adoption."""
    R = req_dev.shape[1] if req_dev.ndim == 2 else 0
    queue_alloc0 = np.zeros((Q, R), dtype=np.int64)
    queue_demand_pc = np.zeros((Q, C, R), dtype=np.int64)
    J = len(job_queue)
    if not (J and Q):
        return queue_alloc0, queue_demand_pc
    valid = job_queue >= 0
    qidx = np.where(valid, job_queue, 0).astype(np.int64)
    seg = qidx * C + job_pc
    run_w = valid & job_is_running
    for r in range(R):
        col = req_dev[:, r].astype(np.float64)
        queue_demand_pc[:, :, r] = (
            np.bincount(seg, weights=np.where(valid, col, 0.0), minlength=Q * C)
            .reshape(Q, C)
            .astype(np.int64)
        )
        queue_alloc0[:, r] = np.bincount(
            qidx, weights=np.where(run_w, col, 0.0), minlength=Q
        )[:Q].astype(np.int64)
    return queue_alloc0, queue_demand_pc


def fill_fields(cfg) -> dict:
    """The DeviceRound fields that the fill options of a SchedulingConfig
    set: `batch_window`, `fast_fill` and `fill_groups`."""
    return dict(
        batch_window=(0 if cfg.market_driven else int(cfg.batch_fill_window)),
        fast_fill=bool(cfg.enable_fast_fill) and not cfg.market_driven,
        # A window of batch_fill_window entries holds at most that many
        # distinct keys; more groups would be dead scan iterations.
        fill_groups=max(
            1, min(int(cfg.fill_group_max), max(1, int(cfg.batch_fill_window)))
        ),
    )


def prep_device_round(
    snap: RoundSnapshot, cache: PrepCache | None = None
) -> DeviceRound:
    cfg = snap.config
    factory = snap.factory
    J, N, Q = snap.num_jobs, snap.num_nodes, snap.num_queues
    R = factory.num_resources
    P = snap.num_priorities

    if cache is not None:
        req_dev = cache.req_dev
        req_fit_dev = cache.req_fit_dev
    else:
        req_dev = factory.to_device(snap.job_req, ceil=True)
        req_fit_dev = factory.to_device(snap.job_req_fit(), ceil=True)
    alloc_dev = factory.to_device(snap.allocatable, ceil=False)
    total_dev = factory.to_device(snap.node_total, ceil=False)

    # Priority classes.
    pc_names = list(cfg.priority_classes)
    pc_index = {n: i for i, n in enumerate(pc_names)}
    C = len(pc_names)
    pc_priority = np.asarray(
        [cfg.priority_classes[n].priority for n in pc_names], dtype=np.int32
    )
    pc_preemptible = np.asarray(
        [cfg.priority_classes[n].preemptible for n in pc_names], dtype=bool
    )
    job_pc = (
        cache.job_pc
        if cache is not None
        else np.asarray([pc_index[n] for n in snap.job_pc_name], dtype=np.int32)
    )

    # Scheduling-key groups over non-running jobs: intern the tuple of
    # (queue, priority, pc, requests, tolerations, selector) per job.
    # lexsort over the native int columns, not np.unique(axis=0): the
    # latter argsorts a void byte-record with memcmp comparisons and
    # dominated 1M-job prep (7.6s of a 9.1s warm prep); the column
    # lexsort + adjacent-difference grouping computes the identical
    # inverse in a fraction of the time.
    if cache is not None:
        job_key_group = cache.job_key_group
        num_key_groups = max(1, cache.num_key_groups)
    else:
        job_key_group, num_key_groups = compute_key_groups(
            snap.job_queue,
            snap.job_priority,
            job_pc,
            snap.job_req,
            snap.job_tolerated,
            snap.job_selector,
            np.flatnonzero(~snap.job_is_running),
        )

    # ---- slots ----
    # Segment 0: running gangs (eviction candidates), grouped by gang id.
    # Segment 1: queued gangs from the snapshot gang table (complete only).
    # Built columnar: the overwhelming bulk (singleton candidates) is pure
    # array work; only multi-member gangs take per-gang Python paths, so a
    # 1M-singleton round preps in vectorized time.
    rj = np.flatnonzero(
        snap.job_is_running
        & (snap.job_queue >= 0)
        # Unbound away jobs (runs on nodes outside this round) contribute
        # fairness pressure only — never candidacy (populateNodeDb skips
        # them, scheduling_algo.go:936-938).
        & ~(snap.job_away & (snap.job_node < 0))
    )
    r_gids = (
        np.asarray(snap.job_gang_id, dtype=object)[rj]
        if len(rj)
        else np.zeros(0, dtype=object)
    )
    r_has_gid = np.asarray([bool(g) for g in r_gids], dtype=bool)
    r_single = rj[~r_has_gid]

    # Running gang groups (rare): per-gang Python grouping.
    running_groups: dict = {}
    for j in rj[r_has_gid]:
        j = int(j)
        running_groups.setdefault(
            (int(snap.job_queue[j]), snap.job_gang_id[j]), []
        ).append(j)
    rg_members = [
        sorted(m, key=lambda x: snap.job_order[x])
        for m in running_groups.values()
    ]

    # Queued gangs straight off the gang table (first member of a queued
    # gang row is never running: running jobs get their own rows).
    g_first = (
        snap.gang_members[snap.gang_member_offsets[:-1]]
        if snap.num_gangs
        else np.zeros(0, dtype=np.int32)
    )
    g_mask = (
        snap.gang_complete
        & (snap.gang_queue >= 0)
        & ~snap.job_is_running[g_first]
    )
    g_sizes = np.diff(snap.gang_member_offsets)
    q_single_g = np.flatnonzero(g_mask & (g_sizes == 1))
    q_single = snap.gang_members[snap.gang_member_offsets[:-1][q_single_g]]
    q_multi_g = np.flatnonzero(g_mask & (g_sizes > 1))

    # Columnar candidate table: [running singles | running gangs |
    # queued singles | queued gangs], flattened members alongside.
    n_rs, n_rg = len(r_single), len(rg_members)
    n_qs, n_qg = len(q_single), len(q_multi_g)
    cand_queue = np.concatenate(
        [
            snap.job_queue[r_single],
            np.asarray(
                [q for (q, _) in running_groups], dtype=np.int32
            ).reshape(n_rg),
            snap.gang_queue[q_single_g] if n_qs else np.zeros(0, np.int32),
            snap.gang_queue[q_multi_g] if n_qg else np.zeros(0, np.int32),
        ]
    ).astype(np.int32)
    cand_segment = np.concatenate(
        [
            np.zeros(n_rs + n_rg, dtype=np.int8),
            np.ones(n_qs + n_qg, dtype=np.int8),
        ]
    )
    cand_order = np.concatenate(
        [
            snap.job_order[r_single],
            np.asarray(
                [max(snap.job_order[m] for m in ms) for ms in rg_members],
                dtype=np.int64,
            ).reshape(n_rg),
            snap.gang_order[q_single_g] if n_qs else np.zeros(0, np.int64),
            snap.gang_order[q_multi_g] if n_qg else np.zeros(0, np.int64),
        ]
    ).astype(np.int64)
    cand_running = np.zeros(n_rs + n_rg + n_qs + n_qg, dtype=bool)
    cand_running[: n_rs + n_rg] = True
    cand_kg = np.concatenate(
        [
            np.full(n_rs + n_rg, -1, dtype=np.int32),
            job_key_group[q_single] if n_qs else np.zeros(0, np.int32),
            np.full(n_qg, -1, dtype=np.int32),
        ]
    ).astype(np.int32)
    cand_counts = np.concatenate(
        [
            np.ones(n_rs, dtype=np.int32),
            np.asarray([len(ms) for ms in rg_members], dtype=np.int32).reshape(
                n_rg
            ),
            np.ones(n_qs, dtype=np.int32),
            g_sizes[q_multi_g].astype(np.int32)
            if n_qg
            else np.zeros(0, np.int32),
        ]
    )
    flat_members = np.concatenate(
        [
            r_single.astype(np.int32),
            np.asarray(
                [m for ms in rg_members for m in ms], dtype=np.int32
            ),
            q_single.astype(np.int32),
            np.concatenate(
                [
                    snap.gang_members[
                        snap.gang_member_offsets[g] : snap.gang_member_offsets[
                            g + 1
                        ]
                    ]
                    for g in q_multi_g
                ]
            ).astype(np.int32)
            if n_qg
            else np.zeros(0, np.int32),
        ]
    )
    # Uniformity keys: only multi-member queued gangs carry one.
    cand_uni_multi = [snap.gang_uniformity_key[int(g)] for g in q_multi_g]

    # Uniformity-value table: sorted values per key, as selector bitsets
    # (mirrors the oracle's sorted-value iteration).
    uni_ranges: dict[str, tuple[int, int]] = {}
    uni_bits_rows: list[np.ndarray] = []
    for key in {u for u in cand_uni_multi if u}:
        values = sorted({v for (k, v) in snap.label_vocab.pairs if k == key})
        start = len(uni_bits_rows)
        for value in values:
            bits, possible = snap.label_vocab.selector_bits({key: value})
            if possible:
                uni_bits_rows.append(bits)
        if len(uni_bits_rows) == start:
            # No node carries this label: the gang can never satisfy its
            # uniformity constraint ("no nodes with uniformity label",
            # gang_scheduler.go:171-175). Sentinel (-1,-1) fails the slot.
            uni_ranges[key] = (-1, -1)
        else:
            uni_ranges[key] = (start, len(uni_bits_rows))

    n_cand = len(cand_queue)
    S = max(1, n_cand)
    counts = cand_counts
    M = int(counts.max()) if n_cand else 1
    M = max(1, M)
    cand_offsets = np.zeros(n_cand + 1, dtype=np.int64)
    np.cumsum(counts, out=cand_offsets[1:])

    # Market mode merges evicted and queued candidates by price-rank order
    # (MarketDrivenMultiJobsIterator) instead of evicted-first chaining.
    seg_for_sort = (
        np.zeros(n_cand, dtype=np.int8) if cfg.market_driven else cand_segment
    )
    order_perm = (
        np.lexsort((cand_order, seg_for_sort, cand_queue))
        if n_cand
        else np.zeros(0, dtype=np.int64)
    )

    slot_members = np.full((S, M), -1, dtype=np.int32)
    slot_count = np.zeros(S, dtype=np.int32)
    slot_queue = np.full(S, -1, dtype=np.int32)
    slot_is_running = np.zeros(S, dtype=bool)
    slot_req = np.zeros((S, R), dtype=np.int32)
    slot_key_group = np.full(S, -1, dtype=np.int32)
    slot_jobs_before = np.zeros(S, dtype=np.int32)
    slot_uni_start = np.zeros(S, dtype=np.int32)
    slot_uni_end = np.zeros(S, dtype=np.int32)
    slot_price = np.zeros(S, dtype=np.float64)
    slot_away = np.zeros(S, dtype=bool)
    queue_slot_start = np.zeros(Q, dtype=np.int32)
    queue_slot_end = np.zeros(Q, dtype=np.int32)

    if n_cand:
        slot_queue[:n_cand] = cand_queue[order_perm]
        slot_count[:n_cand] = counts[order_perm]
        slot_is_running[:n_cand] = cand_running[order_perm]
        slot_key_group[:n_cand] = cand_kg[order_perm]

        # Member ranges flattened in sorted-slot order (pure gathers).
        counts_sorted = counts[order_perm].astype(np.int64)
        starts = np.zeros(n_cand, dtype=np.int64)
        starts[1:] = np.cumsum(counts_sorted)[:-1]
        rows = np.repeat(np.arange(n_cand), counts_sorted)
        cols = np.arange(len(flat_members)) - starts[rows]
        src_starts = cand_offsets[:-1][order_perm]
        flat = flat_members[(src_starts[rows] + cols).astype(np.int64)]
        slot_members[rows, cols.astype(np.int64)] = flat
        slot_req[:n_cand] = np.add.reduceat(
            req_dev[flat].astype(np.int64), starts
        ).astype(np.int32)
        slot_price[:n_cand] = np.minimum.reduceat(snap.job_bid[flat], starts)
        slot_away[:n_cand] = snap.job_away[
            np.clip(slot_members[:n_cand, 0], 0, max(J - 1, 0))
        ]

        # Uniformity ranges: only multi-member queued gangs carry one.
        if n_qg:
            inv_perm = np.empty(n_cand, dtype=np.int64)
            inv_perm[order_perm] = np.arange(n_cand)
            base = n_rs + n_rg + n_qs
            for gi, uni in enumerate(cand_uni_multi):
                if uni:
                    pos = inv_perm[base + gi]
                    slot_uni_start[pos], slot_uni_end[pos] = uni_ranges[uni]

        # Lookback accounting: queued jobs in earlier slots of the same
        # queue. Exclusive cumsum of queued member counts, rebased per queue.
        qcounts = np.where(slot_is_running[:n_cand], 0, slot_count[:n_cand])
        cs = np.cumsum(qcounts) - qcounts
        sq = slot_queue[:n_cand]
        first_of_queue = np.searchsorted(sq, sq, side="left")
        slot_jobs_before[:n_cand] = (cs - cs[first_of_queue]).astype(np.int32)

        queue_slot_start[:] = np.searchsorted(sq, np.arange(Q), side="left")
        queue_slot_end[:] = np.searchsorted(sq, np.arange(Q), side="right")

        # Queued slots past the lookback horizon can never yield this round
        # (stopYieldingNewJobsIfLimitHit): drop them to shrink S. Dropped
        # slots are only ever at the tail of a queue's queued segment, so
        # prefix counts and queue ranges stay consistent after rebasing.
        lookback = cfg.max_queue_lookback
        if lookback and n_cand:
            keep = slot_is_running[:n_cand] | (
                slot_jobs_before[:n_cand] < lookback
            )
            # The kernel masks past-lookback slots itself (kernel.py:599
            # stopYieldingNewJobsIfLimitHit); this shrink only exists to
            # reduce S. Re-padding ~10 S-sized arrays to drop a tail
            # sliver costs more than it saves, so shrink only when it
            # changes the padded program shape.
            n_keep = int(keep.sum())
            if n_keep < n_cand and _pow2(max(1, n_keep)) < _pow2(S):
                kept = np.flatnonzero(keep)
                n_new = len(kept)
                S = max(1, n_new)
                slot_members = _shrink(slot_members, kept, S)
                slot_count = _shrink(slot_count, kept, S)
                sq = slot_queue[:n_cand][keep]
                slot_queue = _shrink(slot_queue, kept, S, fill=-1)
                slot_is_running = _shrink(slot_is_running, kept, S)
                slot_req = _shrink(slot_req, kept, S)
                slot_key_group = _shrink(slot_key_group, kept, S, fill=-1)
                slot_jobs_before = _shrink(slot_jobs_before, kept, S)
                slot_uni_start = _shrink(slot_uni_start, kept, S)
                slot_uni_end = _shrink(slot_uni_end, kept, S)
                slot_price = _shrink(slot_price, kept, S)
                slot_away = _shrink(slot_away, kept, S)
                queue_slot_start[:] = np.searchsorted(sq, np.arange(Q), side="left")
                queue_slot_end[:] = np.searchsorted(sq, np.arange(Q), side="right")

    # Batched-fill run lengths: maximal runs of consecutive batchable slots
    # (same queue + scheduling key, singleton, no per-job anti-affinity).
    # The kernel's fill fast path places a whole prefix of such a run in one
    # loop iteration (kernel.py _fill_branch); 0 marks non-batchable slots.
    slot_run_len = np.zeros(S, dtype=np.int32)
    slot_batchable = np.zeros(S, dtype=bool)
    n_live = int(np.count_nonzero(slot_queue >= 0))
    if n_live and not cfg.market_driven and cfg.batch_fill_window > 0:
        j0 = np.clip(slot_members[:n_live, 0], 0, max(J - 1, 0))
        elig = (
            (slot_count[:n_live] == 1)
            & ~slot_is_running[:n_live]
            & (slot_key_group[:n_live] >= 0)
            & (slot_uni_end[:n_live] <= slot_uni_start[:n_live])
            & (snap.job_excluded_nodes[j0] < 0).all(axis=1)
            & (snap.job_affinity_group[j0] < 0)
        )
        if cfg.max_queue_lookback:
            # Batched fill runs place whole prefixes without per-slot
            # lookback validity checks; past-lookback slots must never be
            # batchable (they used to be shrunk away unconditionally —
            # the shrink is now gated on padded-shape reduction).
            elig &= slot_jobs_before[:n_live] < cfg.max_queue_lookback
        slot_batchable[:n_live] = elig
        same = (
            elig[1:]
            & elig[:-1]
            & (slot_queue[1:n_live] == slot_queue[: n_live - 1])
            & (slot_key_group[1:n_live] == slot_key_group[: n_live - 1])
        )
        break_after = np.ones(n_live, dtype=bool)
        break_after[:-1] = ~same
        ends = np.flatnonzero(break_after)
        k = np.searchsorted(ends, np.arange(n_live))
        slot_run_len[:n_live] = np.where(
            elig, ends[k] + 1 - np.arange(n_live), 0
        )

    # Reverse member map for the hot-window gather: the slot each job is a
    # member of (-1 for jobs in no slot, e.g. lookback-shrunk tails).
    # Computed from the FINAL slot table so shrinking cannot leave stale
    # slot ids behind.
    job_slot = np.full(J, -1, dtype=np.int32)
    mem_valid = slot_members >= 0
    if mem_valid.any():
        job_slot[slot_members[mem_valid]] = np.nonzero(mem_valid)[0].astype(
            np.int32
        )

    # ---- queue tensors ----
    queue_name_rank = np.argsort(np.argsort(snap.queue_names)).astype(np.int32)
    if cache is not None:
        queue_alloc0 = cache.queue_alloc0
        queue_demand_pc = cache.queue_demand_pc
    else:
        queue_alloc0, queue_demand_pc = compute_queue_device_accounting(
            snap.job_queue, job_pc, snap.job_is_running, req_dev, Q, C
        )

    queue_pc_limit = np.full((Q, C, R), np.inf)
    # Canonical pool totals in device units (floating columns = pool caps,
    # not node sums) — shared by DRF, per-queue caps and round limits.
    div = np.asarray(factory.device_divisor, dtype=np.float64)
    total_dev_sum = snap.total_resources.astype(np.float64) / div
    for ci, name in enumerate(pc_names):
        pc = cfg.priority_classes[name]
        fractions = dict(pc.maximum_resource_fraction_per_queue)
        fractions.update(pc.maximum_resource_fraction_per_queue_by_pool.get(snap.pool, {}))
        for rname, frac in fractions.items():
            ri = factory.name_to_index.get(rname)
            if ri is not None:
                queue_pc_limit[:, ci, ri] = frac * total_dev_sum[ri]

    max_round = np.full(R, np.inf)
    for rname, frac in cfg.maximum_resource_fraction_to_schedule.items():
        ri = factory.name_to_index.get(rname)
        if ri is not None:
            max_round[ri] = frac * total_dev_sum[ri]

    floating_mask = snap.floating_mask
    floating_total_dev = np.where(
        floating_mask, snap.floating_total.astype(np.float64) / div, 0.0
    )

    # Candidate-order resolutions in device units, plus each key's static
    # bit width (max possible rounded-allocatable of any node).
    order_res = []
    order_key_bits = []
    for k, ri in enumerate(snap.order_res_idx):
        host_res = int(snap.order_res_resolution[k])
        dev_res = max(1, host_res // int(factory.device_divisor[ri]))
        order_res.append(dev_res)
        max_total = int(total_dev[:, ri].max()) if N else 0
        order_key_bits.append(max(1, (max(max_total, 0) // dev_res).bit_length()))

    mult = snap.drf_multipliers()

    limits = cfg.rate_limits
    return DeviceRound(
        priorities=snap.priorities.astype(np.int32),
        alloc0=alloc_dev,
        node_total=total_dev,
        node_taints=snap.node_taint_bits,
        node_labels=snap.node_label_bits,
        node_id_rank=snap.node_id_rank,
        node_unschedulable=snap.node_unschedulable,
        node_gid=np.arange(N, dtype=np.int32),
        order_res_idx=snap.order_res_idx.astype(np.int32),
        order_res_resolution=np.asarray(order_res, dtype=np.int32),
        order_key_bits=tuple(order_key_bits),
        job_req=req_dev,
        job_req_fit=req_fit_dev,
        job_tolerated=snap.job_tolerated,
        job_selector=snap.job_selector,
        job_possible=snap.job_possible,
        job_queue=snap.job_queue,
        job_prio=snap.job_priority.astype(np.int32),
        job_preemptible=snap.job_preemptible,
        job_is_running=snap.job_is_running,
        job_node=snap.job_node.astype(np.int32),
        job_key_group=job_key_group,
        job_pc=job_pc,
        job_excluded_nodes=snap.job_excluded_nodes,
        job_affinity_group=snap.job_affinity_group,
        affinity_allowed=snap.affinity_allowed,
        job_slot=job_slot,
        slot_members=slot_members,
        slot_count=slot_count,
        slot_queue=slot_queue,
        slot_is_running=slot_is_running,
        slot_req=slot_req,
        slot_key_group=slot_key_group,
        slot_jobs_before=slot_jobs_before,
        slot_run_len=slot_run_len,
        slot_batchable=slot_batchable,
        slot_uni_start=slot_uni_start,
        slot_uni_end=slot_uni_end,
        slot_price=slot_price,
        slot_away=slot_away,
        uni_value_bits=(
            np.stack(uni_bits_rows)
            if uni_bits_rows
            else np.zeros((1, snap.label_vocab.n_words), dtype=np.uint32)
        ),
        queue_slot_start=queue_slot_start,
        queue_slot_end=queue_slot_end,
        queue_weight=snap.queue_weight,
        queue_cordoned=snap.queue_cordoned,
        queue_name_rank=queue_name_rank,
        queue_alloc0=queue_alloc0,
        queue_short_penalty=factory.to_device(
            snap.queue_short_penalty, ceil=True
        ).astype(np.int64),
        queue_demand_pc=queue_demand_pc,
        queue_pc_limit=queue_pc_limit,
        pc_priority=pc_priority,
        pc_preemptible=pc_preemptible,
        pc_away_count=snap.pc_away_count,
        pc_away_prio=snap.pc_away_prio,
        pc_away_tol=snap.pc_away_tol,
        total_resources=total_dev_sum,
        drf_multipliers=mult,
        max_round_resources=max_round,
        floating_mask=floating_mask,
        floating_total=floating_total_dev,
        protected_fraction=cfg.protected_fraction_of_fair_share,
        max_lookback=cfg.max_queue_lookback,
        global_burst=limits.maximum_scheduling_burst,
        queue_burst=limits.maximum_per_queue_scheduling_burst,
        global_tokens=(
            float(limits.maximum_scheduling_burst)
            if snap.global_rate_tokens is None
            else min(
                float(snap.global_rate_tokens),
                float(limits.maximum_scheduling_burst),
            )
        ),
        queue_tokens=np.asarray(
            [
                min(
                    float(
                        (snap.queue_rate_tokens or {}).get(
                            name, limits.maximum_per_queue_scheduling_burst
                        )
                    ),
                    float(limits.maximum_per_queue_scheduling_burst),
                )
                for name in snap.queue_names
            ],
            dtype=np.float64,
        ),
        prefer_large=cfg.enable_prefer_large_job_ordering,
        num_key_groups=num_key_groups,
        market_driven=cfg.market_driven,
        has_away=bool(snap.pc_away_count.any()),
        **fill_fields(cfg),
        spot_price_cutoff=np.float64(cfg.spot_price_cutoff),
        job_bid=snap.job_bid,
        queue_deadline=(
            np.asarray(snap.queue_deadline, dtype=np.float64)
            if snap.queue_deadline is not None
            else np.full(Q, np.inf, dtype=np.float64)
        ),
        fairness_policy=policy.spec_from_config(cfg, snap.pool),
        kernel_path=cfg.solve_kernel_path,
    )


# Reference kernel paths that fuse the scoring and the top-B selection;
# each maps onto this port's "cuda" path.
_FUSED_REFERENCE_PATHS = ("blocked", "pallas", "native")


def from_reference_round(fields: dict) -> DeviceRound:
    """The port's DeviceRound from another DeviceRound's fields
    (`dataclasses.asdict` of the JAX package's padded round, as numpy
    arrays and scalars), so both solvers consume one padded round.
    Kernel paths map as "lax" -> "lax" and "blocked"/"pallas"/"native"
    -> "cuda"."""
    names = {f.name for f in dataclasses.fields(DeviceRound)}
    kw = {k: v for k, v in fields.items() if k in names}
    missing = names - set(kw) - {"queue_deadline", "fairness_policy", "kernel_path"}
    if missing:
        raise ValueError(f"from_reference_round: missing fields {sorted(missing)}")
    path = str(kw.get("kernel_path", "lax"))
    if path in _FUSED_REFERENCE_PATHS:
        path = "cuda"
    if path not in ("lax", "cuda"):
        raise ValueError(f"from_reference_round: unknown kernel_path {path!r}")
    kw["kernel_path"] = path
    for k, v in kw.items():
        if isinstance(v, np.ndarray):
            kw[k] = np.array(v, copy=True)
    if "fairness_policy" in kw:
        kw["fairness_policy"] = tuple(kw["fairness_policy"])
    kw["order_key_bits"] = tuple(int(b) for b in kw["order_key_bits"])
    return DeviceRound(**kw)
