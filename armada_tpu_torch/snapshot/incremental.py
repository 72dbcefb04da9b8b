"""Incremental round state: O(delta) warm scheduling cycles at 1M-job scale.

The port's copy of armada_tpu/snapshot/incremental.py, numpy only.

The reference scheduler never rebuilds its world per cycle — it delta-syncs
the jobdb from Postgres by serial and keeps the nodedb resident
(internal/scheduler/scheduler.go:441, scheduling_algo.go:411). A cold
round instead has `build_round_snapshot` + `prep_device_round` re-derive
every per-job array from 1M Python objects each cycle.

`IncrementalRound` closes that gap. It performs ONE full build (delegating
to `build_round_snapshot`, the correctness anchor), adopts the columnar
arrays with capacity headroom, and then applies per-cycle deltas — submits,
leases (bind), preemption returns (unbind), terminal removals — as O(delta)
Python plus O(J) vectorized numpy. Derived structures that are cheap to
recompute exactly (the within-queue order permutation, the gang table) are
rebuilt vectorized per snapshot; expensive O(J)-Python derivations (quantity
encoding, bitset interning, scheduling-key groups, pc resolution, device
scaling, demand accounting) are maintained incrementally and handed to
`prep_device_round` via `PrepCache`.

Rows are tombstoned on removal (inert exactly like the solve's padding
rows: queue=-1, zero resources) and recycled by later submits, so the job
axis only grows to the high-water mark of concurrent jobs — which also
keeps the padded round's shapes, and so a device-resident copy of it
(snapshot/residency.py), stable across cycles. Live job rows are never
renumbered, and `_gen` counts the deltas: residency keys on both.

Structural changes the columnar state cannot absorb raise
`SnapshotRebuildRequired`; callers rebuild from their object model (the
jobdb) exactly as on the cold path:

- node set / node labels / taints changed (vocabularies are node-derived),
- a submit references a label (key, value) that exists on nodes but was
  never interned (selector or gang-uniformity vocabulary miss),
- a submit names an unknown queue,
- market unbind of a job whose queued-phase bid was never captured.
"""

from __future__ import annotations

import numpy as np

from ..core.config import SchedulingConfig
from ..core.types import JobSpec, NodeSpec, QueueSpec, RunningJob
from ..solver.kernel_prep import (
    PrepCache,
    compute_key_groups,
    compute_queue_device_accounting,
    prep_device_round,
)
from .round import (
    NO_GANG,
    NO_NODE,
    NON_PREEMPTIBLE_RUNNING_PRICE,
    RoundSnapshot,
    build_round_snapshot,
)


class SnapshotRebuildRequired(RuntimeError):
    """The delta needs structure the incremental state cannot extend;
    rebuild via a fresh IncrementalRound from current inputs."""


def _cap_for(n: int, floor: int = 1024) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _grown(arr: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full((cap, *arr.shape[1:]), fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _widened(arr: np.ndarray, min_width: int) -> np.ndarray:
    """Ensure a '<U' column can hold strings of min_width chars."""
    if arr.dtype.itemsize // 4 >= min_width:
        return arr
    return arr.astype(f"<U{min_width + 8}")


class IncrementalRound:
    """Columnar scheduling-round state with O(delta) cycle updates.

    Usage per cycle::

        inc.set_round_params(global_rate_tokens=..., ...)
        inc.add_jobs(new_submits)
        inc.bind([(job_id, node_id, prio, leased_ts), ...])   # last round's leases
        inc.remove_jobs(finished_ids)
        dev = inc.device_round()          # PrepCache-accelerated prep
        snap = inc.snapshot()             # same object the service reports from
    """

    def __init__(
        self,
        config: SchedulingConfig,
        pool: str,
        nodes: list[NodeSpec],
        queues: list[QueueSpec],
        running: list[RunningJob],
        queued: list[JobSpec],
        *,
        excluded_nodes: dict | None = None,
        cordoned_queues: set | None = None,
        short_job_penalty: dict | None = None,
        global_rate_tokens: float | None = None,
        queue_rate_tokens: dict | None = None,
    ):
        snap = build_round_snapshot(
            config,
            pool,
            nodes,
            queues,
            running,
            queued,
            excluded_nodes=excluded_nodes,
            cordoned_queues=cordoned_queues,
            short_job_penalty=short_job_penalty,
            global_rate_tokens=global_rate_tokens,
            queue_rate_tokens=queue_rate_tokens,
        )
        self.config = config
        self.factory = snap.factory
        self.pool = pool
        self._static = snap  # node axes, vocabularies, away tables, totals
        self._market = bool(config.market_driven)
        self._nodes = [n for n in nodes if n.pool == pool]
        self._node_index = {n.id: i for i, n in enumerate(self._nodes)}
        self._queue_index = {q: i for i, q in enumerate(snap.queue_names)}
        self._prio_levels = snap.priorities  # int32[P], ascending
        self._pc_names = snap.pc_names
        self._pc_index = {n: i for i, n in enumerate(self._pc_names)}
        self._pc_priority_table = np.asarray(
            [config.priority_classes[n].priority for n in self._pc_names],
            dtype=np.int32,
        )
        self._pc_preempt_table = np.asarray(
            [config.priority_classes[n].preemptible for n in self._pc_names],
            dtype=bool,
        )
        self._default_pc = config.default_priority_class
        self._floating = snap.floating_mask

        # Vocabulary-miss detection sets: every (key, value) present on a
        # node, for keys NOT already interned. A selector/uniformity
        # reference that would have interned differently forces a rebuild.
        self._vocab_keys = snap.label_vocab.keys
        self._node_pairs = set()
        for n in self._nodes:
            for k, v in n.labels.items():
                self._node_pairs.add((k, str(v)))

        jobs = [r.job for r in running] + list(queued)
        J = len(jobs)
        cap = _cap_for(J + max(1024, J // 8))
        self._size = J
        self._cap = cap
        self._free: list[int] = []
        self._gen = 0
        self._snap_cache: tuple[int, RoundSnapshot] | None = None

        # ---- adopt per-job columns with capacity headroom ----
        ids_arr = np.asarray(snap.job_ids) if J else np.zeros(0, dtype="<U16")
        self._ids = _grown(ids_arr, cap, "")
        self._req = _grown(snap.job_req, cap, 0)
        self._req_fit = _grown(snap.job_req_fit(), cap, 0)
        self._req_dev = _grown(
            self.factory.to_device(snap.job_req, ceil=True), cap, 0
        )
        self._req_fit_dev = _grown(
            self.factory.to_device(snap.job_req_fit(), ceil=True), cap, 0
        )
        self._tolerated = _grown(snap.job_tolerated, cap, 0)
        self._selector = _grown(snap.job_selector, cap, 0)
        self._possible = _grown(snap.job_possible, cap, False)
        self._queue = _grown(snap.job_queue, cap, -1)
        self._priority = _grown(snap.job_priority.astype(np.int32), cap, 0)
        self._preemptible = _grown(snap.job_preemptible, cap, False)
        self._is_running = _grown(snap.job_is_running, cap, False)
        self._away = _grown(snap.job_away, cap, False)
        self._node = _grown(snap.job_node.astype(np.int32), cap, NO_NODE)
        self._excluded = _grown(snap.job_excluded_nodes, cap, -1)
        self._affinity_group = _grown(snap.job_affinity_group, cap, -1)
        self._pc_idx = _grown(
            np.asarray(
                [self._pc_index[n] for n in snap.job_pc_name], dtype=np.int32
            ),
            cap,
            0,
        )
        self._bid = _grown(snap.job_bid, cap, 0.0)
        self._bid_running = _grown(np.asarray(snap.job_bid_running), cap, 0.0)
        # Queued-phase bid, for market unbind. Unknown (nan) for jobs that
        # entered as running — unbinding those forces a rebuild.
        bid_queued = np.where(snap.job_is_running, np.nan, snap.job_bid)
        self._bid_queued = _grown(
            bid_queued if self._market else np.zeros(J), cap, 0.0
        )
        gang_ids = np.asarray(snap.job_gang_id) if J else np.zeros(0, "<U1")
        self._gang_ids = _grown(_widened(gang_ids, 1), cap, "")
        self._gang_card = _grown(
            np.asarray(
                [j.gang.cardinality if j.gang is not None else 1 for j in jobs],
                dtype=np.int32,
            ),
            cap,
            1,
        )
        uni_arr = np.asarray(
            [
                j.gang.node_uniformity_label if j.gang is not None else ""
                for j in jobs
            ]
        ) if J else np.zeros(0, "<U1")
        self._gang_uni = _grown(_widened(uni_arr, 1), cap, "")
        self._submit_prio = _grown(
            np.asarray([j.priority for j in jobs], dtype=np.int64), cap, 0
        )
        self._ts = _grown(
            np.asarray([j.submitted_ts for j in jobs], dtype=np.float64), cap, 0.0
        )
        leased = np.zeros(J, dtype=np.float64)
        for i, r in enumerate(running):
            leased[i] = r.leased_ts
        self._leased = _grown(leased, cap, 0.0)
        self._alive = _grown(np.ones(J, dtype=bool), cap, False)

        self._id_to_row = {snap.job_ids[j]: j for j in range(J)}

        # ---- scheduling-key interning (incremental continuation of the
        # full build's lexsort grouping): one representative per group ----
        self._key_group = _grown(np.zeros(J, dtype=np.int32), cap, -1)
        groups, num = compute_key_groups(
            self._queue[:J],
            self._priority[:J],
            self._pc_idx[:J],
            self._req[:J],
            self._tolerated[:J],
            self._selector[:J],
            np.flatnonzero(~snap.job_is_running),
        )
        self._key_group[:J] = groups
        self._num_key_groups = num
        self._key_intern: dict = {}
        qm = np.flatnonzero(~snap.job_is_running)
        if len(qm):
            gids, first = np.unique(self._key_group[qm], return_index=True)
            for g, f in zip(gids.tolist(), first.tolist()):
                if g >= 0:
                    self._key_intern[self._key_bytes(int(qm[f]))] = g
        self._key_compact_floor = max(self._num_key_groups, 512)

        # ---- gangs (true multi-member, queued): identity -> members ----
        self._gangs: dict = {}
        for j in range(J):
            if (
                self._gang_card[j] > 1
                and not self._is_running[j]
                and self._gang_ids[j]
            ):
                self._gang_add(j)

        # ---- affinity expressions -> group rows ----
        self._affinity_map: dict = {}
        self._affinity_rows: list[np.ndarray] = list(snap.affinity_allowed)
        for j, job in enumerate(jobs):
            if job.affinity is not None and job.affinity.terms:
                self._affinity_map.setdefault(
                    job.affinity, int(self._affinity_group[j])
                )

        # ---- node-axis state (allocatable is the one mutable node tensor) --
        self.allocatable = snap.allocatable  # int64[P, N, R], adopted

        # ---- queue accounting, host int64 + device units ----
        self.queue_allocated = snap.queue_allocated
        self.queue_demand = snap.queue_demand
        Q, R = snap.queue_allocated.shape
        C = len(self._pc_names)
        self._queue_alloc0_dev, self._queue_demand_pc_dev = (
            compute_queue_device_accounting(
                self._queue[:J],
                self._pc_idx[:J],
                self._is_running[:J],
                self._req_dev[:J],
                Q,
                C,
            )
        )

        # ---- per-round parameters ----
        self._cordoned = set(cordoned_queues or set())
        self._short_penalty = dict(short_job_penalty or {})
        self._global_tokens = global_rate_tokens
        self._queue_tokens = queue_rate_tokens
        self._excluded_map = dict(excluded_nodes or {})
        self._excluded_rows: set[int] = {
            self._id_to_row[i] for i in self._excluded_map if i in self._id_to_row
        }

    # ------------------------------------------------------------------
    # delta operations
    # ------------------------------------------------------------------

    def _touch(self):
        self._gen += 1
        self._snap_cache = None

    def _key_bytes(self, row: int) -> tuple:
        return (
            int(self._queue[row]),
            int(self._priority[row]),
            int(self._pc_idx[row]),
            self._req[row].tobytes(),
            self._tolerated[row].tobytes(),
            self._selector[row].tobytes(),
        )

    def _intern_key(self, row: int) -> int:
        key = self._key_bytes(row)
        g = self._key_intern.get(key)
        if g is None:
            g = self._num_key_groups
            self._key_intern[key] = g
            self._num_key_groups += 1
        return g

    def _maybe_compact_key_groups(self):
        """Group ids grow monotonically (removals leave holes); the kernel
        sizes its unfeasible-key table (and the padded round's group axis)
        by num_key_groups, so unbounded historical diversity would inflate
        every solve. When the count doubles past the last compaction
        point, re-derive dense groups over the LIVE queued rows — the same
        lexsort the cold path uses — and rebuild the intern dict."""
        if self._num_key_groups < max(1024, 2 * self._key_compact_floor):
            return
        J = self._size
        qm = np.flatnonzero(
            self._alive[:J] & ~self._is_running[:J] & (self._queue[:J] >= 0)
        )
        groups, num = compute_key_groups(
            self._queue[:J],
            self._priority[:J],
            self._pc_idx[:J],
            self._req[:J],
            self._tolerated[:J],
            self._selector[:J],
            qm,
        )
        self._key_group[:J] = groups
        self._num_key_groups = num
        self._key_intern = {}
        if len(qm):
            gids, first = np.unique(groups[qm], return_index=True)
            for g, f in zip(gids.tolist(), first.tolist()):
                if g >= 0:
                    self._key_intern[self._key_bytes(int(qm[f]))] = g
        self._key_compact_floor = max(self._num_key_groups, 512)

    def _alloc_rows(self, n: int) -> np.ndarray:
        rows = []
        while self._free and len(rows) < n:
            rows.append(self._free.pop())
        fresh = n - len(rows)
        if fresh:
            if self._size + fresh > self._cap:
                self._grow(self._size + fresh)
            rows.extend(range(self._size, self._size + fresh))
            self._size += fresh
        return np.asarray(rows, dtype=np.int64)

    def _grow(self, need: int):
        cap = _cap_for(need)
        for name, fill in (
            ("_ids", ""),
            ("_req", 0),
            ("_req_fit", 0),
            ("_req_dev", 0),
            ("_req_fit_dev", 0),
            ("_tolerated", 0),
            ("_selector", 0),
            ("_possible", False),
            ("_queue", -1),
            ("_priority", 0),
            ("_preemptible", False),
            ("_is_running", False),
            ("_away", False),
            ("_node", NO_NODE),
            ("_excluded", -1),
            ("_affinity_group", -1),
            ("_pc_idx", 0),
            ("_bid", 0.0),
            ("_bid_running", 0.0),
            ("_bid_queued", 0.0),
            ("_gang_ids", ""),
            ("_gang_card", 1),
            ("_gang_uni", ""),
            ("_submit_prio", 0),
            ("_ts", 0.0),
            ("_leased", 0.0),
            ("_alive", False),
            ("_key_group", -1),
        ):
            setattr(self, name, _grown(getattr(self, name), cap, fill))
        self._cap = cap

    def add_jobs(self, jobs: list[JobSpec]):
        """New submissions (queued). Raises SnapshotRebuildRequired (or a
        quantity-parse error) BEFORE any state mutation — a failed batch
        leaves the state untouched and retryable."""
        if not jobs:
            return
        vocab = self._static.label_vocab
        batch_ids: set = set()
        for job in jobs:
            if job.queue not in self._queue_index:
                raise SnapshotRebuildRequired(f"unknown queue {job.queue!r}")
            for k, v in (job.node_selector or {}).items():
                if (k, str(v)) not in vocab._pair_index and (
                    (k, str(v)) in self._node_pairs
                ):
                    raise SnapshotRebuildRequired(
                        f"label pair ({k!r}, {v!r}) on nodes but not interned"
                    )
            if job.gang is not None and job.gang.node_uniformity_label:
                if job.gang.node_uniformity_label not in self._vocab_keys:
                    raise SnapshotRebuildRequired(
                        f"uniformity key {job.gang.node_uniformity_label!r} "
                        "not interned"
                    )
            if job.id in self._id_to_row or job.id in batch_ids:
                raise SnapshotRebuildRequired(f"duplicate job id {job.id!r}")
            batch_ids.add(job.id)

        # Fallible per-job derivations (quantity parsing, market bids)
        # complete before the first mutation.
        req = self.factory.encode_requests_batch(
            [j.requests for j in jobs], ceil=True
        )
        bid_pairs = (
            [j.bid_price_pair(self.pool) for j in jobs] if self._market else None
        )

        self._touch()
        n = len(jobs)
        rows = self._alloc_rows(n)

        max_id = max(len(j.id) for j in jobs)
        self._ids = _widened(self._ids, max_id)
        max_gid = max(
            (len(j.gang.id) for j in jobs if j.gang is not None), default=0
        )
        if max_gid:
            self._gang_ids = _widened(self._gang_ids, max_gid)
        max_uni = max(
            (
                len(j.gang.node_uniformity_label)
                for j in jobs
                if j.gang is not None
            ),
            default=0,
        )
        if max_uni:
            self._gang_uni = _widened(self._gang_uni, max_uni)

        req_fit = np.where(self._floating[None, :], 0, req)
        self._req[rows] = req
        self._req_fit[rows] = req_fit
        req_dev = self.factory.to_device(req, ceil=True)
        self._req_dev[rows] = req_dev
        self._req_fit_dev[rows] = self.factory.to_device(req_fit, ceil=True)

        taint_vocab = self._static.taint_vocab
        has_taints = bool(taint_vocab.taints)
        tol_cache: dict = {}
        sel_cache: dict = {}
        C = len(self._pc_names)
        for i, job in enumerate(jobs):
            r = int(rows[i])
            self._ids[r] = job.id
            self._id_to_row[job.id] = r
            self._alive[r] = True
            self._queue[r] = self._queue_index[job.queue]
            pc_name = (
                job.priority_class
                if job.priority_class in self._pc_index
                else self._default_pc
            )
            pc = self._pc_index[pc_name]
            self._pc_idx[r] = pc
            self._priority[r] = self._pc_priority_table[pc]
            self._preemptible[r] = self._pc_preempt_table[pc]
            self._is_running[r] = False
            self._node[r] = NO_NODE
            self._submit_prio[r] = job.priority
            self._ts[r] = job.submitted_ts
            self._leased[r] = 0.0
            self._excluded[r] = -1
            if has_taints and job.tolerations:
                bits = tol_cache.get(job.tolerations)
                if bits is None:
                    bits = taint_vocab.tolerated_bits(job.tolerations)
                    tol_cache[job.tolerations] = bits
                self._tolerated[r] = bits
            else:
                self._tolerated[r] = 0
            if job.node_selector:
                sk = tuple(sorted(job.node_selector.items()))
                cached = sel_cache.get(sk)
                if cached is None:
                    cached = vocab.selector_bits(job.node_selector)
                    sel_cache[sk] = cached
                self._selector[r], self._possible[r] = cached
            else:
                self._selector[r] = 0
                self._possible[r] = True
            if job.affinity is not None and job.affinity.terms:
                a = self._affinity_map.get(job.affinity)
                if a is None:
                    a = len(self._affinity_rows)
                    bits = np.zeros(
                        self._static.affinity_allowed.shape[1], dtype=np.uint32
                    )
                    for ni, node in enumerate(self._nodes):
                        if job.affinity.matches(node.labels):
                            bits[ni // 32] |= np.uint32(1 << (ni % 32))
                    self._affinity_rows.append(bits)
                    self._affinity_map[job.affinity] = a
                self._affinity_group[r] = a
            else:
                self._affinity_group[r] = -1
            if self._market:
                q_bid, r_bid = bid_pairs[i]
                if not self._preemptible[r]:
                    r_bid = NON_PREEMPTIBLE_RUNNING_PRICE
                self._bid[r] = q_bid
                self._bid_queued[r] = q_bid
                self._bid_running[r] = r_bid
            else:
                self._bid[r] = self._bid_queued[r] = self._bid_running[r] = 0.0
            if job.gang is not None:
                self._gang_ids[r] = job.gang.id
                self._gang_card[r] = job.gang.cardinality
                self._gang_uni[r] = job.gang.node_uniformity_label
                if job.gang.cardinality > 1:
                    self._gang_add(r)
            else:
                self._gang_ids[r] = ""
                self._gang_card[r] = 1
                self._gang_uni[r] = ""
            self._key_group[r] = self._intern_key(r)

        # demand accounting
        q_rows = self._queue[rows]
        np.add.at(self.queue_demand, q_rows, req)
        seg_pc = self._pc_idx[rows]
        np.add.at(self._queue_demand_pc_dev, (q_rows, seg_pc), req_dev)
        self._maybe_compact_key_groups()

    @staticmethod
    def _check_unique(ids):
        """Reject duplicate ids within one delta batch BEFORE any mutation:
        np.add.at would double-apply accounting silently otherwise."""
        seen: set = set()
        for i in ids:
            if i in seen:
                raise SnapshotRebuildRequired(f"duplicate id {i!r} in batch")
            seen.add(i)

    def bind(self, leases: list[tuple]):
        """Queued -> running: (job_id, node_id, scheduled_at_priority,
        leased_ts) per lease — the service applies last round's
        JobRunLeased events here."""
        if not leases:
            return
        self._check_unique([jid for jid, *_ in leases])
        self._touch()
        rows = np.asarray(
            [self._id_to_row[jid] for jid, *_ in leases], dtype=np.int64
        )
        nidx = np.asarray(
            [self._node_index[nid] for _, nid, *_ in leases], dtype=np.int64
        )
        prio = np.asarray([p for _, _, p, *_ in leases], dtype=np.int32)
        leased_ts = np.asarray(
            [(rest[0] if rest else 0.0) for _, _, _, *rest in leases],
            dtype=np.float64,
        )
        if self._is_running[rows].any():
            raise SnapshotRebuildRequired("bind of an already-running job")
        self._is_running[rows] = True
        self._node[rows] = nidx.astype(np.int32)
        self._priority[rows] = prio
        self._leased[rows] = leased_ts
        self._key_group[rows] = -1
        if self._market:
            self._bid[rows] = self._bid_running[rows]
        req_fit = self._req_fit[rows]
        pre = self._preemptible[rows]
        for p in range(len(self._prio_levels)):
            m = (~pre) | (prio >= self._prio_levels[p])
            if m.any():
                np.subtract.at(self.allocatable[p], nidx[m], req_fit[m])
        q_rows = self._queue[rows]
        np.add.at(self.queue_allocated, q_rows, self._req[rows])
        np.add.at(self._queue_alloc0_dev, q_rows, self._req_dev[rows])
        for r in rows.tolist():
            if self._gang_card[r] > 1 and self._gang_ids[r]:
                self._gang_discard(r)

    def unbind(self, ids: list[str]):
        """Running -> queued (e.g. preempted and requeued)."""
        if not ids:
            return
        self._check_unique(ids)
        rows = np.asarray([self._id_to_row[i] for i in ids], dtype=np.int64)
        if not self._is_running[rows].all():
            raise SnapshotRebuildRequired("unbind of a non-running job")
        if self._away[rows].any():
            # A requeued cross-pool away job returns to its HOME pool's
            # queue — it cannot become a queued candidate in this (the
            # borrowing) pool's phantom bucket. Rebuild from the jobdb.
            raise SnapshotRebuildRequired("unbind of a cross-pool away job")
        self._touch()
        if self._market and np.isnan(self._bid_queued[rows]).any():
            raise SnapshotRebuildRequired(
                "market unbind of a job whose queued-phase bid is unknown"
            )
        self._release_allocatable(rows)
        q_rows = self._queue[rows]
        np.subtract.at(self.queue_allocated, q_rows, self._req[rows])
        np.subtract.at(self._queue_alloc0_dev, q_rows, self._req_dev[rows])
        self._is_running[rows] = False
        self._node[rows] = NO_NODE
        self._priority[rows] = self._pc_priority_table[self._pc_idx[rows]]
        self._leased[rows] = 0.0
        if self._market:
            self._bid[rows] = self._bid_queued[rows]
        for r in rows.tolist():
            self._key_group[r] = self._intern_key(r)
            if self._gang_card[r] > 1 and self._gang_ids[r]:
                self._gang_add(r)
        self._maybe_compact_key_groups()

    def remove_jobs(self, ids: list[str]):
        """Terminal removals (succeeded / failed / cancelled), queued or
        running."""
        if not ids:
            return
        self._check_unique(ids)
        self._touch()
        rows = np.asarray([self._id_to_row[i] for i in ids], dtype=np.int64)
        running = self._is_running[rows]
        if running.any():
            rr = rows[running]
            self._release_allocatable(rr)
            np.subtract.at(self.queue_allocated, self._queue[rr], self._req[rr])
            np.subtract.at(
                self._queue_alloc0_dev, self._queue[rr], self._req_dev[rr]
            )
        q_rows = self._queue[rows]
        np.subtract.at(self.queue_demand, q_rows, self._req[rows])
        np.subtract.at(
            self._queue_demand_pc_dev,
            (q_rows, self._pc_idx[rows]),
            self._req_dev[rows],
        )
        for r in rows.tolist():
            if self._gang_card[r] > 1 and self._gang_ids[r] and not self._is_running[r]:
                self._gang_discard(r)
            del self._id_to_row[str(self._ids[r])]
            self._excluded_rows.discard(r)
        # Tombstone: inert exactly like kernel padding rows.
        self._alive[rows] = False
        self._queue[rows] = -1
        self._is_running[rows] = False
        self._away[rows] = False
        self._node[rows] = NO_NODE
        self._possible[rows] = False
        self._key_group[rows] = -1
        self._affinity_group[rows] = -1
        self._excluded[rows] = -1
        self._req[rows] = 0
        self._req_fit[rows] = 0
        self._req_dev[rows] = 0
        self._req_fit_dev[rows] = 0
        self._tolerated[rows] = 0
        self._selector[rows] = 0
        self._bid[rows] = self._bid_queued[rows] = self._bid_running[rows] = 0.0
        self._ids[rows] = ""
        self._gang_ids[rows] = ""
        self._gang_card[rows] = 1
        self._gang_uni[rows] = ""
        self._free.extend(int(r) for r in rows)

    def set_priority(self, job_id: str, priority: int):
        """Reprioritize: changes within-queue ordering only."""
        row = self._id_to_row[job_id]
        self._touch()
        self._submit_prio[row] = priority

    def set_round_params(
        self,
        *,
        excluded_nodes: dict | None = None,
        cordoned_queues: set | None = None,
        short_job_penalty: dict | None = None,
        global_rate_tokens: float | None = None,
        queue_rate_tokens: dict | None = None,
    ):
        """Per-cycle parameters (cheap, Q- or delta-sized)."""
        self._touch()
        self._cordoned = set(cordoned_queues or set())
        self._short_penalty = dict(short_job_penalty or {})
        self._global_tokens = global_rate_tokens
        self._queue_tokens = queue_rate_tokens
        # Reset previous retry anti-affinity rows, apply the new map.
        for r in self._excluded_rows:
            self._excluded[r] = -1
        self._excluded_rows = set()
        self._excluded_map = dict(excluded_nodes or {})
        K = self._excluded.shape[1]
        for jid, bad in self._excluded_map.items():
            r = self._id_to_row.get(jid)
            if r is None:
                continue
            idxs = [self._node_index[n] for n in bad if n in self._node_index][:K]
            self._excluded[r, : len(idxs)] = idxs
            self._excluded_rows.add(r)

    # ------------------------------------------------------------------
    # snapshot / device-round assembly
    # ------------------------------------------------------------------

    def _release_allocatable(self, rows: np.ndarray):
        """Add running rows' requests back to the allocatable tensor."""
        nidx = self._node[rows].astype(np.int64)
        prio = self._priority[rows]
        pre = self._preemptible[rows]
        req_fit = self._req_fit[rows]
        on_node = nidx >= 0
        for p in range(len(self._prio_levels)):
            m = on_node & ((~pre) | (prio >= self._prio_levels[p]))
            if m.any():
                np.add.at(self.allocatable[p], nidx[m], req_fit[m])

    def _gang_discard(self, r: int):
        key = (int(self._queue[r]), str(self._gang_ids[r]))
        ent = self._gangs.get(key)
        if ent is not None:
            ent["members"].discard(r)
            if not ent["members"]:
                del self._gangs[key]

    def _gang_add(self, r: int):
        """Register row r (a queued true-gang member) in the gang dict."""
        key = (int(self._queue[r]), str(self._gang_ids[r]))
        ent = self._gangs.get(key)
        if ent is None:
            ent = {
                "card": int(self._gang_card[r]),
                "uniformity": str(self._gang_uni[r]),
                "members": set(),
            }
            self._gangs[key] = ent
        ent["members"].add(r)

    def _job_order(self, J: int) -> np.ndarray:
        if self._market:
            pcp = self._pc_priority_table[self._pc_idx[:J]].astype(np.int64)
            running_rank = np.where(self._is_running[:J], 0, 1)
            ts_key = np.where(self._is_running[:J], self._leased[:J], self._ts[:J])
            perm = np.lexsort(
                (self._ids[:J], ts_key, running_rank, -self._bid[:J], -pcp)
            )
        else:
            perm = np.lexsort((self._ids[:J], self._ts[:J], self._submit_prio[:J]))
        order = np.empty(J, dtype=np.int64)
        order[perm] = np.arange(J)
        return order

    def snapshot(self) -> RoundSnapshot:
        """Assemble a RoundSnapshot over the current state. Cached per
        generation — repeated calls between deltas are free.

        LIFETIME CONTRACT: the returned snapshot shares (views of) the
        live columnar arrays — that zero-copy sharing is the point of the
        incremental design. It is valid until the next delta method call;
        applying a delta mutates the shared arrays in place, so a consumer
        that must outlive the cycle (e.g. an async reporter) must copy the
        fields it keeps. `build_round_snapshot` semantics (fresh arrays
        every call) do NOT hold here."""
        if self._snap_cache is not None and self._snap_cache[0] == self._gen:
            return self._snap_cache[1]
        import dataclasses

        J = self._size
        st = self._static
        R = self.factory.num_resources
        job_order = self._job_order(J)

        # ---- gang table: bulk singletons + the small true-gang dict ----
        is_multi = np.zeros(J, dtype=bool)
        entries = list(self._gangs.values())
        for ent in entries:
            is_multi[list(ent["members"])] = True
        singles = np.flatnonzero(~is_multi).astype(np.int32)
        n_single = len(singles)
        G = n_single + len(entries)
        job_gang = np.full(J, NO_GANG, dtype=np.int32)
        job_gang[singles] = np.arange(n_single, dtype=np.int32)
        gang_queue = np.zeros(G, dtype=np.int32)
        gang_card = np.ones(G, dtype=np.int32)
        gang_uniformity_key = [""] * n_single
        gang_member_offsets = np.zeros(G + 1, dtype=np.int32)
        gang_total_req = np.zeros((G, R), dtype=np.int64)
        gang_order = np.zeros(G, dtype=np.int64)
        gang_complete = np.zeros(G, dtype=bool)
        gang_queue[:n_single] = self._queue[singles]
        gang_member_offsets[1 : n_single + 1] = np.arange(1, n_single + 1)
        gang_total_req[:n_single] = self._req[singles]
        gang_order[:n_single] = job_order[singles]
        gang_complete[:n_single] = True
        members_flat: list = [singles]
        for gi, ent in enumerate(entries):
            g = n_single + gi
            members = sorted(ent["members"], key=lambda r: job_order[r])
            for m in members:
                job_gang[m] = g
            members_flat.append(np.asarray(members, dtype=np.int32))
            gang_member_offsets[g + 1] = gang_member_offsets[g] + len(members)
            gang_queue[g] = self._queue[members[0]]
            gang_card[g] = ent["card"]
            gang_total_req[g] = self._req[members].sum(axis=0)
            gang_order[g] = max(job_order[m] for m in members)
            gang_complete[g] = len(members) == ent["card"]
            gang_uniformity_key.append(ent["uniformity"])
        gang_members = np.concatenate(members_flat) if G else np.zeros(0, np.int32)

        snap = dataclasses.replace(
            st,
            allocatable=self.allocatable,
            queue_cordoned=np.asarray(
                [q in self._cordoned for q in st.queue_names], dtype=bool
            ),
            queue_short_penalty=self.factory.encode_requests_batch(
                [self._short_penalty.get(q, {}) for q in st.queue_names],
                ceil=True,
            ),
            queue_allocated=self.queue_allocated,
            queue_demand=self.queue_demand,
            job_ids=self._ids[:J],
            job_req=self._req[:J],
            job_tolerated=self._tolerated[:J],
            job_selector=self._selector[:J],
            job_possible=self._possible[:J],
            job_queue=self._queue[:J],
            job_priority=self._priority[:J],
            job_preemptible=self._preemptible[:J],
            job_is_running=self._is_running[:J],
            job_away=self._away[:J],
            job_node=self._node[:J],
            job_order=job_order,
            job_excluded_nodes=self._excluded[:J],
            job_affinity_group=self._affinity_group[:J],
            affinity_allowed=(
                np.stack(self._affinity_rows)
                if self._affinity_rows
                else st.affinity_allowed
            ),
            job_gang=job_gang,
            job_gang_id=self._gang_ids[:J],
            job_pc_name=np.asarray(self._pc_names)[self._pc_idx[:J]],
            job_bid=self._bid[:J],
            job_bid_running=self._bid_running[:J],
            gang_queue=gang_queue,
            gang_card=gang_card,
            gang_member_offsets=gang_member_offsets,
            gang_members=gang_members,
            gang_total_req=gang_total_req,
            gang_order=gang_order,
            gang_complete=gang_complete,
            gang_uniformity_key=gang_uniformity_key,
            global_rate_tokens=self._global_tokens,
            queue_rate_tokens=self._queue_tokens,
        )
        self._snap_cache = (self._gen, snap)
        return snap

    def prep_cache(self) -> PrepCache:
        J = self._size
        return PrepCache(
            req_dev=self._req_dev[:J],
            req_fit_dev=self._req_fit_dev[:J],
            job_pc=self._pc_idx[:J],
            job_key_group=self._key_group[:J],
            num_key_groups=self._num_key_groups,
            queue_alloc0=self._queue_alloc0_dev,
            queue_demand_pc=self._queue_demand_pc_dev,
        )

    def device_round(self):
        """prep_device_round with the maintained PrepCache — the warm-cycle
        device input in one call."""
        return prep_device_round(self.snapshot(), cache=self.prep_cache())


