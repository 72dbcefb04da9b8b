"""Python oracle for the scheduling round.

A readable, sequential implementation of the full preempt-and-schedule round,
mirroring the reference's PreemptingQueueScheduler semantics
(internal/scheduler/scheduling/preempting_queue_scheduler.go:84):

  1. evict all preemptible jobs of queues above their protected fair share
     (NodeEvictor + gang-completion eviction),
  2. assign fair-preemption order indices to evicted jobs
     (addEvictedJobsToNodeDb, :584),
  3. re-schedule evicted + newly queued jobs in fair-share order
     (QueueScheduler/GangScheduler/NodeDb select chain),
  4. evict preemptible jobs on oversubscribed nodes (OversubscribedEvictor),
  5. re-schedule those evicted jobs only,
  6. evicted-but-not-rescheduled jobs are preempted.

This is the parity target for the vectorized JAX kernel: same snapshot in,
identical placements out. It is deliberately written for auditability, not
speed.

Known deliberate deviations from the Go reference (documented, small):
  - Candidate-node order uses resolution-rounded allocatable for the merge
    (the reference rounds within a node type but merges types on raw values,
    nodeiteration.go:170-185); ties differ only between near-identical nodes.
  - Away scheduling covers within-pool away node types (well-known taint
    sets at reduced priority) AND cross-pool away nodes (round 5): borrowed
    jobs arrive as snapshot rows under phantom "<queue>-away" fairness
    buckets built by build_round_snapshot, so this solver handles them
    generically; away gangs skip floating-resource caps
    (context/scheduling.go:546-557). The optimiser pass runs as a host-side
    post-pass (solver/optimiser.py), not inside this solver.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

import numpy as np

from ..core.priorities import EVICTED_PRIORITY, MIN_PRIORITY
from ..snapshot.round import NO_NODE, RoundSnapshot
from . import drf, policy
from .result import RoundResult

# Unschedulable reasons (constraints/constraints.go:26-57).
R_MAX_ROUND_RESOURCES = "maximum resources scheduled"
R_GLOBAL_RATE_LIMIT = "global scheduling rate limit exceeded"
R_QUEUE_RATE_LIMIT = "queue scheduling rate limit exceeded"
R_GANG_GLOBAL_BURST = "gang cardinality too large: exceeds global max burst size"
R_GANG_QUEUE_BURST = "gang cardinality too large: exceeds queue max burst size"
R_GLOBAL_RATE_LIMIT_GANG = "gang would exceed global scheduling rate limit"
R_QUEUE_RATE_LIMIT_GANG = "gang would exceed queue scheduling rate limit"
R_GANG_NO_FIT = "unable to schedule gang since minimum cardinality not met"
R_JOB_NO_FIT = "job does not fit on any node"
R_QUEUE_LIMIT = "resource limit exceeded"
R_FLOATING = "not enough floating resources available"
R_QUEUE_CORDONED = "queue cordoned"


def is_terminal(reason: str) -> bool:
    return reason in (R_MAX_ROUND_RESOURCES, R_GLOBAL_RATE_LIMIT)


def is_queue_terminal(reason: str) -> bool:
    return reason in (R_QUEUE_RATE_LIMIT, R_QUEUE_CORDONED)


def reason_is_property_of_gang(reason: str) -> bool:
    return reason in (R_GANG_GLOBAL_BURST, R_JOB_NO_FIT, R_GANG_NO_FIT)


@dataclass
class _QueueStream:
    """Per-queue candidate stream: a QueuedGangIterator over evicted jobs
    followed by queued jobs (MultiJobsIterator ordering,
    preempting_queue_scheduler.go:719-726)."""

    jobs: list  # job indices in yield order
    is_evicted: list  # parallel bools
    pos: int = 0
    jobs_seen: int = 0
    only_evicted: bool = False
    gang_accum: dict = field(default_factory=dict)
    head: tuple | None = None  # (members, all_evicted) or None


class ReferenceSolver:
    """Sequential oracle over one RoundSnapshot."""

    def __init__(
        self,
        snap: RoundSnapshot,
        *,
        global_tokens: float | None = None,
        queue_tokens: np.ndarray | None = None,
    ):
        self.snap = snap
        # Floating columns zeroed for all node-fit / node-accounting math.
        self.req_fit = snap.job_req_fit()
        cfg = snap.config
        self.protected_fraction = cfg.protected_fraction_of_fair_share
        self.max_lookback = cfg.max_queue_lookback
        self.consider_priority = cfg.consider_priority_class_priority
        self.prefer_large = cfg.enable_prefer_large_job_ordering
        self.market_driven = cfg.market_driven
        self.spot_price_cutoff = cfg.spot_price_cutoff
        limits = cfg.rate_limits
        self.global_burst = limits.maximum_scheduling_burst
        self.queue_burst = limits.maximum_per_queue_scheduling_burst
        # Token state carried across cycles by the service (the reference's
        # rate limiter persists between rounds, scheduler.go); snapshot
        # overrides feed it in, capped at the burst.
        if global_tokens is None:
            global_tokens = snap.global_rate_tokens
        self.global_tokens = min(
            float(global_tokens) if global_tokens is not None else float(self.global_burst),
            float(self.global_burst),
        )
        if queue_tokens is None and snap.queue_rate_tokens is not None:
            queue_tokens = [
                (snap.queue_rate_tokens or {}).get(name, self.queue_burst)
                for name in snap.queue_names
            ]
        self.queue_tokens = np.minimum(
            np.asarray(queue_tokens, dtype=np.float64)
            if queue_tokens is not None
            else np.full(snap.num_queues, float(self.queue_burst)),
            float(self.queue_burst),
        )
        self.mult = snap.drf_multipliers()
        self.total = snap.total_resources.astype(np.float64)
        self.total_is_zero = bool((snap.total_resources == 0).all())
        # Pluggable fairness (solver/policy.py): the oracle mirrors the
        # kernel's policy-specialized cost, entitlement and rank hooks.
        self.policy_spec = policy.spec_from_config(cfg, snap.pool)
        self.queue_deadline = (
            np.asarray(snap.queue_deadline, dtype=np.float64)
            if snap.queue_deadline is not None
            else np.full(snap.num_queues, np.inf)
        )
        self.policy_rank = policy.policy_rank(
            self.policy_spec, snap.queue_weight, self.queue_deadline
        )

        # Per-round resource cap (calculatePerRoundLimits, constraints.go:200)
        self.max_round_resources = np.full(
            snap.factory.num_resources, np.iinfo(np.int64).max, dtype=np.float64
        )
        for name, frac in cfg.maximum_resource_fraction_to_schedule.items():
            i = snap.factory.name_to_index.get(name)
            if i is not None:
                self.max_round_resources[i] = frac * snap.total_resources[i]

        # Per-queue per-priority-class caps (calculatePerQueueLimits).
        # {(queue_idx, pc_name): float64[R] limit}; absent = unlimited.
        self.queue_pc_limits: dict = {}
        for pc_name, pc in cfg.priority_classes.items():
            fractions = dict(pc.maximum_resource_fraction_per_queue)
            fractions.update(
                pc.maximum_resource_fraction_per_queue_by_pool.get(snap.pool, {})
            )
            if not fractions:
                continue
            limit = np.full(snap.factory.num_resources, np.inf)
            for name, frac in fractions.items():
                i = snap.factory.name_to_index.get(name)
                if i is not None:
                    limit[i] = frac * snap.total_resources[i]
            for q in range(snap.num_queues):
                self.queue_pc_limits[(q, pc_name)] = limit

        self.job_pc_name = snap.job_pc_name
        self._row_of = {int(p): i for i, p in enumerate(snap.priorities)}

    # ------------------------------------------------------------------ state

    def _init_state(self):
        snap = self.snap
        self.alloc = snap.allocatable.copy()
        self.queue_alloc = snap.queue_allocated.astype(np.float64).copy()
        self.queue_pc_alloc: dict = {}
        for j in range(snap.num_jobs):
            if snap.job_is_running[j] and snap.job_queue[j] >= 0:
                key = (int(snap.job_queue[j]), self.job_pc_name[j])
                self.queue_pc_alloc[key] = self.queue_pc_alloc.get(key, 0) + snap.job_req[
                    j
                ].astype(np.float64)
        self.assigned_node = snap.job_node.copy()
        self.sched_prio = snap.job_priority.copy()
        self.evicted: set[int] = set()
        self.evict_index: dict[int, int] = {}  # job -> fair-preemption order
        self.extra_tolerated = np.zeros_like(snap.job_tolerated)
        self.scheduled: set[int] = set()  # newly scheduled queued jobs
        self.rescheduled: set[int] = set()  # evicted-this-round, returned
        self.scheduled_new = np.zeros(snap.factory.num_resources, dtype=np.int64)
        # Pool-level floating-resource allocation (bound jobs only).
        self.pool_floating = np.zeros(snap.factory.num_resources, dtype=np.int64)
        for j in range(snap.num_jobs):
            if snap.job_is_running[j] and snap.job_node[j] >= 0:
                self.pool_floating += np.where(
                    snap.floating_mask, snap.job_req[j], 0
                )
        self.unfeasible_keys: dict = {}
        self.job_reason = [""] * snap.num_jobs
        self.termination_reason = ""
        self.num_loops = 0
        self.spot_price: float | None = None
        # Round-deadline guardrail (maxSchedulingDuration): set by solve()
        # when a budget is passed; checked between candidate-loop
        # iterations of the queued pass.
        self._deadline: float | None = None
        self.truncated = False
        self.sched_cost_accum = np.zeros(snap.factory.num_resources, dtype=np.int64)

    def _checkpoint(self):
        return (
            self.alloc.copy(),
            self.queue_alloc.copy(),
            {k: np.copy(v) for k, v in self.queue_pc_alloc.items()},
            self.assigned_node.copy(),
            self.sched_prio.copy(),
            set(self.evicted),
            dict(self.evict_index),
            self.extra_tolerated.copy(),
            set(self.scheduled),
            set(self.rescheduled),
            self.scheduled_new.copy(),
            self.pool_floating.copy(),
            self.global_tokens,
            self.queue_tokens.copy(),
        )

    def _restore(self, cp):
        (
            self.alloc,
            self.queue_alloc,
            self.queue_pc_alloc,
            self.assigned_node,
            self.sched_prio,
            self.evicted,
            self.evict_index,
            self.extra_tolerated,
            self.scheduled,
            self.rescheduled,
            self.scheduled_new,
            self.pool_floating,
            self.global_tokens,
            self.queue_tokens,
        ) = cp

    # ------------------------------------------------------- fitting helpers

    def _static_fit(self, j: int, n: int, extra_sel, extra_tol=None) -> bool:
        """Taints, selector, total resources (StaticJobRequirementsMet,
        nodematching.go:161-190)."""
        snap = self.snap
        if not snap.job_possible[j]:
            return False
        if snap.node_unschedulable[n]:
            return False
        if n in snap.job_excluded_nodes[j]:
            return False  # retry anti-affinity (scheduler.go:589-636)
        a = snap.job_affinity_group[j]
        if a >= 0 and not (
            snap.affinity_allowed[a, n // 32] >> np.uint32(n % 32)
        ) & np.uint32(1):
            return False  # node affinity (nodematching.go:242-255)
        tolerated = snap.job_tolerated[j] | self.extra_tolerated[j]
        if extra_tol is not None:
            tolerated = tolerated | extra_tol
        if (snap.node_taint_bits[n] & ~tolerated).any():
            return False
        required = snap.job_selector[j]
        if extra_sel is not None:
            required = required | extra_sel
        if (required & ~snap.node_label_bits[n]).any():
            return False
        return bool((self.req_fit[j] <= snap.node_total[n]).all())

    def _dynamic_fit(self, j: int, n: int, row: int) -> bool:
        return bool((self.req_fit[j] <= self.alloc[row, n]).all())

    def _candidate_order(self, row: int) -> np.ndarray:
        """Best-fit order: ascending rounded allocatable at this priority over
        the indexed resources, tie-break node id (nodeiteration.go:170-185)."""
        snap = self.snap
        keys = [snap.node_id_rank]
        for ri, res in zip(
            snap.order_res_idx[::-1], snap.order_res_resolution[::-1]
        ):
            keys.append(self.alloc[row, :, ri] // res)
        return np.lexsort(keys)

    def _select_at_row(self, j: int, row: int, extra_sel, extra_tol=None) -> int | None:
        for n in self._candidate_order(row):
            n = int(n)
            if self._static_fit(j, n, extra_sel, extra_tol) and self._dynamic_fit(
                j, n, row
            ):
                return n
        return None

    # ---------------------------------------------------------- node select

    def _select_node(self, j: int, extra_sel):
        """SelectNodeForJobWithTxn (nodedb.go:423): returns
        (node, preempted_at_priority) or (None, reason)."""
        snap = self.snap
        priority = int(self.sched_prio[j])

        # Evicted jobs are pinned to their previous node via the node-id
        # selector (eviction.go:236-249; nodedb.go:456-468). Unschedulable
        # over-allocated nodes always take their evicted jobs back
        # (nodedb.go:770-780).
        if j in self.evicted:
            n = int(self.assigned_node[j])
            row = self._row_of[priority]
            over_allocated = bool((self.alloc[:, n] < 0).any())
            if snap.node_unschedulable[n] and over_allocated:
                return n, priority
            if self._dynamic_fit(j, n, row):
                return n, priority
            return None, R_JOB_NO_FIT

        # Home scheduling at the job's own priority.
        result = self._select_home_chain(j, priority, extra_sel, extra_tol=None)
        if result is not None:
            return result

        # Away scheduling (nodedb.go:487-501): each away node type adds
        # tolerations for its well-known taints and retries the whole chain
        # at the away priority. The job is then bound at that priority.
        ci = snap.pc_names.index(self.job_pc_name[j])
        for a in range(int(snap.pc_away_count[ci])):
            away_prio = int(snap.pc_away_prio[ci, a])
            away_tol = snap.pc_away_tol[ci, a]
            result = self._select_home_chain(
                j, away_prio, extra_sel, extra_tol=away_tol
            )
            if result is not None:
                self.sched_prio[j] = away_prio  # ScheduledAtPriority
                return result

        return None, R_JOB_NO_FIT

    def _select_home_chain(self, j, priority, extra_sel, extra_tol):
        """selectNodeForJobWithTxnAtPriority (nodedb.go:597-662): no-preempt
        row, feasibility gate, fair preemption, urgency preemption."""
        snap = self.snap

        # Try at EvictedPriority: fits without preempting anyone. The
        # recorded preempted-at priority is the scan row's priority
        # (nodedb.go:796-799).
        n = self._select_at_row(j, 0, extra_sel, extra_tol)
        if n is not None:
            return n, EVICTED_PRIORITY

        # Check at the target priority; if impossible, give up early.
        row = self._row_of[priority]
        n = self._select_at_row(j, row, extra_sel, extra_tol)
        if n is None:
            return None

        # Fair preemption: prevent re-scheduling of evicted jobs appearing
        # latest in the fairness order (nodedb.go:803-899).
        res = self._fair_preemption(j, extra_sel, extra_tol)
        if res is not None:
            return res

        # Urgency preemption: kick off lower-priority bound jobs
        # (nodedb.go:678-711).
        for r in range(1, snap.num_priorities):
            level = int(snap.priorities[r])
            if level > priority:
                break
            n = self._select_at_row(j, r, extra_sel, extra_tol)
            if n is not None:
                return n, level

        return None

    def _fair_preemption(self, j: int, extra_sel, extra_tol=None):
        snap = self.snap
        avail: dict[int, np.ndarray] = {}
        pending: dict[int, list] = {}
        static_unmet: set[int] = set()
        max_priority = MIN_PRIORITY
        for e in sorted(self.evict_index, key=lambda x: -self.evict_index[x]):
            n = int(self.assigned_node[e])
            if n in static_unmet:
                continue
            if n not in avail:
                avail[n] = self.alloc[0, n].copy()
                pending[n] = []
            avail[n] = avail[n] + self.req_fit[e]
            pending[n].append(e)
            if not (self.req_fit[j] <= avail[n]).all():
                continue
            if not self._static_fit(j, n, extra_sel, extra_tol):
                static_unmet.add(n)
                continue
            # Permanently unbind the consumed evicted jobs: they can no
            # longer be re-scheduled (their home-node capacity is gone).
            for e2 in pending[n]:
                self.alloc[0, n] += self.req_fit[e2]
                del self.evict_index[e2]
                max_priority = max(max_priority, int(self.sched_prio[e2]))
            return n, max_priority
        return None

    def _cutoff_rows(self, j: int, priority: int) -> np.ndarray:
        """Priority rows a bound job deducts from: preemptible jobs deduct at
        rows <= their priority; non-preemptible jobs at every row
        (priorityCutoffFor, nodedb.go:1017-1032)."""
        if self.snap.job_preemptible[j]:
            return self.snap.priorities <= priority
        return np.ones(self.snap.num_priorities, dtype=bool)

    def _bind(self, j: int, n: int, at_priority: int):
        """bindJobToNodeInPlace (nodedb.go:911-945)."""
        snap = self.snap
        was_evicted = j in self.evicted
        rows = self._cutoff_rows(j, at_priority)
        self.alloc[rows, n] -= self.req_fit[j]
        if was_evicted:
            # The evicted job's own usage was still counted at EvictedPriority.
            self.alloc[0, n] += self.req_fit[j]
            self.evicted.discard(j)
            self.evict_index.pop(j, None)
        self.sched_prio[j] = at_priority
        self.assigned_node[j] = n

    def _evict(self, j: int):
        """EvictJobsFromNode + sctx.EvictJob: move the job's usage to the
        evicted row, pin it to its node, tolerate the node's taints, and
        subtract its allocation from the queue (nodedb.go:947+,
        context/queue.go:351-384)."""
        snap = self.snap
        n = int(self.assigned_node[j])
        prio = int(self.sched_prio[j])
        rows = self._cutoff_rows(j, prio) & (snap.priorities > EVICTED_PRIORITY)
        self.alloc[rows, n] += self.req_fit[j]
        self.evicted.add(j)
        self.extra_tolerated[j] = self.extra_tolerated[j] | snap.node_taint_bits[n]
        self.pool_floating -= np.where(snap.floating_mask, snap.job_req[j], 0)
        q = int(snap.job_queue[j])
        if q >= 0:
            self.queue_alloc[q] -= snap.job_req[j]
            key = (q, self.job_pc_name[j])
            if key in self.queue_pc_alloc:
                self.queue_pc_alloc[key] = self.queue_pc_alloc[key] - snap.job_req[j]

    # ------------------------------------------------------------- fairness

    def _compute_fair_shares(self):
        """Fair shares from *constrained* demand: per-queue demand capped by
        the per-queue-per-priority-class limits before water-filling
        (CapResources, constraints.go:187; scheduling_algo.go:722)."""
        snap = self.snap
        demand_pc: dict = {}
        for j in range(snap.num_jobs):
            q = int(snap.job_queue[j])
            if q < 0:
                continue
            key = (q, self.job_pc_name[j])
            demand_pc[key] = demand_pc.get(key, 0) + snap.job_req[j].astype(np.float64)
        constrained = np.zeros((snap.num_queues, snap.factory.num_resources))
        for (q, pc_name), demand in demand_pc.items():
            limit = self.queue_pc_limits.get((q, pc_name))
            capped = np.minimum(demand, limit) if limit is not None else demand
            constrained[q] += capped
        demand_costs = policy.policy_cost(
            self.policy_spec, constrained, self.total, self.mult
        )
        return policy.policy_fair_shares(
            self.policy_spec,
            snap.queue_names,
            snap.queue_weight,
            demand_costs,
            self.total_is_zero,
            self.queue_deadline,
        )

    def _queue_cost(self, q: int, extra=None) -> float:
        # Candidate-ordering costs include the short-job penalty
        # (GetAllocationInclShortJobPenalty, queue_scheduler.go:553-554).
        alloc = self.queue_alloc[q] + self.snap.queue_short_penalty[q]
        if extra is not None:
            alloc = alloc + extra
        return float(
            policy.policy_cost(self.policy_spec, alloc, self.total, self.mult)
            / self.snap.queue_weight[q]
        )

    # ------------------------------------------------------------- eviction

    def _node_evictor(self, demand_capped, fair_share, uncapped):
        """NodeEvictor pass (preempting_queue_scheduler.go:95-137 + eviction.go).

        Evicts every preemptible running job whose queue is above its
        protected fair share. Decisions use round-start allocations (the
        context is only updated after the evictor finishes)."""
        snap = self.snap
        actual_cost = policy.policy_cost(
            self.policy_spec, self.queue_alloc, self.total, self.mult
        )
        evict_queue = np.zeros(snap.num_queues, dtype=bool)
        for q in range(snap.num_queues):
            fs = max(demand_capped[q], fair_share[q])
            fraction = actual_cost[q] / fs if fs > 0 else np.inf
            evict_queue[q] = fraction > self.protected_fraction

        to_evict = []
        for j in range(snap.num_jobs):
            if not snap.job_is_running[j] or self.assigned_node[j] < 0:
                continue
            if j in self.evicted:
                continue
            q = int(snap.job_queue[j])
            if q < 0:
                continue
            if self.market_driven:
                # Market mode: every bound job is evictable each round;
                # price order decides who returns
                # (preempting_queue_scheduler.go:117-119).
                to_evict.append(j)
                continue
            if not snap.job_preemptible[j]:
                continue
            if evict_queue[q]:
                to_evict.append(j)
        return to_evict

    def _gang_completion_eviction(self, already: list) -> list:
        """Evict remaining bound members of partially evicted gangs
        (evictGangs/collectIdsForGangEviction,
        preempting_queue_scheduler.go:351-416). Members bound this round
        (scheduled or rescheduled) count as well as running jobs."""
        snap = self.snap
        already_set = set(already)
        evicted_gangs = {
            (int(snap.job_queue[j]), snap.job_gang_id[j])
            for j in already
            if snap.job_gang_id[j]
        }
        extra = []
        for j in range(snap.num_jobs):
            if j in already_set or j in self.evicted:
                continue
            bound = self.assigned_node[j] >= 0 and (
                snap.job_is_running[j] or j in self.scheduled or j in self.rescheduled
            )
            if not bound or not snap.job_gang_id[j]:
                continue
            if (int(snap.job_queue[j]), snap.job_gang_id[j]) in evicted_gangs:
                extra.append(j)
        return extra

    def _oversubscribed_evictor(self) -> list:
        """OversubscribedEvictor (eviction.go:133-180): on each node with a
        negative allocatable at some priority >= 0, evict all preemptible
        jobs scheduled at exactly those priorities."""
        snap = self.snap
        to_evict = []
        for n in range(snap.num_nodes):
            over = {
                int(snap.priorities[r])
                for r in range(1, snap.num_priorities)
                if (self.alloc[r, n] < 0).any()
            }
            if not over:
                continue
            for j in range(snap.num_jobs):
                if self.assigned_node[j] != n or j in self.evicted:
                    continue
                bound = snap.job_is_running[j] or j in self.scheduled or j in self.rescheduled
                if not bound:
                    continue
                if not snap.job_preemptible[j]:
                    continue
                if int(self.sched_prio[j]) in over:
                    to_evict.append(j)
        return to_evict

    # -------------------------------------------------- eviction order index

    def _assign_evict_indices(self):
        """addEvictedJobsToNodeDb (preempting_queue_scheduler.go:584-633):
        iterate evicted gangs in cost order with *static* post-eviction
        allocations, assigning a global fairness index to each job."""
        snap = self.snap
        by_queue: dict[int, list] = {}
        for j in sorted(self.evicted, key=lambda x: snap.job_order[x]):
            by_queue.setdefault(int(snap.job_queue[j]), []).append(j)

        # Group per-queue into evicted gangs (cardinality = evicted count).
        gangs_by_queue: dict[int, list] = {}
        for q, jobs in by_queue.items():
            gang_map: dict[str, list] = {}
            singles = []
            for j in jobs:
                gid = snap.job_gang_id[j]
                if gid:
                    gang_map.setdefault(gid, []).append(j)
                else:
                    singles.append([j])
            gangs: list = singles + [m for m in gang_map.values()]
            # Yield order: by the last member's queue position.
            gangs.sort(key=lambda m: max(snap.job_order[x] for x in m))
            gangs_by_queue[q] = gangs

        # Iterate with the full candidate-gang comparator (the reference
        # passes preferLargeJobOrdering but considerPriority=false here,
        # preempting_queue_scheduler.go:604). Queue allocations stay static
        # during this walk (the MinimalQueue Add result is discarded).
        heads = {q: 0 for q in gangs_by_queue}
        self.evict_index = {}
        i = 0
        while True:
            best = None
            for q in heads:
                if heads[q] >= len(gangs_by_queue[q]):
                    continue
                members = gangs_by_queue[q][heads[q]]
                req = snap.job_req[members].sum(axis=0)
                proposed = self._queue_cost(q, req)
                current = self._queue_cost(q)
                size = float(
                    policy.policy_cost(
                        self.policy_spec, req.astype(np.float64), self.total, self.mult
                    )
                    * snap.queue_weight[q]
                )
                item = (q, members, True, proposed, current, size, 0)
                if best is None or self._pq_less(
                    item, best, False, self._evict_budgets
                ):
                    best = item
            if best is None:
                break
            best_q = best[0]
            for j in gangs_by_queue[best_q][heads[best_q]]:
                self.evict_index[j] = i
                i += 1
            heads[best_q] += 1

    # ------------------------------------------------------- queue scheduler

    def _scheduling_key(self, j: int):
        snap = self.snap
        return (
            int(snap.job_queue[j]),
            snap.job_req[j].tobytes(),
            snap.job_tolerated[j].tobytes(),
            snap.job_selector[j].tobytes(),
            int(snap.job_priority[j]),
            self.job_pc_name[j],
        )

    def _build_streams(self, include_queued: bool, restrict=None) -> dict:
        """Per-queue candidate streams: evicted first, then queued.
        restrict: if set, only these evicted jobs enter the stream (pass 2
        considers only oversubscription-evicted jobs, the new in-memory repo
        of preempting_queue_scheduler.go:166-178)."""
        snap = self.snap
        streams: dict[int, _QueueStream] = {}
        for q in range(snap.num_queues):
            ev = sorted(
                (
                    j
                    for j in self.evicted
                    if snap.job_queue[j] == q
                    and (restrict is None or j in restrict)
                ),
                key=lambda j: snap.job_order[j],
            )
            qd = []
            if include_queued:
                qd = sorted(
                    (
                        j
                        for j in range(snap.num_jobs)
                        if not snap.job_is_running[j]
                        and snap.job_queue[j] == q
                        and j not in self.scheduled
                        and j not in self.evicted
                    ),
                    key=lambda j: snap.job_order[j],
                )
            if self.market_driven:
                # Market mode merges evicted and queued by price order
                # (MarketDrivenMultiJobsIterator), not evicted-first.
                merged = sorted(
                    [(j, True) for j in ev] + [(j, False) for j in qd],
                    key=lambda item: snap.job_order[item[0]],
                )
                streams[q] = _QueueStream(
                    jobs=[j for j, _ in merged],
                    is_evicted=[e for _, e in merged],
                )
            else:
                streams[q] = _QueueStream(
                    jobs=ev + qd, is_evicted=[True] * len(ev) + [False] * len(qd)
                )
        return streams

    def _evicted_gang_cardinality(self) -> dict:
        """Evicted gangs have their cardinality set to the number of evicted
        members (setEvictedGangCardinality)."""
        snap = self.snap
        counts: dict = {}
        for j in self.evicted:
            gid = snap.job_gang_id[j]
            if gid:
                key = (int(snap.job_queue[j]), gid)
                counts[key] = counts.get(key, 0) + 1
        return counts

    def _stream_peek(self, stream: _QueueStream, skip_key_check: bool, evicted_cards: dict):
        """QueuedGangIterator.Peek (queue_scheduler.go:316-376)."""
        snap = self.snap
        if stream.head is not None:
            return stream.head
        while stream.pos < len(stream.jobs):
            if self.max_lookback and not stream.only_evicted:
                if stream.jobs_seen >= self.max_lookback:
                    stream.only_evicted = True
            j = stream.jobs[stream.pos]
            is_ev = stream.is_evicted[stream.pos]
            stream.pos += 1
            if stream.only_evicted and not is_ev:
                continue
            if not is_ev:
                stream.jobs_seen += 1
            # Skip jobs with known-unfeasible scheduling keys. Evicted jobs
            # carry additional selectors/tolerations, so they never have a
            # valid key (context/job.go:96-101).
            if skip_key_check and not is_ev and self.unfeasible_keys:
                key = self._scheduling_key(j)
                if key in self.unfeasible_keys:
                    self.job_reason[j] = self.unfeasible_keys[key]
                    continue
            gid = snap.job_gang_id[j]
            g = int(snap.job_gang[j])
            # Cardinality: evicted members use the count of active gang jobs
            # (setEvictedGangCardinality, preempting_queue_scheduler.go:458);
            # queued members use the declared cardinality. Members accumulate
            # under the gang id alone, evicted and queued together.
            if gid and is_ev:
                card = evicted_cards.get((int(snap.job_queue[j]), gid), 1)
            elif gid and snap.gang_card[g] > 1:
                card = int(snap.gang_card[g])
            else:
                card = 1
            if gid and card > 1:
                acc = stream.gang_accum.setdefault(gid, [])
                acc.append(j)
                if len(acc) >= card:
                    del stream.gang_accum[gid]
                    all_ev = all(x in self.evicted for x in acc)
                    stream.head = (acc, all_ev)
                    return stream.head
            else:
                stream.head = ([j], is_ev)
                return stream.head
        return None

    def _gang_pc_priority(self, members) -> int:
        """Lowest effective priority across the gang
        (queue_scheduler.go:560-577)."""
        return min(int(self.sched_prio[j]) for j in members)

    def _queue_schedule(
        self,
        include_queued: bool,
        skip_key_check: bool,
        consider_priority: bool,
        budgets: np.ndarray,
        restrict=None,
    ):
        """QueueScheduler.Schedule (queue_scheduler.go:91-276)."""
        snap = self.snap
        streams = self._build_streams(include_queued, restrict)
        evicted_cards = self._evicted_gang_cardinality()
        only_evicted_global = False
        only_evicted_queues: set[int] = set()

        pass_loops = 0
        while True:
            # Round budget (maxSchedulingDuration): stop yielding new
            # candidate loops once spent — only in the queued pass;
            # evicted-only passes rebind running jobs and must complete
            # for a committable result. The first loop always runs
            # (forward-progress floor: a budget spent before the solve
            # still drains >=1 gang per round).
            if (
                include_queued
                and pass_loops > 0
                and self._deadline is not None
                and _time.monotonic() >= self._deadline
            ):
                self.truncated = True
                break
            pass_loops += 1
            # Peek every queue, pick the best per the PQ comparator.
            best = None  # (q, members, all_ev, proposed, current, size, pcp)
            for q in range(snap.num_queues):
                stream = streams[q]
                if only_evicted_global or q in only_evicted_queues:
                    stream.only_evicted = True
                    if stream.head is not None and not stream.head[1]:
                        stream.head = None
                head = self._stream_peek(stream, skip_key_check, evicted_cards)
                if head is None:
                    continue
                members, all_ev = head
                req = snap.job_req[members].sum(axis=0)
                proposed = self._queue_cost(q, req)
                current = self._queue_cost(q)
                size = float(
                    policy.policy_cost(
                        self.policy_spec, req.astype(np.float64), self.total, self.mult
                    )
                    * snap.queue_weight[q]
                )
                pcp = self._gang_pc_priority(members)
                item = (q, members, all_ev, proposed, current, size, pcp)
                if best is None or self._pq_less(
                    item, best, consider_priority, budgets
                ):
                    best = item
            if best is None:
                break
            q, members, all_ev, proposed, _, _, _ = best

            ok, reason = self._gang_schedule(q, members, all_ev)
            streams[q].head = None  # Clear()

            if not ok:
                if is_terminal(reason):
                    self.termination_reason = reason
                    only_evicted_global = True
                elif is_queue_terminal(reason):
                    only_evicted_queues.add(q)
            self.num_loops += 1

    def _gang_price(self, members) -> float:
        """A gang's market price: the lowest member bid (the price-setting
        member, queue_scheduler.go:145-160)."""
        return float(min(self.snap.job_bid[m] for m in members))

    def _pq_less(self, a, b, consider_priority: bool, budgets) -> bool:
        """QueueCandidateGangIteratorPQ.Less (queue_scheduler.go:628-674);
        market mode orders by highest gang price (market_iterator.go)."""
        (qa, ma, _, prop_a, cur_a, size_a, pcp_a) = a
        (qb, mb, _, prop_b, cur_b, size_b, pcp_b) = b
        if self.market_driven:
            pa, pb = self._gang_price(ma), self._gang_price(mb)
            if pa != pb:
                return pa > pb
            return self.snap.queue_names[qa] < self.snap.queue_names[qb]
        if consider_priority and pcp_a != pcp_b:
            return pcp_a > pcp_b
        if self.policy_rank is not None:
            # Policy-supplied leading rank (strict priority / deadline):
            # smaller rank wins, mirroring _policy_rank_key in the kernel.
            ra, rb = self.policy_rank[qa], self.policy_rank[qb]
            if ra != rb:
                return ra < rb
        if self.prefer_large:
            ba, bb = budgets[qa], budgets[qb]
            if prop_a <= ba and prop_b <= bb:
                if cur_a == cur_b and size_a != size_b:
                    return size_a > size_b
                if cur_a != cur_b:
                    return cur_a < cur_b
            elif prop_a > ba and prop_b > bb:
                if prop_a != prop_b:
                    return prop_a < prop_b
            elif prop_a <= ba:
                return True
            elif prop_b <= bb:
                return False
        else:
            if prop_a != prop_b:
                return prop_a < prop_b
        return self.snap.queue_names[qa] < self.snap.queue_names[qb]

    # -------------------------------------------------------- gang scheduler

    def _gang_schedule(self, q: int, members, all_evicted: bool):
        """GangScheduler.Schedule (gang_scheduler.go:100-149)."""
        snap = self.snap
        card = len(members)

        if not all_evicted:
            # CheckRoundConstraints
            if (self.scheduled_new > self.max_round_resources).any():
                return self._fail(members, R_MAX_ROUND_RESOURCES)
            # Queue cordoned (constraints.go:131-134)
            if snap.queue_cordoned[q]:
                return self._fail(members, R_QUEUE_CORDONED)
            # CheckJobConstraints: rate limits + per-queue-per-PC caps
            if self.global_tokens < 1:
                return self._fail(members, R_GLOBAL_RATE_LIMIT)
            if self.global_burst < card:
                return self._fail(members, R_GANG_GLOBAL_BURST)
            if self.global_tokens < card:
                return self._fail(members, R_GLOBAL_RATE_LIMIT_GANG)
            if self.queue_tokens[q] < 1:
                return self._fail(members, R_QUEUE_RATE_LIMIT)
            if self.queue_burst < card:
                return self._fail(members, R_GANG_QUEUE_BURST)
            if self.queue_tokens[q] < card:
                return self._fail(members, R_QUEUE_RATE_LIMIT_GANG)
            pc_name = self.job_pc_name[members[0]]
            limit = self.queue_pc_limits.get((q, pc_name))
            if limit is not None:
                # CheckJobConstraints runs AFTER AddGangSchedulingContext
                # (gang_scheduler.go:132-140): the allocation it compares
                # against the cap INCLUDES the candidate gang, so the gate
                # is would-exceed, not already-exceeded.
                allocated = np.asarray(
                    self.queue_pc_alloc.get((q, pc_name), 0)
                ) + sum(
                    self.snap.job_req[m].astype(np.float64) for m in members
                )
                if np.any(allocated > limit):
                    return self._fail(members, R_QUEUE_LIMIT)

        # Floating-resource pool caps (IsWithinFloatingResourceLimits,
        # gang_scheduler.go:144; applies to evicted gangs too) — except
        # cross-pool away gangs, whose limits were checked by their home
        # pool's round (context/scheduling.go:546-557).
        if snap.floating_mask.any() and not snap.job_away[members[0]]:
            gang_req = snap.job_req[members].sum(axis=0)
            over = snap.floating_mask & (
                self.pool_floating + gang_req > snap.floating_total
            )
            if over.any():
                return self._fail(members, R_FLOATING)

        ok, reason = self._try_schedule(members, all_evicted)
        if ok:
            if not all_evicted:
                self.global_tokens -= card
                self.queue_tokens[q] -= card
            if self.market_driven and self.spot_price is None:
                self.sched_cost_accum += snap.job_req[members].sum(axis=0)
                total_cost = drf.unweighted_cost(
                    self.sched_cost_accum.astype(np.float64), self.total, self.mult
                )
                if total_cost > self.spot_price_cutoff:
                    # Spot price: the lowest bid in the crossing gang
                    # (queue_scheduler.go:145-160).
                    self.spot_price = self._gang_price(members)
            for j in members:
                was_evicted_round = j in self.rescheduled
                self.pool_floating += np.where(snap.floating_mask, snap.job_req[j], 0)
                self.queue_alloc[q] += snap.job_req[j]
                key = (q, self.job_pc_name[j])
                self.queue_pc_alloc[key] = (
                    self.queue_pc_alloc.get(key, 0) + snap.job_req[j].astype(np.float64)
                )
                if not was_evicted_round:
                    self.scheduled_new += snap.job_req[j]
            return True, ""
        return self._fail(members, reason)

    def _fail(self, members, reason):
        for j in members:
            self.job_reason[j] = reason
        # Register unfeasible keys for single-job, non-evicted gangs with
        # gang-property reasons (gang_scheduler.go:80-95).
        if (
            len(members) == 1
            and reason_is_property_of_gang(reason)
            and members[0] not in self.evicted
            and not self.extra_tolerated[members[0]].any()
        ):
            key = self._scheduling_key(members[0])
            self.unfeasible_keys.setdefault(key, reason)
        return False, reason

    def _try_schedule(self, members, all_evicted: bool):
        """trySchedule with node-uniformity search (gang_scheduler.go:151-224)."""
        snap = self.snap
        g = int(snap.job_gang[members[0]])
        uniformity = (
            snap.gang_uniformity_key[g]
            if 0 <= g < snap.num_gangs and len(members) > 1
            else ""
        )
        if not uniformity:
            return self._try_schedule_gang(members, None)

        values = sorted(
            {v for (k, v) in snap.label_vocab.pairs if k == uniformity}
        )
        if not values:
            return False, f"no nodes with uniformity label {uniformity}"

        best_value, best_fit = None, None
        for value in values:
            bits, possible = snap.label_vocab.selector_bits({uniformity: value})
            if not possible:
                continue
            cp = self._checkpoint()
            ok, _, fit = self._try_schedule_gang_fit(members, bits)
            if ok and fit[0] == len(members) and fit[1] == float(MIN_PRIORITY):
                return True, ""  # best possible, keep committed
            if ok:
                if best_fit is None or self._fit_less(best_fit, fit):
                    if value == values[-1]:
                        return True, ""  # last option and best so far: keep
                    best_value, best_fit = value, fit
            self._restore(cp)
        if best_value is None:
            return False, "at least one job in the gang does not fit on any node"
        bits, _ = snap.label_vocab.selector_bits({uniformity: best_value})
        ok, reason, _ = self._try_schedule_gang_fit(members, bits)
        return ok, reason

    @staticmethod
    def _fit_less(a, b) -> bool:
        """GangSchedulingFit.Less (context/gang.go:89-91)."""
        return a[0] < b[0] or (a[0] == b[0] and a[1] > b[1])

    def _try_schedule_gang(self, members, extra_sel):
        cp = self._checkpoint()
        ok, reason, _ = self._try_schedule_gang_fit(members, extra_sel)
        if not ok:
            self._restore(cp)
        return ok, reason

    def _try_schedule_gang_fit(self, members, extra_sel):
        """ScheduleManyWithTxn (nodedb.go:378-410); returns (ok, reason, fit)."""
        preempted_ats = []
        for j in members:
            n, preempted_at = self._select_node(j, extra_sel)
            if n is None:
                reason = R_GANG_NO_FIT if len(members) > 1 else R_JOB_NO_FIT
                return False, reason, (len(preempted_ats), 0.0)
            was_evicted = j in self.evicted
            self._bind(j, n, int(self.sched_prio[j]))
            if was_evicted:
                self.rescheduled.add(j)
            else:
                self.scheduled.add(j)
            self.job_reason[j] = ""
            preempted_ats.append(preempted_at)
        mean = (
            float(np.mean(preempted_ats)) if preempted_ats else float(MIN_PRIORITY)
        )
        return True, "", (len(preempted_ats), mean)

    # ---------------------------------------------------------------- solve

    def solve(self, budget_s: float | None = None) -> RoundResult:
        snap = self.snap
        self._init_state()
        if budget_s and budget_s > 0:
            self._deadline = _time.monotonic() + float(budget_s)
        fair_share, demand_capped, uncapped = self._compute_fair_shares()
        budgets = np.where(
            snap.queue_weight > 0, demand_capped / snap.queue_weight, np.inf
        )
        self._evict_budgets = budgets

        preempted: set[int] = set()

        # 1. Evict for resource balancing.
        to_evict = self._node_evictor(demand_capped, fair_share, uncapped)
        to_evict += self._gang_completion_eviction(to_evict)
        for j in to_evict:
            self._evict(j)
            preempted.add(j)
        self._assign_evict_indices()

        # 2. First schedule pass: evicted + queued.
        self._queue_schedule(
            include_queued=True,
            skip_key_check=True,
            consider_priority=False,
            budgets=budgets,
        )
        if self.truncated:
            # Rescue pass (round deadline): evicted jobs whose rebind
            # attempt the truncation cut off get it now — truncation must
            # shed NEW placements, not preempt running work that still
            # fits its own node. Evicted-only passes ignore the deadline.
            self._queue_schedule(
                include_queued=False,
                skip_key_check=False,
                consider_priority=False,
                budgets=budgets,
            )
        for j in list(self.rescheduled):
            preempted.discard(j)

        # 3. Evict from oversubscribed nodes.
        over = self._oversubscribed_evictor()
        over += self._gang_completion_eviction(over)
        scheduled_and_evicted: set[int] = set()
        self.rescheduled.clear()
        for j in over:
            if j in self.scheduled:
                # Evicting a job scheduled this round also backs out its
                # contribution to per-round scheduled resources
                # (context/scheduling.go:526+).
                self.scheduled.discard(j)
                scheduled_and_evicted.add(j)
                self.scheduled_new -= snap.job_req[j]
            else:
                preempted.add(j)
            self._evict(j)
        if over:
            self._assign_evict_indices()
            # 4. Second pass: ONLY the oversubscription-evicted jobs (the
            # fresh in-memory repo of the reference), considering
            # priority-class priority.
            self._queue_schedule(
                include_queued=False,
                skip_key_check=False,
                consider_priority=True,
                budgets=budgets,
                restrict=set(over),
            )
            for j in list(self.rescheduled):
                preempted.discard(j)
                if j in scheduled_and_evicted:
                    self.scheduled.add(j)
                    scheduled_and_evicted.discard(j)

        # 5. Finalize: evicted-but-not-rescheduled jobs are unbound.
        assigned = self.assigned_node.copy()
        for j in self.evicted:
            assigned[j] = NO_NODE

        scheduled_mask = np.zeros(snap.num_jobs, dtype=bool)
        for j in self.scheduled:
            scheduled_mask[j] = True
        preempted_mask = np.zeros(snap.num_jobs, dtype=bool)
        for j in preempted:
            if snap.job_is_running[j]:
                preempted_mask[j] = True
                assigned[j] = NO_NODE

        return RoundResult(
            assigned_node=assigned,
            scheduled_priority=self.sched_prio.copy(),
            scheduled_mask=scheduled_mask,
            preempted_mask=preempted_mask,
            fair_share=fair_share,
            demand_capped_fair_share=demand_capped,
            uncapped_fair_share=uncapped,
            termination_reason=(
                "round_truncated"
                if self.truncated
                else (self.termination_reason or "no remaining candidate jobs")
            ),
            unschedulable_reason=self.job_reason,
            num_loops=self.num_loops,
            spot_price=self.spot_price,
            truncated=self.truncated,
        )
