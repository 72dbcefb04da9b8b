"""Dense per-round snapshot: the input to the scheduling solve.

One RoundSnapshot holds everything a pool's scheduling round needs, flattened
into numpy arrays (exact int64 on host; `device()` converts to int32/uint32
lanes for the device solve). It corresponds to what the reference assembles in
newFairSchedulingAlgoContext + populateNodeDb
(internal/scheduler/scheduling/scheduling_algo.go:411,920):
node allocatable-by-priority, per-queue allocation/demand, and the queued
work, but column-oriented instead of object graphs.

Allocatable model (mirrors internaltypes AllocatableByPriority semantics):
  allocatable[p, n] = total[n] - sum(requests of jobs bound on n whose
                       effective priority >= priorities[p])
A job "fits at priority p" iff its request <= allocatable[p]. Binding at
priority q subtracts the request from every row with priorities[p] <= q;
evicting moves a job's effective priority to EVICTED_PRIORITY (-1), i.e. adds
the request back to every row above it (nodedb.go:902-1096).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np

from ..core.config import SchedulingConfig
from ..core.priorities import EVICTED_PRIORITY, priority_levels
from ..core.resources import ResourceListFactory, parse_quantity
from ..core.types import JobSpec, NodeSpec, QueueSpec, RunningJob
from .vocab import LabelVocab, TaintVocab, referenced_label_keys

NO_NODE = -1
NO_GANG = -1
# Market price for running non-preemptible jobs
# (pricing.NonPreemptibleRunningPrice = 1_000_000 in the reference): bids
# above it can still outrank non-preemptible incumbents, exactly as there.
NON_PREEMPTIBLE_RUNNING_PRICE = 1_000_000.0


@dataclass
class RoundSnapshot:
    config: SchedulingConfig
    factory: ResourceListFactory
    pool: str

    # --- priority axis ---
    priorities: np.ndarray  # int32[P], ascending, priorities[0] == -1

    # --- nodes ---
    node_ids: list  # index -> node id (str)
    allocatable: np.ndarray  # int64[P, N, R], after binding running jobs
    node_total: np.ndarray  # int64[N, R]
    node_taint_bits: np.ndarray  # uint32[N, Wt]
    node_label_bits: np.ndarray  # uint32[N, Wl]
    node_id_rank: np.ndarray  # int32[N]: rank of node id (lexicographic)
    node_unschedulable: np.ndarray  # bool[N]

    # --- candidate ordering over indexed resources ---
    order_res_idx: np.ndarray  # int32[K] resource column per order position
    order_res_resolution: np.ndarray  # int64[K] rounding, host units

    # --- queues ---
    queue_names: list
    queue_weight: np.ndarray  # float64[Q]
    queue_cordoned: np.ndarray  # bool[Q] (no new gangs schedule from these)
    queue_allocated: np.ndarray  # int64[Q, R] (running jobs in this pool)
    queue_demand: np.ndarray  # int64[Q, R] (running + queued)
    # Short-job penalty: requests of recently-finished short jobs, included
    # in candidate-ordering costs only (short_job_penalty.go).
    queue_short_penalty: np.ndarray  # int64[Q, R]

    # --- jobs (running + queued, one table) ---
    job_ids: list
    job_req: np.ndarray  # int64[J, R]
    job_tolerated: np.ndarray  # uint32[J, Wt]
    job_selector: np.ndarray  # uint32[J, Wl]
    job_possible: np.ndarray  # bool[J]: selector satisfiable at all
    job_queue: np.ndarray  # int32[J]
    job_priority: np.ndarray  # int32[J]: scheduled-at (running) or PC priority
    job_preemptible: np.ndarray  # bool[J]
    job_is_running: np.ndarray  # bool[J]
    # Cross-pool away job (accounts under its "<queue>-away" phantom row;
    # eviction candidate only when bound to a node of this round).
    job_away: np.ndarray  # bool[J]
    job_node: np.ndarray  # int32[J]: bound node (running) or NO_NODE
    job_order: np.ndarray  # int64[J]: within-queue order rank (lower first)
    # Nodes previous attempts failed on (retry anti-affinity,
    # scheduler.go:589-636): up to maxRetries node indices, -1 padded.
    job_excluded_nodes: np.ndarray  # int32[J, K]
    # Node-affinity groups: jobs sharing an affinity expression share a
    # precomputed allowed-node bitmask (NodeAffinityRequirementsMet,
    # nodematching.go:242-255). -1 = no affinity.
    job_affinity_group: np.ndarray  # int32[J]
    affinity_allowed: np.ndarray  # uint32[A, ceil(N/32)] allowed-node bits
    job_gang: np.ndarray  # int32[J] -> gang table index
    # Raw gang identity per job ("" if none), for gang-aware eviction of
    # running jobs (which do not get gang table rows).
    job_gang_id: list
    # Resolved priority-class name per job (after defaulting).
    job_pc_name: list
    # Market mode: bid price per job for this snapshot's pool.
    job_bid: np.ndarray  # float64[J]
    # Running-phase bid per job (== job_bid for already-running jobs).
    # Consumers that price the POST-round cluster (solver/pricer.py) use
    # this for jobs the round just scheduled: the reference reads
    # job.GetBidPrice on the post-round jobdb, where a just-leased job
    # resolves to its running-phase bid.
    job_bid_running: np.ndarray  # float64[J]

    # --- gangs (every job belongs to exactly one; singletons common) ---
    gang_queue: np.ndarray  # int32[G]
    gang_card: np.ndarray  # int32[G] declared cardinality
    gang_member_offsets: np.ndarray  # int32[G+1]
    gang_members: np.ndarray  # int32[sum members] job indices, queue order
    gang_total_req: np.ndarray  # int64[G, R]
    gang_order: np.ndarray  # int64[G]: queue position (last member's rank)
    gang_complete: np.ndarray  # bool[G] all declared members present
    gang_uniformity_key: list  # per gang: uniformity label key or ""

    # --- away scheduling (selectNodeForJobWithTxnAndAwayNodeType,
    # nodedb.go:551-595): per priority class, ordered fallback targets with
    # extra tolerated-taint bits and a reduced scheduling priority ---
    pc_names: list  # priority-class name per index (order of pc tables)
    pc_away_count: np.ndarray  # int32[C]
    pc_away_prio: np.ndarray  # int32[C, Amax]
    pc_away_tol: np.ndarray  # uint32[C, Amax, Wt]

    # --- vocabularies (host-side, for decoding/reporting) ---
    taint_vocab: TaintVocab
    label_vocab: LabelVocab

    # --- rate-limit token state (scheduler.go carries the limiter across
    # cycles; the service refills these buckets and passes them in; None =
    # full burst, the single-round default) ---
    global_rate_tokens: float | None
    queue_rate_tokens: dict | None  # {queue name: tokens}

    # --- totals ---
    total_resources: np.ndarray  # int64[R] node sums + floating pool totals
    # Pool-level floating resources (docs/floating_resources.md): capped
    # per pool, not present on nodes. Node columns for these resources are
    # a large sentinel so node-fit checks ignore them.
    floating_mask: np.ndarray  # bool[R]
    floating_total: np.ndarray  # int64[R] (zero on non-floating columns)

    # --- pluggable fairness (solver/policy.py) ---
    # Earliest live-job deadline per queue row (unix seconds; +inf when no
    # job carries the deadline annotation). Only populated when the pool's
    # active policy consumes deadlines; None otherwise (prep substitutes
    # all-+inf, which every other policy ignores).
    queue_deadline: np.ndarray | None = None  # float64[Q]

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def num_jobs(self) -> int:
        return len(self.job_ids)

    @property
    def num_queues(self) -> int:
        return len(self.queue_names)

    @property
    def num_gangs(self) -> int:
        return len(self.gang_card)

    @property
    def num_priorities(self) -> int:
        return len(self.priorities)

    def priority_row(self, priority: int) -> int:
        """Row index of an exact priority level."""
        idx = np.searchsorted(self.priorities, priority)
        if idx >= len(self.priorities) or self.priorities[idx] != priority:
            raise KeyError(f"priority {priority} not in {self.priorities}")
        return int(idx)

    def job_req_fit(self) -> np.ndarray:
        """Requests for node-fit arithmetic: floating columns zeroed (those
        are pool-level, never exchanged with node allocatable)."""
        return np.where(self.floating_mask[None, :], 0, self.job_req)

    def drf_multipliers(self) -> np.ndarray:
        """float64[R] fairness multiplier per resource (0 = ignored)."""
        mult = np.zeros(self.factory.num_resources, dtype=np.float64)
        for name, m in self.config.dominant_resource_fairness_resources.items():
            i = self.factory.name_to_index.get(name)
            if i is not None:
                mult[i] = m if m > 0 else 1.0
        return mult


def build_round_snapshot(
    config: SchedulingConfig,
    pool: str,
    nodes: list[NodeSpec],
    queues: list[QueueSpec],
    running: list[RunningJob],
    queued: list[JobSpec],
    excluded_nodes: dict | None = None,
    cordoned_queues: set | None = None,
    short_job_penalty: dict | None = None,
    global_rate_tokens: float | None = None,
    queue_rate_tokens: dict | None = None,
) -> RoundSnapshot:
    """excluded_nodes: {job_id: [node_id, ...]} — nodes earlier attempts
    failed on; those nodes are infeasible for the retry. cordoned_queues:
    queue names whose new gangs must not schedule (QueueCordoned).
    short_job_penalty: {queue_name: {resource: qty}} anti-churn cost."""
    factory = config.resource_factory()
    R = factory.num_resources
    priorities = np.asarray(priority_levels(config.priority_classes), dtype=np.int32)
    P = len(priorities)

    # Cross-pool borrowing: the round's node set is the pool's own nodes
    # plus the nodes of its configured away pools
    # (scheduling_algo.go:501-504 nodePools = awayPoolNames + currentPool).
    away_node_pools: set = set()
    for pc in config.pools:
        if pc.name == pool:
            away_node_pools = set(pc.away_pools)
            break
    allowed_pools = {pool} | away_node_pools
    nodes = [n for n in nodes if n.pool in allowed_pools]
    node_index = {n.id: i for i, n in enumerate(nodes)}
    N = len(nodes)

    # One job table: running first, then queued. Built once so the label
    # vocabulary and the per-job tensors can never diverge.
    jobs: list[JobSpec] = [r.job for r in running] + list(queued)

    # Vocabularies over this snapshot's population, plus the config-declared
    # indexed labels (nodedb.go:107-120 indexedNodeLabels) and any keys the
    # indicative-pricing shapes reference — the pricer groups and matches
    # through the same interned bitsets.
    extra_keys = set(config.indexed_node_labels)
    for shape in config.gangs_to_price.values():
        if shape.node_uniformity:
            extra_keys.add(shape.node_uniformity)
        extra_keys.update((shape.node_selector or {}).keys())
    taint_vocab = TaintVocab.build(nodes)
    label_vocab = LabelVocab.build(
        nodes, referenced_label_keys(jobs, config.node_id_label, extra_keys)
    )

    # --- node tensors ---
    node_total = factory.encode_cached_batch(
        nodes, lambda n: n.total_resources, ceil=False, tag="node"
    )
    # Floating resources are not node resources: node-fit arithmetic uses
    # requests with floating columns zeroed (job_req_fit), so node tensors
    # never carry or exchange floating quantities; the pool-level cap is
    # enforced by the solver's floating check.
    floating_mask = factory.floating_mask()
    if floating_mask.any():
        node_total[:, floating_mask] = 0
    floating_total = np.zeros(R, dtype=np.int64)
    for fr in config.floating_resources:
        i = factory.name_to_index.get(fr.name)
        if i is None:
            continue
        qty = fr.pools.get(pool, {}).get(fr.name, 0)
        floating_total[i] = factory.from_map({fr.name: qty}, ceil=False)[i]
    node_taint_bits = np.zeros((N, taint_vocab.n_words), dtype=np.uint32)
    node_label_bits = np.zeros((N, label_vocab.n_words), dtype=np.uint32)
    node_unschedulable = np.zeros(N, dtype=bool)
    for i, node in enumerate(nodes):
        node_taint_bits[i] = taint_vocab.node_bits(node)
        node_label_bits[i] = label_vocab.node_bits(node)
        node_unschedulable[i] = node.unschedulable
    node_id_rank = np.argsort(np.argsort([n.id for n in nodes])).astype(np.int32)

    allocatable = np.broadcast_to(node_total, (P, N, R)).copy()
    for i, node in enumerate(nodes):
        for prio, res in (node.unallocatable_by_priority or {}).items():
            req = factory.from_map(res, ceil=True)
            allocatable[priorities <= int(prio), i, :] -= req

    # --- job table ---
    J = len(jobs)
    # Row-cached on the spec objects: warm cycles (same jobs re-snapshotted)
    # skip quantity parsing entirely.
    job_req = factory.encode_cached_batch(
        jobs, lambda j: j.requests, ceil=True, tag="req"
    )
    job_tolerated = np.zeros((J, taint_vocab.n_words), dtype=np.uint32)
    job_selector = np.zeros((J, label_vocab.n_words), dtype=np.uint32)
    job_possible = np.ones(J, dtype=bool)
    job_queue = np.full(J, -1, dtype=np.int32)
    job_priority = np.zeros(J, dtype=np.int32)
    job_preemptible = np.zeros(J, dtype=bool)
    job_is_running = np.zeros(J, dtype=bool)
    job_node = np.full(J, NO_NODE, dtype=np.int32)

    queue_index = {q.name: i for i, q in enumerate(queues)}
    # Phantom away-queue fairness buckets (CalculateAwayQueueName,
    # context/util.go:5): every away job accounts under "<queue>-away" with
    # the home queue's weight, zero demand, and no rate limiter — the
    # borrower's footprint prices into this pool's fairness without
    # becoming home demand (scheduling_algo.go:757-779).
    ext_names = [q.name for q in queues]
    ext_weights = [q.weight for q in queues]
    away_rows: dict[str, int] = {}
    for r in running:
        if r.away and r.job.queue not in away_rows:
            home = queue_index.get(r.job.queue)
            away_rows[r.job.queue] = len(ext_names)
            ext_names.append(f"{r.job.queue}-away")
            ext_weights.append(ext_weights[home] if home is not None else 1.0)
    Q = len(ext_names)
    job_away = np.zeros(J, dtype=bool)

    # Vectorized fast paths: the common case (no taints, no selectors) skips
    # per-job bitset work entirely; priority-class attributes resolve via a
    # small name table; queue indices via one dict pass.
    has_taints = bool(taint_vocab.taints)
    tolerated_cache: dict = {}
    selector_cache: dict = {}
    for j, job in enumerate(jobs):
        if has_taints and job.tolerations:
            cached = tolerated_cache.get(job.tolerations)
            if cached is None:
                cached = taint_vocab.tolerated_bits(job.tolerations)
                tolerated_cache[job.tolerations] = cached
            job_tolerated[j] = cached
        if job.node_selector:
            sel_key = tuple(sorted(job.node_selector.items()))
            cached = selector_cache.get(sel_key)
            if cached is None:
                cached = label_vocab.selector_bits(job.node_selector)
                selector_cache[sel_key] = cached
            job_selector[j], job_possible[j] = cached
        job_queue[j] = queue_index.get(job.queue, -1)

    pc_priority_by_name = {
        name: pc.priority for name, pc in config.priority_classes.items()
    }
    pc_preempt_by_name = {
        name: pc.preemptible for name, pc in config.priority_classes.items()
    }
    default_pc = config.default_priority_class
    pc_names_per_job = [
        j.priority_class if j.priority_class in pc_priority_by_name else default_pc
        for j in jobs
    ]
    job_priority[:] = [pc_priority_by_name[n] for n in pc_names_per_job]
    job_preemptible[:] = [pc_preempt_by_name[n] for n in pc_names_per_job]
    # Priority-class priority, independent of the running override below
    # (market ordering compares PC priority for running jobs too).
    job_pc_priority = job_priority.copy()

    for j, run in enumerate(running):
        job_is_running[j] = True
        job_node[j] = node_index.get(run.node_id, NO_NODE)
        job_priority[j] = run.scheduled_at_priority
        if run.away:
            job_away[j] = True
            job_queue[j] = away_rows[run.job.queue]

    # Within-queue order: (job priority number asc, submitted ts asc, id asc),
    # the jobdb FairShareOrder (jobdb/jobdb.go:27-31). Encoded as a dense rank
    # so both oracle and kernel sort identically. np.lexsort: last key primary.
    jprio = np.asarray([j.priority for j in jobs], dtype=np.int64)
    jts = np.asarray([j.submitted_ts for j in jobs], dtype=np.float64)
    jids = np.asarray([j.id for j in jobs])
    # Bid prices only matter in market mode; skip 1M python calls otherwise.
    if config.market_driven:
        # One pass, both phases: the scheduling order needs the job's
        # current-phase bid; post-round pricing needs the running-phase
        # bid every queued job would carry once leased.
        pairs = np.asarray(
            [j.bid_price_pair(pool) for j in jobs], dtype=np.float64
        ).reshape(J, 2)
        job_bid = np.where(job_is_running, pairs[:, 1], pairs[:, 0])
        job_bid_running = pairs[:, 1]
        # Non-preemptible jobs carry an effectively infinite price once
        # running (pricing.NonPreemptibleRunningPrice): they always win
        # rescheduling. The running-phase array applies it to EVERY
        # non-preemptible job — in the post-round view a just-leased
        # non-preemptible job is running too.
        job_bid = np.where(
            job_is_running & ~job_preemptible,
            NON_PREEMPTIBLE_RUNNING_PRICE,
            job_bid,
        )
        job_bid_running = np.where(
            ~job_preemptible, NON_PREEMPTIBLE_RUNNING_PRICE, job_bid_running
        )
        # MarketJobPriorityComparer (comparison.go MarketSchedulingOrderCompare):
        # priority-class priority first, then highest bid, then running jobs
        # before queued at equal price (anti-churn), then the active-run
        # lease time for running jobs / submit time for queued, then id.
        running_rank = np.where(job_is_running, 0, 1)
        leased_ts = np.zeros(J, dtype=np.float64)
        for j, run in enumerate(running):
            leased_ts[j] = run.leased_ts
        ts_key = np.where(job_is_running, leased_ts, jts)
        perm = np.lexsort((jids, ts_key, running_rank, -job_bid, -job_pc_priority))
    else:
        job_bid = np.zeros(J, dtype=np.float64)
        job_bid_running = job_bid
        perm = np.lexsort((jids, jts, jprio))
    job_order = np.empty(J, dtype=np.int64)
    job_order[perm] = np.arange(J)

    # Node-affinity groups: unique expressions evaluated once per node.
    job_affinity_group = np.full(J, -1, dtype=np.int32)
    affinity_map: dict = {}
    aff_words = max(1, (N + 31) // 32)
    affinity_rows: list[np.ndarray] = []
    for j, job in enumerate(jobs):
        if job.affinity is None or not job.affinity.terms:
            continue
        a = affinity_map.get(job.affinity)
        if a is None:
            a = len(affinity_rows)
            affinity_map[job.affinity] = a
            bits = np.zeros(aff_words, dtype=np.uint32)
            for i, node in enumerate(nodes):
                if job.affinity.matches(node.labels):
                    bits[i // 32] |= np.uint32(1 << (i % 32))
            affinity_rows.append(bits)
        job_affinity_group[j] = a
    affinity_allowed = (
        np.stack(affinity_rows)
        if affinity_rows
        else np.zeros((1, aff_words), dtype=np.uint32)
    )

    # Retry anti-affinity: K columns of excluded node indices per job.
    K = max(1, int(config.max_retries))
    job_excluded_nodes = np.full((J, K), -1, dtype=np.int32)
    if excluded_nodes:
        for j, job in enumerate(jobs):
            bad = excluded_nodes.get(job.id)
            if not bad:
                continue
            idxs = [node_index[n] for n in bad if n in node_index][:K]
            job_excluded_nodes[j, : len(idxs)] = idxs

    # --- bind running jobs ---
    # Non-preemptible jobs are deducted at every priority row
    # (priorityCutoffFor, nodedb.go:1017-1032): neither evictor will remove
    # them, so higher-priority jobs must not over-pack past them.
    req_fit = np.where(floating_mask[None, :], 0, job_req)
    for j, run in enumerate(running):
        n = job_node[j]
        if n >= 0:
            if job_preemptible[j]:
                rows = priorities <= job_priority[j]
            else:
                rows = np.ones(P, dtype=bool)
            allocatable[rows, n, :] -= req_fit[j]

    # --- queue accounting (segment sums) ---
    queue_weight = np.asarray(ext_weights, dtype=np.float64)
    queue_allocated = np.zeros((Q, R), dtype=np.int64)
    queue_demand = np.zeros((Q, R), dtype=np.int64)
    if J and Q:
        valid_q = job_queue >= 0
        qidx = np.where(valid_q, job_queue, 0)
        # Away jobs carry allocation (under their phantom row) but no
        # demand: the reference registers away queue contexts with an
        # empty demand ResourceList (scheduling_algo.go:776).
        demand_w = valid_q & ~job_away
        for r in range(R):
            queue_demand[:, r] = np.bincount(
                qidx, weights=np.where(demand_w, job_req[:, r], 0), minlength=Q
            )[:Q]
            queue_allocated[:, r] = np.bincount(
                qidx,
                weights=np.where(valid_q & job_is_running, job_req[:, r], 0),
                minlength=Q,
            )[:Q]

    # --- gangs ---
    # Only queued jobs group into gang rows: the queue iterator in the
    # reference sees gangs among queued work only (queue_scheduler.go:277);
    # running gang members are handled by the gang-aware eviction pass.
    # Singletons (the overwhelmingly common case) are built in bulk; only
    # true gang members take the per-job path.
    is_gang_member = np.asarray(
        [
            job.gang is not None and job.gang.cardinality > 1 and not job_is_running[j]
            for j, job in enumerate(jobs)
        ],
        dtype=bool,
    )
    singles = np.flatnonzero(~is_gang_member).astype(np.int32)
    n_single = len(singles)

    gang_key_to_idx: dict = {}
    gang_rows: list[dict] = []
    for j in np.flatnonzero(is_gang_member):
        job = jobs[j]
        key = (job.queue, job.gang.id)
        g = gang_key_to_idx.get(key)
        if g is None:
            g = len(gang_rows)
            gang_key_to_idx[key] = g
            gang_rows.append(
                {
                    "queue": int(job_queue[j]),
                    "card": job.gang.cardinality,
                    "members": [],
                    "uniformity": job.gang.node_uniformity_label,
                }
            )
        gang_rows[g]["members"].append(int(j))

    G = n_single + len(gang_rows)
    job_gang = np.full(J, NO_GANG, dtype=np.int32)
    job_gang[singles] = np.arange(n_single, dtype=np.int32)

    gang_queue = np.zeros(G, dtype=np.int32)
    gang_card = np.ones(G, dtype=np.int32)
    gang_uniformity_key = [""] * n_single + [g["uniformity"] for g in gang_rows]
    gang_member_offsets = np.zeros(G + 1, dtype=np.int32)
    gang_total_req = np.zeros((G, R), dtype=np.int64)
    gang_order = np.zeros(G, dtype=np.int64)
    gang_complete = np.zeros(G, dtype=bool)

    # Bulk singleton rows.
    gang_queue[:n_single] = job_queue[singles]
    gang_member_offsets[1 : n_single + 1] = np.arange(1, n_single + 1)
    gang_total_req[:n_single] = job_req[singles]
    gang_order[:n_single] = job_order[singles]
    gang_complete[:n_single] = True
    members_flat: list[int] = list(singles)

    for gi, row in enumerate(gang_rows):
        g = n_single + gi
        # Members in queue order; a gang becomes schedulable when its last
        # member is reached (QueuedGangIterator, queue_scheduler.go:277).
        members = sorted(row["members"], key=lambda j: job_order[j])
        for m in members:
            job_gang[m] = g
        members_flat.extend(members)
        gang_member_offsets[g + 1] = len(members_flat)
        gang_queue[g] = row["queue"]
        gang_card[g] = row["card"]
        gang_total_req[g] = job_req[members].sum(axis=0)
        gang_order[g] = max(job_order[m] for m in members)
        gang_complete[g] = len(members) == row["card"]
    gang_members = np.asarray(members_flat, dtype=np.int32)

    # --- away tables ---
    pc_names = list(config.priority_classes)
    C = len(pc_names)
    Amax = max(
        [1] + [len(config.priority_classes[n].away_node_types) for n in pc_names]
    )
    pc_away_count = np.zeros(C, dtype=np.int32)
    pc_away_prio = np.zeros((C, Amax), dtype=np.int32)
    pc_away_tol = np.zeros((C, Amax, taint_vocab.n_words), dtype=np.uint32)
    from ..core.types import Toleration as _Tol

    for ci, name in enumerate(pc_names):
        for ai, away in enumerate(config.priority_classes[name].away_node_types):
            taints = config.well_known_node_types.get(away.well_known_node_type, ())
            if not taints:
                continue  # no taints -> no extra capability (nodedb.go:576)
            # The tolerations added for the away taints (eviction-style:
            # key+effect, exact value or wildcard, nodedb.go:581-590).
            tols = tuple(
                _Tol(
                    key=t.key,
                    operator="Exists" if t.value == "*" else "Equal",
                    value="" if t.value == "*" else t.value,
                    effect=t.effect,
                )
                for t in taints
            )
            bits = taint_vocab.tolerated_bits(tols)
            if not bits.any():
                continue  # nothing in this snapshot's vocab is tolerated
            a = pc_away_count[ci]
            pc_away_prio[ci, a] = away.priority
            pc_away_tol[ci, a] = bits
            pc_away_count[ci] += 1

    # --- candidate ordering key (indexed resources) ---
    order_idx, order_res = [], []
    for name, resolution in config.indexed_resources.items():
        i = factory.name_to_index.get(name)
        if i is None:
            continue
        host_res = int(parse_quantity(resolution) / (Fraction(10) ** factory.scales[i]))
        order_idx.append(i)
        order_res.append(max(1, host_res))
    order_res_idx = np.asarray(order_idx, dtype=np.int32)
    order_res_resolution = np.asarray(order_res, dtype=np.int64)

    # Pluggable fairness: the deadline policy folds each queue's most
    # urgent job deadline into entitlement and candidate order. Only that
    # policy pays the per-job annotation scan; phantom away rows carry no
    # home demand and stay +inf. Lazy import: solver packages import this
    # module at load time.
    from ..solver import policy as fairness_policy_mod

    queue_deadline = None
    if fairness_policy_mod.spec_from_config(config, pool)[0] == "deadline":
        queue_deadline = np.full(Q, np.inf, dtype=np.float64)
        for j, job in enumerate(jobs):
            raw = job.annotations.get(fairness_policy_mod.DEADLINE_ANNOTATION)
            qi = job_queue[j]
            if raw is None or qi < 0 or job_away[j]:
                continue
            try:
                dl = float(raw)
            except (TypeError, ValueError):
                continue
            if np.isfinite(dl) and dl < queue_deadline[qi]:
                queue_deadline[qi] = dl

    return RoundSnapshot(
        config=config,
        factory=factory,
        pool=pool,
        priorities=priorities,
        node_ids=[n.id for n in nodes],
        allocatable=allocatable,
        node_total=node_total,
        node_taint_bits=node_taint_bits,
        node_label_bits=node_label_bits,
        node_id_rank=node_id_rank,
        node_unschedulable=node_unschedulable,
        order_res_idx=order_res_idx,
        order_res_resolution=order_res_resolution,
        queue_names=ext_names,
        queue_weight=queue_weight,
        queue_cordoned=np.asarray(
            [name in (cordoned_queues or set()) for name in ext_names], dtype=bool
        ),
        queue_short_penalty=factory.encode_requests_batch(
            [(short_job_penalty or {}).get(name, {}) for name in ext_names],
            ceil=True,
        ),
        queue_allocated=queue_allocated,
        queue_demand=queue_demand,
        job_ids=[job.id for job in jobs],
        job_req=job_req,
        job_tolerated=job_tolerated,
        job_selector=job_selector,
        job_possible=job_possible,
        job_queue=job_queue,
        job_priority=job_priority,
        job_preemptible=job_preemptible,
        job_is_running=job_is_running,
        job_away=job_away,
        job_node=job_node,
        job_order=job_order,
        job_excluded_nodes=job_excluded_nodes,
        job_affinity_group=job_affinity_group,
        affinity_allowed=affinity_allowed,
        job_gang=job_gang,
        job_gang_id=[j.gang.id if j.gang is not None else "" for j in jobs],
        job_pc_name=pc_names_per_job,
        job_bid=job_bid,
        job_bid_running=job_bid_running,
        gang_queue=gang_queue,
        gang_card=gang_card,
        gang_member_offsets=gang_member_offsets,
        gang_members=gang_members,
        gang_total_req=gang_total_req,
        gang_order=gang_order,
        gang_complete=gang_complete,
        gang_uniformity_key=gang_uniformity_key,
        pc_names=pc_names,
        pc_away_count=pc_away_count,
        pc_away_prio=pc_away_prio,
        pc_away_tol=pc_away_tol,
        taint_vocab=taint_vocab,
        label_vocab=label_vocab,
        global_rate_tokens=global_rate_tokens,
        queue_rate_tokens=queue_rate_tokens,
        total_resources=np.where(
            floating_mask, floating_total, node_total.sum(axis=0)
        ),
        floating_mask=floating_mask,
        floating_total=floating_total,
        queue_deadline=queue_deadline,
    )
