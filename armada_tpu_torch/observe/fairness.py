"""Fairness observatory: per-round share ledger, preemption attribution,
starvation detection.

The port's copy of armada_tpu/observe/fairness.py, numpy only: it reads
the port's padded round and decision dict, and computes the same ledger
bits as the JAX package on the same round.

The transfer ledger (observe/ledger.py) makes the COST of a round
observable; this module makes its OUTCOME observable — did
each queue actually receive its DRF entitlement, who displaced whom when
preemption fired, and is a queue quietly starving. Everything is derived
host-side from inputs the round already computed (the solver's decision
stream plus the round's own input arrays): no new device work.

Three layers:

- `compute_ledger` / `ledger_from_device_round` /
  `ledger_from_snapshot` — the per-round, per-pool queue ledger: weight,
  entitlement (the solver's demand-capped adjusted fair share from
  `solver/drf.py` water-filling), the full fair-share triple (raw
  weight share, demand-capped, uncapped), demand share, delivered
  dominant share, fairness regret (entitlement minus delivered, floored
  at zero), a starved flag (below entitlement with unsatisfied demand),
  and the pool's Jain fairness index over delivered-per-weight.
  `ledger_from_device_round` is the CANONICAL form: it reads the padded
  `DeviceRound` a solve consumed (the host mirror, for a device-resident
  round) plus its decision dict, so the same bits are computed on live
  rounds, on recorded rounds and on replayed ones.

- `attribute_preemptions` — the preemption attribution map: every
  victim the round preempted is attributed to exactly one aggressor.
  The primary aggressor is the job the round scheduled onto the
  victim's node (highest scheduled priority, then largest dominant
  -share request, then lowest index — deterministic); mechanism is
  `urgency` when the aggressor scheduled above the victim's priority,
  else `fairness` (a DRF rebalance). When nothing landed on the
  victim's node (the node was vacated for headroom), the preemption is
  still `fairness`-attributed to the most under-served queue — the
  queue the rebalance is serving. Drain and reconciliation preemptions
  never reach this map: their events carry their own mechanism.

- `FairnessTracker` — bounded per-(pool, queue) starvation state fed
  once per round: a consecutive-starved-rounds streak plus a trailing
  window, with an SLO-style multiwindow alert: the alert fires only when the FAST condition (starved for
  `k_rounds` consecutive rounds) AND the SLOW condition (starved in at
  least half of a 4x-k_rounds trailing window's full capacity — unseen
  history counts as healthy) both hold, so a single contended burst
  does not page until starvation sustains. Given the scheduler's
  metrics object, the tracker also exports the `scheduler_fairness_*`
  metric families and bumps
  `scheduler_preemption_attributed_total{aggressor_queue,mechanism}`;
  given an SLO tracker that declares it, it feeds the
  `fairness_starved_rounds` signal; `snapshot()` is the document the
  scheduler serves as `GET /api/fairness`. Both are duck-typed: this
  module imports neither.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

from ..solver import policy as fairness_policy
from ..solver.drf import unweighted_cost

# Float slack for "delivered below entitlement": shares are O(1) floats,
# so anything under this is accumulation noise, not starvation.
EPS = 1e-9

MECHANISM_FAIRNESS = "fairness"
MECHANISM_URGENCY = "urgency"

# How preemption mechanisms render in event reasons / job timelines
# ("preempted by queue B gang g-7 under DRF rebalance"). Keyed by the
# DEFAULT (DRF) policy; mechanism_phrase() renders the active policy.
MECHANISM_PHRASE = {
    MECHANISM_FAIRNESS: "under DRF rebalance",
    MECHANISM_URGENCY: "under urgency preemption",
}

# Fairness-rebalance phrasing per policy kind: the preemption reason a
# victim's timeline shows must name the objective that displaced it.
_REBALANCE_PHRASE = {
    "drf": "under DRF rebalance",
    "proportional": "under proportional-fairness rebalance",
    "priority": "under strict-priority rebalance",
    "deadline": "under deadline-aware rebalance",
}


def mechanism_phrase(mechanism: str, policy: str | None = None) -> str:
    """How a preemption mechanism renders under the ACTIVE policy:
    urgency phrasing is policy-independent; fairness phrasing names the
    objective whose rebalance displaced the victim."""
    if mechanism == MECHANISM_FAIRNESS and policy:
        kind = str(policy).split("(", 1)[0]
        return _REBALANCE_PHRASE.get(kind, MECHANISM_PHRASE[mechanism])
    return MECHANISM_PHRASE.get(mechanism, "")


def jain_index(values) -> float:
    """Jain's fairness index over per-queue normalized allocations
    (delivered dominant share / weight): (Σx)² / (n·Σx²) ∈ (0, 1],
    1.0 = perfectly proportional. Empty/zero input reads 1.0 (an idle
    pool is trivially fair)."""
    x = np.asarray(values, dtype=np.float64)
    if x.size == 0:
        return 1.0
    ss = float((x * x).sum())
    if ss <= 0.0:
        return 1.0
    s = float(x.sum())
    return (s * s) / (x.size * ss)


def compute_ledger(
    *,
    job_queue,
    job_req,
    assigned_node,
    total,
    multipliers,
    queue_weight,
    fair_share,
    demand_capped,
    uncapped=None,
    num_jobs: int,
    num_queues: int,
    queue_names=None,
    policy_spec=None,
) -> dict:
    """The per-round queue ledger from explicit arrays (sliced to the
    unpadded prefix here). Entitlements come from the solver's OWN
    decision stream (`fair_share` / `demand_capped` / `uncapped` —
    the water-filling triple), so the ledger never re-derives what
    the solve already committed to; demand and delivered shares are the
    ACTIVE policy's costs of the queue demand / delivered allocation
    under the same totals and multipliers the solve used (the DRF
    dominant share under the default policy)."""
    J, Q = int(num_jobs), int(num_queues)
    job_queue = np.asarray(job_queue)[:J]
    job_req = np.asarray(job_req, dtype=np.float64)[:J]
    assigned = np.asarray(assigned_node)[:J]
    total = np.asarray(total, dtype=np.float64)
    mult = np.asarray(multipliers, dtype=np.float64)
    weight = np.asarray(queue_weight, dtype=np.float64)[:Q]
    fair_share = np.asarray(fair_share, dtype=np.float64)[:Q]
    demand_capped = np.asarray(demand_capped, dtype=np.float64)[:Q]
    uncapped_arr = (
        np.asarray(uncapped, dtype=np.float64)[:Q]
        if uncapped is not None
        else np.zeros(Q)
    )

    R = job_req.shape[1] if job_req.ndim == 2 else 0
    demand_alloc = np.zeros((Q, R))
    delivered_alloc = np.zeros((Q, R))
    if J and Q and R:
        valid = job_queue >= 0
        qidx = np.where(valid, job_queue, 0).astype(np.int64)
        placed = valid & (assigned >= 0)
        for r in range(R):
            demand_alloc[:, r] = np.bincount(
                qidx, weights=np.where(valid, job_req[:, r], 0.0), minlength=Q
            )[:Q]
            delivered_alloc[:, r] = np.bincount(
                qidx, weights=np.where(placed, job_req[:, r], 0.0), minlength=Q
            )[:Q]
    spec = fairness_policy.normalize_spec(
        policy_spec if policy_spec is not None else fairness_policy.DEFAULT_SPEC
    )
    demand_share = (
        fairness_policy.policy_cost(spec, demand_alloc, total, mult)
        if Q
        else np.zeros(0)
    )
    delivered_share = (
        fairness_policy.policy_cost(spec, delivered_alloc, total, mult)
        if Q
        else np.zeros(0)
    )

    queues = []
    regrets = np.zeros(Q)
    for q in range(Q):
        entitlement = float(demand_capped[q])
        delivered = float(delivered_share[q])
        regret = max(0.0, entitlement - delivered)
        starved = regret > EPS and float(demand_share[q]) > delivered + EPS
        regrets[q] = regret
        queues.append(
            {
                "queue": (
                    queue_names[q] if queue_names is not None else int(q)
                ),
                "weight": float(weight[q]),
                "fair_share": float(fair_share[q]),
                "entitlement": entitlement,
                "uncapped": float(uncapped_arr[q]),
                "demand_share": float(demand_share[q]),
                "delivered_share": delivered,
                "regret": regret,
                "starved": bool(starved),
                "delivered": [float(v) for v in delivered_alloc[q]],
            }
        )
    # Jain over the queues actually competing: positive weight and
    # nonzero demand — an idle queue must not drag the index down.
    active = (weight > 0) & (demand_share > EPS) if Q else np.zeros(0, bool)
    jain = jain_index(
        delivered_share[active] / weight[active] if active.any() else ()
    )
    out = {
        "queues": queues,
        "jain": float(jain),
        "max_regret": float(regrets.max()) if Q else 0.0,
        "delivered_total": [float(v) for v in delivered_alloc.sum(axis=0)]
        if R
        else [],
    }
    if fairness_policy.spec_kind(spec) != "drf":
        # Only non-default policies stamp the ledger: a DRF ledger must
        # stay byte-identical to pre-policy builds (old-bundle replay
        # compares ledgers structurally).
        out["policy"] = fairness_policy.spec_to_str(spec)
    return out


def attribute_preemptions(
    *,
    job_queue,
    job_node,
    job_prio,
    job_req,
    assigned_node,
    scheduled_mask,
    preempted_mask,
    scheduled_priority,
    total,
    multipliers,
    ledger: dict | None,
    num_jobs: int,
    policy_spec=None,
) -> list:
    """One attribution entry per preempted job — index-based and fully
    deterministic, so live rounds, recorded rounds and replayed rounds
    produce the identical map (see module docstring for the rule)."""
    J = int(num_jobs)
    job_queue = np.asarray(job_queue)[:J]
    job_node = np.asarray(job_node)[:J]
    job_prio = np.asarray(job_prio)[:J]
    job_req = np.asarray(job_req, dtype=np.float64)[:J]
    assigned = np.asarray(assigned_node)[:J]
    scheduled = np.asarray(scheduled_mask, bool)[:J]
    preempted = np.asarray(preempted_mask, bool)[:J]
    sched_prio = np.asarray(scheduled_priority)[:J]
    total = np.asarray(total, dtype=np.float64)
    mult = np.asarray(multipliers, dtype=np.float64)

    victims = np.flatnonzero(preempted)
    if not len(victims):
        return []
    sched_idx = np.flatnonzero(scheduled)
    by_node: dict[int, list] = {}
    if len(sched_idx):
        spec = fairness_policy.normalize_spec(
            policy_spec
            if policy_spec is not None
            else fairness_policy.DEFAULT_SPEC
        )
        cost = fairness_policy.policy_cost(spec, job_req[sched_idx], total, mult)
        order = np.lexsort(
            (sched_idx, -cost, -sched_prio[sched_idx].astype(np.int64))
        )
        for k in order:
            j = int(sched_idx[k])
            by_node.setdefault(int(assigned[j]), []).append(j)

    # Fallback aggressor for vacated-for-headroom victims: the most
    # under-served queue (largest entitlement - delivered), lowest index
    # on ties — the queue the DRF rebalance is serving.
    fallback_queue = -1
    if ledger:
        best = EPS
        for q, row in enumerate(ledger.get("queues", ())):
            under = float(row["entitlement"]) - float(row["delivered_share"])
            if under > best:
                best, fallback_queue = under, q
    entries = []
    for j in victims:
        j = int(j)
        node = int(job_node[j])
        aggressors = by_node.get(node, ())
        if aggressors:
            agg = aggressors[0]
            mechanism = (
                MECHANISM_URGENCY
                if int(sched_prio[agg]) > int(job_prio[j])
                else MECHANISM_FAIRNESS
            )
            agg_queue = int(job_queue[agg])
        else:
            agg = -1
            mechanism = MECHANISM_FAIRNESS
            agg_queue = fallback_queue
        entries.append(
            {
                "job": j,
                "queue": int(job_queue[j]),
                "node": node,
                "aggressor_job": int(agg),
                "aggressor_queue": int(agg_queue),
                "mechanism": mechanism,
            }
        )
    return entries


def round_fairness_from_arrays(
    *,
    job_queue,
    job_req,
    job_node,
    job_prio,
    total,
    multipliers,
    queue_weight,
    decisions: dict,
    num_jobs: int,
    num_queues: int,
    queue_names=None,
    policy_spec=None,
) -> dict:
    """Ledger + attribution from one set of round arrays + the decision
    dict (any superset of the solver's output keys)."""
    ledger = compute_ledger(
        policy_spec=policy_spec,
        job_queue=job_queue,
        job_req=job_req,
        assigned_node=decisions["assigned_node"],
        total=total,
        multipliers=multipliers,
        queue_weight=queue_weight,
        fair_share=decisions["fair_share"],
        demand_capped=decisions["demand_capped_fair_share"],
        uncapped=decisions.get("uncapped_fair_share"),
        num_jobs=num_jobs,
        num_queues=num_queues,
        queue_names=queue_names,
    )
    preemptions = attribute_preemptions(
        job_queue=job_queue,
        job_node=job_node,
        job_prio=job_prio,
        job_req=job_req,
        assigned_node=decisions["assigned_node"],
        scheduled_mask=decisions["scheduled_mask"],
        preempted_mask=decisions["preempted_mask"],
        scheduled_priority=decisions["scheduled_priority"],
        total=total,
        multipliers=multipliers,
        ledger=ledger,
        num_jobs=num_jobs,
        policy_spec=policy_spec,
    )
    return {"ledger": ledger, "preemptions": preemptions}


def ledger_from_device_round(
    dev, decisions: dict, num_jobs: int, num_queues: int, queue_names=None
) -> dict:
    """The CANONICAL fairness block: computed from the padded DeviceRound
    a solve consumed plus its decision dict. `dev` holds numpy arrays:
    for a device-resident round, pass the host mirror
    (`ResidentRound.host_round()`), so nothing is read back from the
    device."""
    needed = (
        "assigned_node", "scheduled_mask", "preempted_mask",
        "scheduled_priority", "fair_share", "demand_capped_fair_share",
        "uncapped_fair_share",
    )
    decisions = {
        k: np.asarray(decisions[k]) for k in needed if k in decisions
    }
    return round_fairness_from_arrays(
        policy_spec=getattr(dev, "fairness_policy", None),
        job_queue=dev.job_queue,
        job_req=dev.job_req,
        job_node=dev.job_node,
        job_prio=dev.job_prio,
        total=dev.total_resources,
        multipliers=dev.drf_multipliers,
        queue_weight=dev.queue_weight,
        decisions=decisions,
        num_jobs=num_jobs,
        num_queues=num_queues,
        queue_names=queue_names,
    )


def ledger_from_snapshot(snap, result: dict, policy_spec=None) -> dict:
    """Host-unit fallback for rounds with no DeviceRound in hand (the
    oracle backend with no recorder attached): same math over the
    RoundSnapshot's exact int64 arrays."""
    return round_fairness_from_arrays(
        policy_spec=policy_spec,
        job_queue=snap.job_queue,
        job_req=snap.job_req,
        job_node=snap.job_node,
        job_prio=snap.job_priority,
        total=snap.total_resources.astype(np.float64),
        multipliers=snap.drf_multipliers(),
        queue_weight=snap.queue_weight,
        decisions={k: np.asarray(v) for k, v in result.items()
                   if k in (
                       "assigned_node", "scheduled_mask", "preempted_mask",
                       "scheduled_priority", "fair_share",
                       "demand_capped_fair_share", "uncapped_fair_share",
                   ) and v is not None},
        num_jobs=snap.num_jobs,
        num_queues=snap.num_queues,
        queue_names=list(snap.queue_names),
    )


def resolve_names(block: dict, queue_names=None, job_ids=None) -> dict:
    """Copy of a canonical (index-based) fairness block with queue
    indices resolved to names and victim job indices to job ids — the
    shared first decoration step for the live surfaces
    (scheduler._decorate_fairness, which further enriches with node /
    gang / reason) and the offline scorecard
    (tools/fairness_report.py, which resolves through the bundle's
    recorded id vocabularies). Indices without a vocabulary entry pass
    through unchanged."""

    def qname(q):
        if (
            isinstance(q, (int, np.integer))
            and queue_names is not None
            and 0 <= q < len(queue_names)
        ):
            return str(queue_names[q])
        return q

    ledger = dict(block.get("ledger") or {})
    ledger["queues"] = [
        {**row, "queue": qname(row.get("queue"))}
        for row in ledger.get("queues", ())
    ]
    preemptions = []
    for p in block.get("preemptions") or ():
        p = dict(p)
        p["queue"] = qname(p.get("queue"))
        p["aggressor_queue"] = qname(p.get("aggressor_queue"))
        j = p.get("job")
        if (
            isinstance(j, (int, np.integer))
            and job_ids is not None
            and 0 <= j < len(job_ids)
        ):
            p["job_id"] = job_ids[j]
        preemptions.append(p)
    return {"ledger": ledger, "preemptions": preemptions}


class FairnessTracker:
    """Bounded per-(pool, queue) starvation state + the fairness metric
    surface. Thread-safe: written once per round from the scheduler
    thread, read by gRPC/HTTP worker threads."""

    SIGNAL = "fairness_starved_rounds"

    def __init__(self, k_rounds: int = 3, window: int | None = None):
        self.k_rounds = max(1, int(k_rounds))
        # SLOW window: the trailing round span the second alert
        # condition evaluates over — starved in at least half of its
        # FULL capacity (missing history counts as healthy). It must be
        # strictly longer than 2x the consecutive threshold or the
        # condition is implied by the streak and never gates; 4x means
        # a fresh K-streak after a healthy stretch stays silent until
        # starvation SUSTAINS to 2K rounds (or accumulates across
        # interruptions), the flap suppression the multiwindow shape
        # exists for.
        self.window = int(window) if window else 4 * self.k_rounds
        self._lock = threading.Lock()
        self._streak: dict[tuple, int] = {}
        self._recent: dict[tuple, deque] = {}
        self._fired_at: dict[tuple, float] = {}
        self._alerting: set[tuple] = set()
        self._latest: dict[str, dict] = {}  # pool -> decorated doc
        self._rounds: dict[str, int] = {}
        self._policy: dict[str, str] = {}  # pool -> last active policy

    def observe_round(
        self,
        pool: str,
        fairness: dict,
        *,
        now: float = 0.0,
        metrics=None,
        slo=None,
    ) -> dict:
        """Fold one round's fairness block (decorated: queue names +
        aggressor names/gangs) into the tracker; refresh metrics; feed
        the SLO signal when a tracker declares it. Returns the pool doc
        served by /api/fairness and the FairnessReport RPC."""
        ledger = fairness.get("ledger") or {}
        preemptions = fairness.get("preemptions") or ()
        alerts = []
        vanished = []
        with self._lock:
            self._rounds[pool] = self._rounds.get(pool, 0) + 1
            # Queues that left the round (drained / deleted / demandless
            # — the snapshot only carries queues with jobs) stop
            # starving by definition: clear their streaks and alert
            # state so a deleted queue's alert cannot page forever.
            present = {
                str(row["queue"]) for row in ledger.get("queues", ())
            }
            for key in [
                k for k in self._streak if k[0] == pool and k[1] not in present
            ]:
                if self._streak.get(key) or key in self._alerting:
                    vanished.append(key[1])
                self._streak.pop(key, None)
                self._recent.pop(key, None)
                self._fired_at.pop(key, None)
                self._alerting.discard(key)
            for row in ledger.get("queues", ()):
                key = (pool, str(row["queue"]))
                starved = bool(row.get("starved"))
                streak = self._streak.get(key, 0) + 1 if starved else 0
                self._streak[key] = streak
                recent = self._recent.get(key)
                if recent is None:
                    recent = self._recent[key] = deque(maxlen=self.window)
                recent.append(starved)
                # Multiwindow: K consecutive starved rounds (fast) AND
                # starved in at least half the trailing window's FULL
                # capacity (slow) — rounds not yet observed count as
                # healthy, so a fresh streak must sustain past the
                # consecutive threshold before the alert fires.
                slow_bad = sum(recent)
                firing = (
                    streak >= self.k_rounds
                    and slow_bad * 2 >= self.window
                )
                newly = firing and key not in self._alerting
                if firing:
                    self._alerting.add(key)
                    self._fired_at.setdefault(key, float(now))
                else:
                    self._alerting.discard(key)
                    if not starved:
                        self._fired_at.pop(key, None)
                row["starved_rounds"] = streak
                row["alerting"] = firing
                fired = self._fired_at.get(key)
                if fired is not None:
                    row["alert_fired_at"] = fired
                if firing:
                    alerts.append(
                        {
                            "pool": pool,
                            "queue": str(row["queue"]),
                            "starved_rounds": streak,
                            "fired_at": self._fired_at.get(key, float(now)),
                        }
                    )
                if newly and metrics is not None and getattr(
                    metrics, "registry", None
                ) is not None:
                    metrics.fairness_starvation_alerts.labels(
                        pool=pool, queue=str(row["queue"])
                    ).inc()
            active_policy = str(ledger.get("policy") or "drf")
            prev_policy = self._policy.get(pool)
            self._policy[pool] = active_policy
            doc = {
                "pool": pool,
                "now": float(now),
                "rounds": self._rounds[pool],
                "policy": active_policy,
                "ledger": ledger,
                "preemptions": list(preemptions),
                "alerts": alerts,
            }
            self._latest[pool] = doc
        if metrics is not None and getattr(metrics, "registry", None) is not None:
            for name in vanished:
                # A queue that left the round has no demand and no
                # regret: none of its fairness gauges may freeze at
                # their last live values (a regret>0 dashboard alert
                # would page forever on a deleted queue).
                for gauge in (
                    metrics.fairness_starved_rounds,
                    metrics.fairness_regret,
                    metrics.queue_demand_share,
                    metrics.fair_share_uncapped,
                ):
                    gauge.labels(pool=pool, queue=name).set(0.0)
            metrics.fairness_jain.labels(pool=pool).set(
                float(ledger.get("jain", 1.0))
            )
            # Info-style active-policy gauge: live series reads 1; on a
            # flip the previous policy's series drops to 0 instead of
            # freezing (a dashboard keyed on ==1 must follow the flip).
            if prev_policy is not None and prev_policy != active_policy:
                metrics.fairness_policy_info.labels(
                    pool=pool, policy=prev_policy
                ).set(0.0)
            metrics.fairness_policy_info.labels(
                pool=pool, policy=active_policy
            ).set(1.0)
            for row in ledger.get("queues", ()):
                name = str(row["queue"])
                metrics.fair_share_uncapped.labels(pool=pool, queue=name).set(
                    float(row.get("uncapped", 0.0))
                )
                metrics.queue_demand_share.labels(pool=pool, queue=name).set(
                    float(row.get("demand_share", 0.0))
                )
                metrics.fairness_regret.labels(pool=pool, queue=name).set(
                    float(row.get("regret", 0.0))
                )
                metrics.fairness_starved_rounds.labels(
                    pool=pool, queue=name
                ).set(float(row.get("starved_rounds", 0)))
            for p in preemptions:
                metrics.preemption_attributed.labels(
                    aggressor_queue=str(p.get("aggressor_queue", "")),
                    mechanism=str(p.get("mechanism", "")),
                ).inc()
        if slo is not None and slo.observes(self.SIGNAL):
            # Opt-in SLO feed (a config-declared fairness-starvation
            # SLO): the streak in rounds as the signal value — good
            # while under the declared threshold.
            for row in ledger.get("queues", ()):
                if float(row.get("demand_share", 0.0)) > EPS:
                    slo.observe(
                        self.SIGNAL,
                        float(row.get("starved_rounds", 0)),
                        now=now,
                    )
        return doc

    # -- reads ----------------------------------------------------------

    def latest(self, pool: str | None = None) -> dict | None:
        with self._lock:
            if pool is not None:
                return self._latest.get(pool)
            if len(self._latest) == 1:
                return next(iter(self._latest.values()))
            return None

    def snapshot(self) -> dict:
        """The `/api/fairness` / `armadactl fairness` document: latest
        per-pool ledger + attribution + active starvation alerts."""
        with self._lock:
            pools = {pool: dict(doc) for pool, doc in self._latest.items()}
            alerts = [
                {
                    "pool": pool,
                    "queue": queue,
                    "starved_rounds": self._streak.get((pool, queue), 0),
                    "fired_at": self._fired_at.get((pool, queue)),
                }
                for (pool, queue) in sorted(self._alerting)
            ]
        return {"pools": pools, "alerts": alerts}


def aggregate_scorecard(rounds: list, queue_names=None) -> dict:
    """Cross-round scorecard from per-round fairness blocks (live round
    docs, recorded `.atrace` fairness blocks, or recomputed ones): per
    queue the mean entitlement/delivered, total and max regret, starved
    -round count and longest streak; per pool the Jain/max-regret
    trajectory. Used by tools/fairness_report.py and the what-if
    fairness delta."""
    per_queue: dict = {}
    trajectory = []
    attributed: dict = {}
    policies: set = set()
    for i, block in enumerate(rounds):
        ledger = block.get("ledger") or {}
        policies.add(str(ledger.get("policy") or "drf"))
        trajectory.append(
            {
                "round": i,
                "jain": float(ledger.get("jain", 1.0)),
                "max_regret": float(ledger.get("max_regret", 0.0)),
            }
        )
        for row in ledger.get("queues", ()):
            name = str(row["queue"])
            if queue_names is not None and isinstance(row["queue"], int):
                if row["queue"] < len(queue_names):
                    name = str(queue_names[row["queue"]])
            agg = per_queue.setdefault(
                name,
                {
                    "rounds": 0,
                    "entitlement_sum": 0.0,
                    "delivered_sum": 0.0,
                    "demand_sum": 0.0,
                    "regret_total": 0.0,
                    "max_regret": 0.0,
                    "starved_rounds": 0,
                    "max_streak": 0,
                    "_streak": 0,
                },
            )
            agg["rounds"] += 1
            agg["entitlement_sum"] += float(row.get("entitlement", 0.0))
            agg["delivered_sum"] += float(row.get("delivered_share", 0.0))
            agg["demand_sum"] += float(row.get("demand_share", 0.0))
            regret = float(row.get("regret", 0.0))
            agg["regret_total"] += regret
            agg["max_regret"] = max(agg["max_regret"], regret)
            if row.get("starved"):
                agg["starved_rounds"] += 1
                agg["_streak"] += 1
                agg["max_streak"] = max(agg["max_streak"], agg["_streak"])
            else:
                agg["_streak"] = 0
        for p in block.get("preemptions") or ():
            key = (str(p.get("aggressor_queue", "")), str(p.get("mechanism", "")))
            attributed[key] = attributed.get(key, 0) + 1
    queues = {}
    for name, agg in sorted(per_queue.items()):
        n = max(1, agg["rounds"])
        queues[name] = {
            "rounds": agg["rounds"],
            "mean_entitlement": agg["entitlement_sum"] / n,
            "mean_delivered": agg["delivered_sum"] / n,
            "mean_demand": agg["demand_sum"] / n,
            "regret_total": agg["regret_total"],
            "max_regret": agg["max_regret"],
            "starved_rounds": agg["starved_rounds"],
            "max_starved_streak": agg["max_streak"],
        }
    jains = [t["jain"] for t in trajectory]
    return {
        "rounds": len(rounds),
        "policy": "+".join(sorted(policies)) if policies else "drf",
        "queues": queues,
        "jain_mean": float(np.mean(jains)) if jains else 1.0,
        "jain_min": float(min(jains)) if jains else 1.0,
        "max_regret": max((t["max_regret"] for t in trajectory), default=0.0),
        "preemptions_attributed": {
            f"{q}/{m}": n for (q, m), n in sorted(attributed.items())
        },
        "trajectory": trajectory,
    }
