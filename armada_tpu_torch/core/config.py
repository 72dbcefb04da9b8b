"""Scheduling configuration.

A faithful-but-reduced equivalent of the reference's master scheduling config
(internal/scheduler/configuration/configuration.go, defaults in
config/scheduler/config.yaml). Only knobs that affect placement semantics are
modeled; transport/infra settings (pulsar, postgres, grpc) live with the
services that use them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .priorities import AwayNodeType, PriorityClass
from .resources import ResourceListFactory

# Hot-window compaction engagement floor (see SchedulingConfig
# .hot_window_min_slots) — the single constant shared with
# solver/kernel.solve_round's parameter default.
HOT_WINDOW_MIN_SLOTS_DEFAULT = 1 << 19


@dataclass(frozen=True)
class ResourceType:
    name: str
    resolution: str = "1"


@dataclass(frozen=True)
class FloatingResource:
    """Resource not attached to any node, capped per pool
    (docs/floating_resources.md in the reference)."""

    name: str
    resolution: str = "1"
    pools: dict[str, dict[str, str]] = field(default_factory=dict)  # pool -> {name: qty}


@dataclass(frozen=True)
class PoolConfig:
    name: str
    away_pools: tuple[str, ...] = ()
    # Run↔node reconciliation (PoolConfig.ExperimentalRunReconciliation,
    # scheduling/reconciliation.go): validate leased runs against
    # executor-reported nodes each cycle; invalid placements are preempted
    # (gang-aware) or failed for non-preemptible jobs.
    run_reconciliation: bool = False


@dataclass(frozen=True)
class RateLimits:
    """Token-bucket limits on newly scheduled jobs per round
    (config.yaml:105-108; enforced by constraints, not the solver core)."""

    maximum_scheduling_rate: float = 100.0
    maximum_scheduling_burst: int = 1000
    maximum_per_queue_scheduling_rate: float = 50.0
    maximum_per_queue_scheduling_burst: int = 1000


@dataclass(frozen=True)
class OptimiserConfig:
    """The experimental fairness-optimising post-pass knobs
    (configuration OptimiserConfig; scheduling/optimiser/,
    preempting_queue_scheduler.go:659-702)."""

    enabled: bool = False
    # FairnessOptimisingGangScheduler.minFairnessImprovementPercentage.
    min_fairness_improvement_pct: float = 0.0
    # OptimisingQueueScheduler bounds.
    maximum_jobs_per_round: int = 100
    maximum_resource_fraction_to_schedule: dict = field(default_factory=dict)
    # PreemptingNodeScheduler.maximumJobSizeToPreempt ({resource: qty}).
    maximum_job_size_to_preempt: dict | None = None
    minimum_job_size_to_schedule: dict | None = None


@dataclass(frozen=True)
class SLOSpec:
    """A declared service-level objective over one latency signal
    (services/slo.py tracks it; tools/slo_gate.py gates runs on it).

    An observation of `signal` counts GOOD iff value <= threshold_s;
    the objective is the required good fraction. Burn rate is the
    error rate divided by the error budget (1 - objective): 1.0 means
    spending the budget exactly; the multiwindow alert fires when the
    fast AND slow windows both exceed their thresholds (the SRE
    -workbook multiwindow multi-burn-rate shape, defaults 14x/6x)."""

    name: str
    # round_seconds (scheduler cycle wall clock), queue_wait_seconds
    # (submit→first-lease per job), frontdoor_submit_seconds (submit
    # handler through admission + durable ack). Open vocabulary: soaks
    # may declare extra signals (e.g. shard lag).
    signal: str
    threshold_s: float
    objective: float = 0.99
    fast_burn_window_s: float = 300.0
    slow_burn_window_s: float = 3600.0
    fast_burn_threshold: float = 14.0
    slow_burn_threshold: float = 6.0
    description: str = ""


@dataclass(frozen=True)
class GangDefinition:
    """A gang shape the indicative pricer quotes every round
    (configuration.GangDefinition, configuration.go:449-456)."""

    size: int = 1
    # Carried for config parity; price-neutral by construction here AND in
    # the reference: the synthetic gang job's class only sets the bind
    # priority in the pricer's scratch state, and member fit always reads
    # the evicted-priority row, which subtracts every bound job regardless
    # of priority (node_scheduler.go:53, gang_pricer.go:181).
    priority_class: str = ""
    resources: dict = field(default_factory=dict)  # {resource: quantity}
    node_uniformity: str = ""
    node_selector: dict = field(default_factory=dict)
    tolerations: tuple = ()  # tuple[Toleration, ...]


@dataclass(frozen=True)
class SchedulingConfig:
    pools: tuple[PoolConfig, ...] = (PoolConfig(name="default"),)
    supported_resource_types: tuple[ResourceType, ...] = (
        ResourceType("memory", "1"),
        ResourceType("cpu", "1m"),
        ResourceType("ephemeral-storage", "1"),
        ResourceType("nvidia.com/gpu", "1"),
    )
    floating_resources: tuple[FloatingResource, ...] = ()
    # Named taint sets for away scheduling (wellKnownNodeTypes config):
    # {name: (Taint, ...)} using core.types.Taint.
    well_known_node_types: dict = field(default_factory=dict)
    priority_classes: dict[str, PriorityClass] = field(
        default_factory=lambda: {
            "armada-default": PriorityClass("armada-default", 1000, preemptible=False),
            "armada-preemptible": PriorityClass(
                "armada-preemptible", 1000, preemptible=True
            ),
        }
    )
    default_priority_class: str = "armada-default"
    # DRF: resources considered when computing dominant-share cost, with
    # multipliers (fairness.go:34-105). name -> multiplier.
    dominant_resource_fairness_resources: dict[str, float] = field(
        default_factory=lambda: {
            "cpu": 1.0,
            "memory": 1.0,
            "nvidia.com/gpu": 1.0,
            "ephemeral-storage": 1.0,
        }
    )
    # Resources indexed for node selection order (config.yaml:116-124);
    # name -> resolution used to round allocatable when ordering candidates.
    indexed_resources: dict[str, str] = field(
        default_factory=lambda: {
            "nvidia.com/gpu": "1",
            "cpu": "100m",
            "memory": "100Mi",
            "ephemeral-storage": "1Gi",
        }
    )
    indexed_taints: tuple[str, ...] = ()
    indexed_node_labels: tuple[str, ...] = ()
    protected_fraction_of_fair_share: float = 1.0
    max_queue_lookback: int = 100_000
    maximum_resource_fraction_to_schedule: dict[str, float] = field(
        default_factory=lambda: {"memory": 1.0, "cpu": 1.0}
    )
    rate_limits: RateLimits = field(default_factory=RateLimits)
    max_retries: int = 3
    node_id_label: str = "kubernetes.io/hostname"
    gang_id_annotation: str = "armadaproject.io/gangId"
    gang_cardinality_annotation: str = "armadaproject.io/gangCardinality"
    gang_uniformity_label_annotation: str = "armadaproject.io/gangNodeUniformityLabel"
    enable_prefer_large_job_ordering: bool = False
    consider_priority_class_priority: bool = True
    # Batched fill fast path: when the head of a queue's candidate stream
    # starts a run of identical singleton gangs (same scheduling key), the
    # kernel places up to this many of them in ONE while-loop iteration by
    # filling nodes in best-fit order, stopping exactly at the point the
    # serial loop would have switched queues or hit a constraint — so
    # results are bit-identical to the one-gang-per-iteration loop (the
    # parity suite runs with this enabled). 0 disables.
    batch_fill_window: int = 512
    # Fast mode (SURVEY §7 "batch independent single-job gangs between
    # fair-share re-costs"): one kernel iteration batches a whole
    # multi-queue sweep — per-queue candidate-cost sequences are closed
    # forms of their own counts, so the exact serial attempt order is a
    # SORT of all queues' entry keys, cut at the first ineligible head's
    # key (gangs, evicted slots, constraint-blocked queues stay serial).
    # The scheduled job set matches the serial loop whenever every batched
    # job fits without preemption; node assignment is greedy per queue
    # rather than attempt-interleaved, so placements may differ from the
    # reference trace. OFF by default (parity mode).
    enable_fast_fill: bool = False
    # Fast mode only: per iteration each queue batches a window of
    # consecutive batchable slots whose scheduling keys may DIFFER
    # (heterogeneous fill). Placement groups window entries by interned
    # key; this caps the distinct keys handled per queue-window — windows
    # are cut at the first entry introducing key number fill_group_max+1
    # (the cut entry batches next iteration instead).
    fill_group_max: int = 8
    # Hot-window compaction (solver/hotwindow.py): pass 1 solves over a
    # gathered active set of ~this many slots per queue (power-of-two
    # bucketed, floored at the fill window) and scatters results back at
    # chunk boundaries, re-gathering when a queue's window runs low.
    # Bit-exact with the uncompacted kernel; engages only when the
    # window axes actually shrink the round, so small rounds run the
    # fused program unchanged. 0 disables. Sized at ~2x the fill window
    # so one gather covers about two merged fill loops.
    hot_window_slots: int = 4096
    # Compaction engages only when the padded slot axis is at least this
    # big: the host-driven chunked driver costs a fixed ~0.1-0.2s of
    # dispatch/sync overhead per round, which mid-size rounds cannot
    # amortize. The default is the flagship/burst regime (>=512k slots);
    # solve_round's parameter default references this same constant.
    hot_window_min_slots: int = HOT_WINDOW_MIN_SLOTS_DEFAULT
    # Solver autopilot (armada_tpu/autotune): when enabled, perf-only
    # solve knobs (hot window, budgeted chunk stride) come from the
    # tuning store — seeded by `autotuneProfile` (a tools/autotune.py
    # output file) and the persisted checkpoint — and the online
    # controller hill-climbs the per-pool window between rounds from
    # the live solve profile. Placement is structurally unaffected:
    # every tunable knob is bit-exact with the uncompacted kernel.
    autotune_enabled: bool = False
    autotune_profile: str = ""
    # Consecutive same-signal rounds required before the online
    # controller adopts a change (and the cooldown after one).
    autotune_hysteresis_rounds: int = 3
    # Bounds of the online hill-climb's window moves (pow2 steps).
    autotune_min_window_slots: int = 64
    autotune_max_window_slots: int = 1 << 16
    # What-if planner (armada_tpu/whatif): shadow solves over forked
    # round state run on a bounded worker pool off the round thread.
    # `whatif_workers` sizes the pool; `whatif_queue_depth` bounds the
    # pending-plan backlog (excess requests are rejected with
    # RESOURCE_EXHAUSTED — backpressure, never round-thread latency);
    # `whatif_default_rounds` caps the bounded multi-round rollout a
    # plan simulates (gang ETA / requeue landing horizon).
    whatif_workers: int = 1
    whatif_queue_depth: int = 8
    whatif_default_rounds: int = 8
    # Default drain deadline: cordon -> wait for voluntary completion ->
    # preempt stragglers once this many seconds have passed
    # (armada_tpu/whatif/drain.py; 0 = preempt immediately).
    drain_deadline_s: float = 600.0
    # Fairness observatory (armada_tpu/observe/fairness.py): a queue
    # starved (below its DRF entitlement with unsatisfied demand) for
    # this many CONSECUTIVE rounds arms the multiwindow starvation
    # alert (the slow condition — starved in at least half of a 4x
    # trailing window's full capacity — must hold too before it fires,
    # so a fresh streak stays silent until starvation sustains to ~2x
    # this many rounds).
    fairness_starvation_rounds: int = 3
    # Pluggable fairness policies (armada_tpu/solver/policy.py). The
    # default objective for every pool, one of policy.POLICY_KINDS
    # ("drf" | "proportional" | "priority" | "deadline"), overridable
    # per pool via fairness_policy_pools {pool: kind}. Market-driven
    # configs must stay on "drf" (bid order owns candidate ranking;
    # validate_config enforces it). The deadline policy boosts a
    # queue's effective weight by up to `fairness_deadline_boost`x as
    # its most urgent job deadline approaches, decaying over
    # `fairness_deadline_horizon_s` seconds of slack.
    fairness_policy_default: str = "drf"
    fairness_policy_pools: dict = field(default_factory=dict)
    # Solve kernel path (armada_tpu_torch/ops/kernels.py): "lax" runs the
    # unfused reference graph (static feasibility + key pack + stable
    # sort); "cuda" runs the fused scoring and the top-B fill selection,
    # as hand-written CUDA kernels on a card and as their plain torch
    # versions on CPU tensors. The port defaults to "cuda".
    solve_kernel_path: str = "cuda"
    fairness_deadline_boost: float = 2.0
    fairness_deadline_horizon_s: float = 3600.0
    executor_timeout_s: float = 600.0
    # Lease TTL advertised to executor agents in every lease reply: an
    # agent that cannot complete a lease exchange for this long must
    # stop accepting new work and treat its running pods as orphan
    # candidates until an anti-entropy ExecutorSync (partition safety;
    # see the split-brain model in docs/architecture.md). Also caps the
    # agent's cumulative retry-backoff budget so a retrying exchange can
    # never outlive the lease it renews. Should be <= executor_timeout_s:
    # the agent must notice the partition no later than the server does.
    executor_lease_ttl_s: float = 60.0
    max_unacknowledged_jobs_per_executor: int = 2500
    # Round-deadline guardrail (the reference's maxSchedulingDuration,
    # config/scheduler/config.yaml:105): wall-clock budget for one
    # scheduling round. The solver checkpoints between fill loops and
    # stops yielding new loops once the budget is spent; the cycle
    # commits the partial placement (a prefix of the full round's
    # decisions) and reports `round_truncated`. 0 disables.
    max_scheduling_duration_s: float = 0.0
    # Consecutive truncated rounds in one pool before per-pool
    # backpressure trips (services/backpressure.RoundDeadlinePressure)
    # and the health surface turns unhealthy.
    truncated_rounds_backpressure: int = 3
    # Self-healing solve path (solver/validate.py + solver/failover.py):
    # `solver_validate` runs the round admission firewall before any
    # round commits (a violation rejects the round, captures a
    # single-round .atrace postmortem, and requeues the work);
    # `solver_failover` retries a raising/hanging/rejected round down
    # the backend ladder (mesh -> hotwindow LOCAL -> LOCAL -> oracle)
    # within the same cycle. A rung failing
    # `solver_failover_threshold` consecutive rounds opens its circuit
    # breaker and is skipped for `solver_failover_cooldown_rounds`
    # rounds, then re-probed via a shadow solve before restoration.
    # `quarantine_dir` holds rejected-round postmortem bundles (empty =
    # a per-process directory under the system temp dir).
    solver_validate: bool = True
    solver_failover: bool = True
    solver_failover_threshold: int = 3
    solver_failover_cooldown_rounds: int = 8
    quarantine_dir: str = ""
    # Device-resident round state (snapshot/residency.py): every N-th
    # cycle a pool running in "resident" snapshot mode byte-compares its
    # persistent device buffers against the host mirror and resets the
    # resident state on drift (a new `resident_drift` counter fires).
    # 0 disables the sweep.
    resident_drift_check_every: int = 64
    # Store backpressure (common/etcdhealth re-targeted at the event log;
    # services/backpressure.py): reject submissions and pause executor pod
    # creation when the log's disk footprint exceeds this fraction of the
    # capacity quota, or a materialized view lags too far. 0 disables the
    # respective signal.
    store_capacity_bytes: int = 0
    store_fraction_of_capacity_limit: float = 0.8
    max_ingest_lag_events: int = 0
    # Front door (armada_tpu/frontdoor): jobset-keyed sharded ingest +
    # per-tenant admission. `frontdoor_shards` > 0 enables the sharded
    # write path (submissions ack on the shard WAL, per-shard ingesters
    # deliver exactly-once into the main log); rates are jobs/second
    # token buckets, `frontdoor_overload_rate` is the quota-weighted
    # trickle admitted while the backpressure gate is unhealthy.
    frontdoor_shards: int = 0
    frontdoor_tenant_rate: float = 1000.0
    frontdoor_tenant_burst: float = 2000.0
    frontdoor_global_rate: float = 10_000.0
    frontdoor_global_burst: float = 20_000.0
    frontdoor_overload_rate: float = 100.0
    # Short-job penalty (scheduling/short_job_penalty.go): jobs that finish
    # faster than this still count against their queue's cost until the
    # window passes, discouraging churn. 0 disables.
    short_job_penalty_s: float = 0.0
    # Terminal jobs older than this are pruned from the in-memory store
    # (the reference's lookout/scheduler DB pruners).
    terminal_job_retention_s: float = 24 * 3600.0
    # Declared SLOs (services/slo.py): round-latency / queue-wait /
    # front-door objectives tracked with multi-window burn rates and
    # surfaced via `GET /api/slo`, `armadactl slo` and the
    # scheduler_slo_* metric families; tools/slo_gate.py gates runs on
    # them. Empty = services/slo.DEFAULT_SLOS when a tracker is built
    # from config.
    slos: tuple = ()
    # Market-driven scheduling (experimental in the reference,
    # scheduling_algo.go:795-813): candidates ordered by bid price instead
    # of fair share; every bound job is evictable each round; a spot price
    # is recorded once scheduled cost crosses the cutoff fraction.
    market_driven: bool = False
    spot_price_cutoff: float = 0.0
    # Gang shapes the indicative pricer quotes each market round, and its
    # per-round budget (MarketSchedulingConfig.GangsToPrice /
    # GangIndicativePricingTimeout, configuration.go:440-447). Prices land
    # in metrics and the round report.
    gangs_to_price: dict = field(default_factory=dict)  # {name: GangDefinition}
    gang_pricing_timeout_s: float = 1.0
    # Unit for value metrics (idealised/realised, idealised_value.go):
    # value of a job = bid x max_r(request_r / unit_r). The bid snapshot's
    # per-pool resource_units take precedence (scheduling_algo.go:801-808);
    # this is the fallback when the provider supplies none.
    market_resource_unit: dict = field(default_factory=lambda: {"cpu": "1"})
    # Assert jobdb invariants at the end of each cycle (the reference's
    # enableAssertions, scheduler.go:143; config.yaml:84).
    enable_assertions: bool = False
    # Experimental fairness-optimising post-pass
    # (config.Pools[].ExperimentalOptimiser; scheduling/optimiser/).
    optimiser: "OptimiserConfig | None" = None

    # Regex classifier for run errors -> failure category
    # (internal/executor/categorizer/classifier.go): first match wins.
    error_categories: tuple = (
        # Specific rules precede general ones (first match wins).
        (r"(?i)executor .* timed out", "lost-executor"),
        (r"(?i)out of memory|oom", "oom"),
        (r"(?i)timed out|timeout|deadline", "timeout"),
        (r"(?i)image.*pull|pull.*image", "image-pull"),
        (r"(?i)evicted|preempt", "preempted"),
    )

    def resource_factory(self) -> ResourceListFactory:
        # One factory per config instance: spec-object row caches are
        # tagged by factory serial, so a fresh factory per snapshot would
        # defeat them (and factories are immutable anyway).
        cached = self.__dict__.get("_factory")
        if cached is None:
            cached = ResourceListFactory.create(
                [(t.name, t.resolution) for t in self.supported_resource_types],
                [(t.name, t.resolution) for t in self.floating_resources],
            )
            object.__setattr__(self, "_factory", cached)
        return cached

    def window_lookahead(self) -> int:
        """Slots the pass-1 kernel may read ahead of a queue's head
        pointer — the config-level mirror of
        solver/hotwindow.window_lookahead (which reads the prepped
        DeviceRound): the fill window in the batched modes, one slot in
        serial/market mode. The kernel clamps the effective hot window
        up to this (Ws = pow2(max(window, lookahead))), so validation
        and the autotune controller share this one rule instead of
        re-deriving it."""
        if self.batch_fill_window > 0 and not self.market_driven:
            return int(self.batch_fill_window)
        return 1

    def priority_class(self, name: str | None) -> PriorityClass:
        """Resolve a priority-class name, falling back to the default class
        for unknown names (submission-side validation rejects those upstream;
        the scheduler must not crash on one malformed job)."""
        if not name:
            name = self.default_priority_class
        pc = self.priority_classes.get(name)
        if pc is None:
            pc = self.priority_classes[self.default_priority_class]
        return pc

    @staticmethod
    def from_dict(d: dict) -> "SchedulingConfig":
        """Build from a YAML-style dict using the reference's key names."""
        kwargs = {}
        if "pools" in d:
            kwargs["pools"] = tuple(
                PoolConfig(
                    p["name"],
                    tuple(p.get("awayPools", ())),
                    run_reconciliation=bool(
                        (p.get("experimentalRunReconciliation") or {}).get(
                            "enabled", False
                        )
                    ),
                )
                for p in d["pools"]
            )
        if "experimentalOptimiser" in d:
            o = d["experimentalOptimiser"] or {}
            kwargs["optimiser"] = OptimiserConfig(
                enabled=bool(o.get("enabled", False)),
                min_fairness_improvement_pct=float(
                    o.get("minimumFairnessImprovementPercentage", 0.0)
                ),
                maximum_jobs_per_round=int(o.get("maximumJobsPerRound", 100)),
                maximum_resource_fraction_to_schedule=dict(
                    o.get("maximumResourceFractionToSchedule", {})
                ),
                maximum_job_size_to_preempt=o.get("maximumJobSizeToPreempt"),
                minimum_job_size_to_schedule=o.get("minimumJobSizeToSchedule"),
            )
        if "supportedResourceTypes" in d:
            kwargs["supported_resource_types"] = tuple(
                ResourceType(t["name"], str(t.get("resolution", "1")))
                for t in d["supportedResourceTypes"]
            )
        if "floatingResources" in d:
            kwargs["floating_resources"] = tuple(
                FloatingResource(
                    t["name"],
                    str(t.get("resolution", "1")),
                    {
                        p["name"]: dict(p.get("quantity", {}))
                        for p in t.get("pools", [])
                    },
                )
                for t in d["floatingResources"]
            )
        if "wellKnownNodeTypes" in d:
            from .types import Taint

            kwargs["well_known_node_types"] = {
                t["name"]: tuple(
                    Taint(
                        key=x["key"],
                        value=x.get("value", ""),
                        effect=x.get("effect", "NoSchedule"),
                    )
                    for x in t.get("taints", [])
                )
                for t in d["wellKnownNodeTypes"]
            }
        if "priorityClasses" in d:
            kwargs["priority_classes"] = {
                name: PriorityClass(
                    name,
                    int(pc["priority"]),
                    bool(pc.get("preemptible", False)),
                    dict(pc.get("maximumResourceFractionPerQueue", {})),
                    away_node_types=tuple(
                        AwayNodeType(
                            priority=int(a["priority"]),
                            well_known_node_type=a["wellKnownNodeTypeName"],
                        )
                        for a in pc.get("awayNodeTypes", [])
                    ),
                )
                for name, pc in d["priorityClasses"].items()
            }
        if "defaultPriorityClassName" in d:
            kwargs["default_priority_class"] = d["defaultPriorityClassName"]
        if "slos" in d:
            kwargs["slos"] = tuple(
                SLOSpec(
                    name=s["name"],
                    signal=s["signal"],
                    threshold_s=float(
                        s.get("thresholdSeconds", s.get("threshold_s", 0))
                    ),
                    objective=float(s.get("objective", 0.99)),
                    fast_burn_window_s=float(
                        s.get("fastBurnWindowSeconds", 300.0)
                    ),
                    slow_burn_window_s=float(
                        s.get("slowBurnWindowSeconds", 3600.0)
                    ),
                    fast_burn_threshold=float(
                        s.get("fastBurnThreshold", 14.0)
                    ),
                    slow_burn_threshold=float(
                        s.get("slowBurnThreshold", 6.0)
                    ),
                    description=s.get("description", ""),
                )
                for s in d["slos"]
            )
        if "fairnessPolicy" in d:
            fp = d["fairnessPolicy"] or {}
            if "default" in fp:
                kwargs["fairness_policy_default"] = str(fp["default"])
            if "pools" in fp:
                kwargs["fairness_policy_pools"] = {
                    str(pool): str(kind)
                    for pool, kind in (fp["pools"] or {}).items()
                }
            if "deadlineBoost" in fp:
                kwargs["fairness_deadline_boost"] = float(fp["deadlineBoost"])
            if "deadlineHorizonSeconds" in fp:
                kwargs["fairness_deadline_horizon_s"] = float(
                    fp["deadlineHorizonSeconds"]
                )
        if "dominantResourceFairnessResourcesToConsider" in d:
            kwargs["dominant_resource_fairness_resources"] = {
                name: 1.0 for name in d["dominantResourceFairnessResourcesToConsider"]
            }
        if "indexedResources" in d:
            kwargs["indexed_resources"] = {
                t["name"]: str(t.get("resolution", "1")) for t in d["indexedResources"]
            }
        if "indexedTaints" in d:
            kwargs["indexed_taints"] = tuple(d["indexedTaints"])
        if "indexedNodeLabels" in d:
            kwargs["indexed_node_labels"] = tuple(d["indexedNodeLabels"])
        if "protectedFractionOfFairShare" in d:
            kwargs["protected_fraction_of_fair_share"] = float(
                d["protectedFractionOfFairShare"]
            )
        if "maxQueueLookback" in d:
            kwargs["max_queue_lookback"] = int(d["maxQueueLookback"])
        if "maximumResourceFractionToSchedule" in d:
            kwargs["maximum_resource_fraction_to_schedule"] = dict(
                d["maximumResourceFractionToSchedule"]
            )
        if "maxRetries" in d:
            kwargs["max_retries"] = int(d["maxRetries"])
        if "nodeIdLabel" in d:
            kwargs["node_id_label"] = d["nodeIdLabel"]
        if "gangsToPrice" in d:
            from .types import Toleration

            kwargs["gangs_to_price"] = {
                name: GangDefinition(
                    size=int(g.get("size", 1)),
                    priority_class=g.get("priorityClassName", ""),
                    resources=dict(g.get("resources", {})),
                    node_uniformity=g.get("nodeUniformity", ""),
                    node_selector=dict(g.get("nodeSelector", {})),
                    tolerations=tuple(
                        Toleration(
                            key=t.get("key", ""),
                            operator=t.get("operator", "Equal"),
                            value=t.get("value", ""),
                            effect=t.get("effect", ""),
                        )
                        for t in g.get("tolerations", [])
                    ),
                )
                for name, g in d["gangsToPrice"].items()
            }
        for yaml_key, attr, conv in [
            ("enableAssertions", "enable_assertions", bool),
            ("storeCapacityBytes", "store_capacity_bytes", int),
            (
                "storeFractionOfCapacityLimit",
                "store_fraction_of_capacity_limit",
                float,
            ),
            ("maxIngestLagEvents", "max_ingest_lag_events", int),
            ("marketDriven", "market_driven", bool),
            ("gangIndicativePricingTimeout", "gang_pricing_timeout_s", float),
            ("spotPriceCutoff", "spot_price_cutoff", float),
            ("shortJobPenaltySeconds", "short_job_penalty_s", float),
            ("executorTimeout", "executor_timeout_s", float),
            ("whatifWorkers", "whatif_workers", int),
            ("whatifQueueDepth", "whatif_queue_depth", int),
            ("whatifDefaultRounds", "whatif_default_rounds", int),
            ("drainDeadlineSeconds", "drain_deadline_s", float),
            ("fairnessStarvationRounds", "fairness_starvation_rounds", int),
            ("executorLeaseTTL", "executor_lease_ttl_s", float),
            ("maxSchedulingDuration", "max_scheduling_duration_s", float),
            (
                "truncatedRoundsBackpressure",
                "truncated_rounds_backpressure",
                int,
            ),
            ("solverRoundValidation", "solver_validate", bool),
            ("solverFailover", "solver_failover", bool),
            ("solverFailoverThreshold", "solver_failover_threshold", int),
            (
                "solverFailoverCooldown",
                "solver_failover_cooldown_rounds",
                int,
            ),
            ("quarantineDir", "quarantine_dir", str),
            (
                "residentDriftCheckEvery",
                "resident_drift_check_every",
                int,
            ),
            (
                "maxUnacknowledgedJobsPerExecutor",
                "max_unacknowledged_jobs_per_executor",
                int,
            ),
            ("enablePreferLargeJobOrdering", "enable_prefer_large_job_ordering", bool),
            ("batchFillWindow", "batch_fill_window", int),
            ("hotWindowSlots", "hot_window_slots", int),
            ("hotWindowMinSlots", "hot_window_min_slots", int),
            ("autotuneEnabled", "autotune_enabled", bool),
            ("autotuneProfile", "autotune_profile", str),
            ("autotuneHysteresisRounds", "autotune_hysteresis_rounds", int),
            ("autotuneMinWindowSlots", "autotune_min_window_slots", int),
            ("autotuneMaxWindowSlots", "autotune_max_window_slots", int),
            ("enableFastFill", "enable_fast_fill", bool),
            ("solveKernelPath", "solve_kernel_path", str),
            ("fillGroupMax", "fill_group_max", int),
            ("frontdoorShards", "frontdoor_shards", int),
            ("frontdoorTenantRate", "frontdoor_tenant_rate", float),
            ("frontdoorTenantBurst", "frontdoor_tenant_burst", float),
            ("frontdoorGlobalRate", "frontdoor_global_rate", float),
            ("frontdoorGlobalBurst", "frontdoor_global_burst", float),
            ("frontdoorOverloadRate", "frontdoor_overload_rate", float),
        ]:
            if yaml_key in d:
                kwargs[attr] = conv(d[yaml_key])
        rl = {}
        for yaml_key, attr in [
            ("maximumSchedulingRate", "maximum_scheduling_rate"),
            ("maximumSchedulingBurst", "maximum_scheduling_burst"),
            ("maximumPerQueueSchedulingRate", "maximum_per_queue_scheduling_rate"),
            ("maximumPerQueueSchedulingBurst", "maximum_per_queue_scheduling_burst"),
        ]:
            if yaml_key in d:
                rl[attr] = d[yaml_key]
        if rl:
            kwargs["rate_limits"] = RateLimits(**rl)
        return SchedulingConfig(**kwargs)


def _set_path(d: dict, path: list[str], value):
    cur = d
    for key in path[:-1]:
        cur = cur.setdefault(key, {})
    cur[path[-1]] = value


def _coerce(raw: str):
    """Env values arrive as strings; YAML-parse them for typed overrides."""
    try:
        import yaml

        return yaml.safe_load(raw)
    except Exception:
        return raw


def load_config(path: str | None = None, env: dict | None = None) -> SchedulingConfig:
    """Load a scheduling config from YAML with env-var overrides and
    validation — the viper+pflag pattern of the reference
    (internal/common/config/, cmd/fakeexecutor/main.go:22-47).

    Env keys: ARMADA__<Path__To__Key>=value, double-underscore-separated
    reference key names, YAML-typed values, applied over the file, e.g.
    ARMADA__maxQueueLookback=5000 or
    ARMADA__protectedFractionOfFairShare=0.5.
    """
    import os

    doc: dict = {}
    if path:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        doc = loaded.get("scheduling", loaded)
    env = os.environ if env is None else env
    for key, raw in env.items():
        if not key.startswith("ARMADA__"):
            continue
        parts = key[len("ARMADA__"):].split("__")
        _set_path(doc, parts, _coerce(raw))
    config = SchedulingConfig.from_dict(doc)
    validate_config(config)
    return config


def validate_config(config: SchedulingConfig):
    """Semantic validation (the reference uses go-playground/validator on
    its config struct; these mirror the constraints that matter here)."""
    problems = []
    if config.default_priority_class not in config.priority_classes:
        problems.append(
            f"defaultPriorityClass {config.default_priority_class!r} "
            "is not a configured priority class"
        )
    if not (0.0 <= config.protected_fraction_of_fair_share <= 1e9):
        problems.append("protectedFractionOfFairShare must be >= 0")
    if config.max_queue_lookback < 0:
        problems.append("maxQueueLookback must be >= 0")
    if config.batch_fill_window < 0:
        problems.append("batchFillWindow must be >= 0")
    if config.hot_window_slots < 0:
        problems.append("hotWindowSlots must be >= 0")
    if config.hot_window_min_slots < 0:
        problems.append("hotWindowMinSlots must be >= 0")
    if config.solve_kernel_path not in ("lax", "cuda"):
        problems.append("solveKernelPath must be one of lax|cuda")
    if config.hot_window_slots > 0 and config.hot_window_min_slots > 0:
        # Compaction engages only when the padded slot axis S clears
        # BOTH hotWindowMinSlots and 2*Q*Ws (the window must actually
        # shrink the round; solver/kernel._window_precheck). Ws is the
        # configured window clamped up to the kernel's head lookahead
        # (the fill window in batched modes) and rounded to a power of
        # two, so if even a single-queue round at the floor cannot
        # engage (2*Ws >= floor) the floor is unreachable and every
        # round in [floor, 2*Q*Ws) silently runs uncompacted — the
        # window the operator configured is dead exactly where they
        # told it to start working.
        ws_base = max(int(config.hot_window_slots), config.window_lookahead())
        ws_pow2 = 1 << max(0, (ws_base - 1).bit_length())
        if 2 * ws_pow2 >= config.hot_window_min_slots:
            import warnings

            warnings.warn(
                f"hotWindowSlots={config.hot_window_slots} cannot engage at "
                f"the hotWindowMinSlots={config.hot_window_min_slots} "
                "engagement floor: compaction needs the slot axis above "
                f"2 x queues x {ws_pow2} (the pow2-bucketed window), so "
                "rounds at the floor always run uncompacted. Raise "
                "hotWindowMinSlots above 2x the window or shrink "
                "hotWindowSlots.",
                stacklevel=2,
            )
    if config.autotune_hysteresis_rounds < 1:
        problems.append("autotuneHysteresisRounds must be >= 1")
    if config.autotune_min_window_slots < 1:
        problems.append("autotuneMinWindowSlots must be >= 1")
    if config.autotune_max_window_slots < config.autotune_min_window_slots:
        problems.append(
            "autotuneMaxWindowSlots must be >= autotuneMinWindowSlots"
        )
    if config.fill_group_max < 1:
        problems.append("fillGroupMax must be >= 1")
    if config.max_scheduling_duration_s < 0:
        problems.append("maxSchedulingDuration must be >= 0")
    if config.frontdoor_shards < 0:
        problems.append("frontdoorShards must be >= 0")
    if config.frontdoor_shards > 0:
        for knob in (
            "frontdoor_tenant_rate",
            "frontdoor_tenant_burst",
            "frontdoor_global_rate",
            "frontdoor_global_burst",
            "frontdoor_overload_rate",
        ):
            if getattr(config, knob) <= 0:
                problems.append(f"{knob} must be > 0 when the front door "
                                "is enabled")
    if config.executor_lease_ttl_s < 0:
        problems.append("executorLeaseTTL must be >= 0")
    seen_slos = set()
    for slo in config.slos:
        if not slo.name or slo.name in seen_slos:
            problems.append(f"slos: missing or duplicate name {slo.name!r}")
        seen_slos.add(slo.name)
        if slo.threshold_s <= 0:
            problems.append(f"slo {slo.name!r}: thresholdSeconds must be > 0")
        if not (0.0 < slo.objective < 1.0):
            problems.append(
                f"slo {slo.name!r}: objective must be in (0, 1) — an "
                "objective of 1.0 leaves no error budget to burn"
            )
        if slo.fast_burn_window_s <= 0 or slo.slow_burn_window_s <= 0:
            problems.append(f"slo {slo.name!r}: burn windows must be > 0")
        if slo.fast_burn_window_s > slo.slow_burn_window_s:
            problems.append(
                f"slo {slo.name!r}: fast burn window must not exceed the "
                "slow one"
            )
    if config.truncated_rounds_backpressure < 1:
        problems.append("truncatedRoundsBackpressure must be >= 1")
    if config.solver_failover_threshold < 1:
        problems.append("solverFailoverThreshold must be >= 1")
    if config.solver_failover_cooldown_rounds < 1:
        problems.append("solverFailoverCooldown must be >= 1")
    for name, frac in config.maximum_resource_fraction_to_schedule.items():
        if frac < 0:
            problems.append(f"maximumResourceFractionToSchedule[{name}] < 0")
    known = {t.name for t in config.supported_resource_types}
    for name in config.dominant_resource_fairness_resources:
        if name not in known:
            problems.append(f"DRF resource {name!r} is not a supported type")
    # Pluggable fairness policies: reject unknown kinds up front (a typo
    # must not silently schedule a pool under the wrong objective), and
    # pin market-driven configs to DRF — bid price owns candidate order
    # there, so any other policy's ranking would never take effect.
    from ..solver import policy as fairness_policy_mod

    policy_entries = [("fairnessPolicy.default", config.fairness_policy_default)]
    policy_entries += [
        (f"fairnessPolicy.pools[{pool}]", kind)
        for pool, kind in sorted((config.fairness_policy_pools or {}).items())
    ]
    for where, kind in policy_entries:
        try:
            spec = fairness_policy_mod.normalize_spec(kind)
        except ValueError as e:
            problems.append(f"{where}: {e}")
            continue
        if config.market_driven and spec[0] != "drf":
            problems.append(
                f"{where}: market-driven scheduling requires the drf "
                f"policy, got {spec[0]!r}"
            )
    if config.fairness_deadline_boost < 0:
        problems.append("fairnessPolicy.deadlineBoost must be >= 0")
    if config.fairness_deadline_horizon_s <= 0:
        problems.append("fairnessPolicy.deadlineHorizonSeconds must be > 0")
    if problems:
        raise ValueError("invalid scheduling config: " + "; ".join(problems))
