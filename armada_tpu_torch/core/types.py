"""Host-side domain objects: jobs, nodes, queues, taints/tolerations.

These are the API-level records that flow in from submissions and executor
snapshots; the snapshot package flattens batches of them into dense tensors.
They mirror the information content of the reference's jobdb.Job
(internal/scheduler/jobdb/job.go:23), internaltypes.Node
(internaltypes/node.go:26) and the queue API type, without the Go-specific
immutability machinery (columnar stores handle that here).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

def _clean_price(x) -> float:
    try:
        v = float(x)
    except (TypeError, ValueError):
        return 0.0
    return v if math.isfinite(v) else 0.0


NO_SCHEDULE = "NoSchedule"
NO_EXECUTE = "NoExecute"
PREFER_NO_SCHEDULE = "PreferNoSchedule"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE

    @property
    def blocks_scheduling(self) -> bool:
        # PreferNoSchedule never blocks placement (soft preference).
        return self.effect in (NO_SCHEDULE, NO_EXECUTE)


@dataclass(frozen=True)
class ServiceConfig:
    """A service exposed for the job's pod (pkg/api job.Services;
    executor/job/submit.go creates the k8s Service owned by the pod).
    type: NodePort | Headless (the reference's ServiceType values)."""

    type: str = "NodePort"
    ports: tuple = ()  # of int

    @staticmethod
    def from_obj(s: dict) -> "ServiceConfig":
        """Canonical decode shared by every wire codec (JSON dict, event
        log, proto json_format, CLI YAML): int ports, so equal jobs
        decode identically across encodings."""
        return ServiceConfig(
            type=s.get("type", "NodePort"),
            ports=tuple(int(p) for p in s.get("ports") or ()),
        )


@dataclass(frozen=True)
class IngressConfig:
    """An ingress for the job's pod (pkg/api job.Ingress; created by the
    executor alongside the pod and garbage-collected with it)."""

    ports: tuple = ()  # of int
    annotations: tuple = ()  # of (key, value) pairs (hashable)
    tls_enabled: bool = False

    @staticmethod
    def from_obj(i: dict) -> "IngressConfig":
        """Canonical decode (see ServiceConfig.from_obj): annotations
        arrive as pairs or a map; stored sorted either way."""
        ann = i.get("annotations") or ()
        pairs = ann.items() if isinstance(ann, dict) else (
            tuple(kv) for kv in ann
        )
        return IngressConfig(
            ports=tuple(int(p) for p in i.get("ports") or ()),
            annotations=tuple(sorted(pairs)),
            tls_enabled=bool(i.get("tls_enabled", False)),
        )


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # "Equal" | "Exists"
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: Taint) -> bool:
        """Kubernetes toleration semantics (core/v1 Toleration.ToleratesTaint)."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key == "":
            # Empty key with Exists tolerates everything.
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass(frozen=True)
class MatchExpression:
    """One node-affinity requirement (core/v1 NodeSelectorRequirement)."""

    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: tuple = ()

    def matches(self, node_labels: dict) -> bool:
        value = node_labels.get(self.key)
        if self.operator == "In":
            return value is not None and str(value) in self.values
        if self.operator == "NotIn":
            # k8s labels.Requirement: NotIn matches when the key is absent.
            return value is None or str(value) not in self.values
        if self.operator == "Exists":
            return value is not None
        if self.operator == "DoesNotExist":
            return value is None
        if self.operator == "Gt":
            try:
                return value is not None and int(value) > int(self.values[0])
            except (ValueError, IndexError):
                return False
        if self.operator == "Lt":
            try:
                return value is not None and int(value) < int(self.values[0])
            except (ValueError, IndexError):
                return False
        # Unknown operators match nothing (submission validates upstream;
        # the scheduler must not crash on one malformed job).
        return False


@dataclass(frozen=True)
class NodeSelectorTerm:
    """AND of match expressions (one term of a NodeSelector)."""

    expressions: tuple = ()  # tuple[MatchExpression, ...]

    def matches(self, node_labels: dict) -> bool:
        # k8s MatchNodeSelectorTerms: a nil/empty term matches no objects.
        if not self.expressions:
            return False
        return all(e.matches(node_labels) for e in self.expressions)


@dataclass(frozen=True)
class Affinity:
    """requiredDuringSchedulingIgnoredDuringExecution node affinity:
    OR over terms (core/v1 NodeSelector; MatchNodeSelectorTerms in the
    reference, nodematching.go:242-255)."""

    terms: tuple = ()  # tuple[NodeSelectorTerm, ...]

    def matches(self, node_labels: dict) -> bool:
        if not self.terms:
            return True
        return any(t.matches(node_labels) for t in self.terms)


@dataclass(frozen=True)
class Gang:
    """Gang (all-or-nothing) membership, from job annotations in the
    reference (gangId/gangCardinality/gangNodeUniformityLabel)."""

    id: str
    cardinality: int
    node_uniformity_label: str = ""


@dataclass(frozen=True)
class JobSpec:
    """A schedulable job. requests: {resource: quantity}."""

    id: str
    queue: str
    jobset: str = ""
    # Pools this job may be scheduled in (job.Pools() in the reference);
    # empty = eligible for every pool. A pool's round only considers
    # queued jobs eligible for it (getQueuedJobs, scheduling_algo.go:533).
    pools: tuple = ()
    priority: int = 0  # within-queue ordering: lower schedules first
    priority_class: str = ""
    requests: dict = field(default_factory=dict)
    node_selector: dict = field(default_factory=dict)  # label -> required value
    tolerations: tuple[Toleration, ...] = ()
    affinity: Affinity | None = None
    gang: Gang | None = None
    submitted_ts: float = 0.0
    annotations: dict = field(default_factory=dict)
    # Market mode: bid price per pool (pkg/bidstore; job.GetBidPrice).
    bid_prices: dict = field(default_factory=dict)
    # Container command argv (podspec containers[0].command+args in the
    # reference). Empty = simulated runtime; a subprocess-backed executor
    # runs it as a real OS process.
    command: tuple = ()
    # Services/ingresses the executor creates alongside the pod
    # (pkg/api submit job.Services/job.Ingress; executor/job/submit.go).
    services: tuple = ()  # of ServiceConfig
    ingresses: tuple = ()  # of IngressConfig

    def bid_price(self, pool: str, *, running: bool = False) -> float:
        """Bid for this pool's given phase (see bid_price_pair)."""
        pair = self.bid_price_pair(pool)
        return pair[1] if running else pair[0]

    def bid_price_pair(self, pool: str) -> tuple[float, float]:
        """(queued, running) bids for this pool in one key lookup — the
        snapshot builder needs both phases per job (post-round pricing
        reads running-phase bids for just-leased jobs). Malformed or
        non-finite user-supplied values count as 0 (one bad annotation
        must not abort scheduling rounds or poison price ordering).
        Values may be scalars or (queued, running) phase pairs as written
        by the bid-price provider (pricing.Bid / jobdb job.getBidPrice
        phase selection)."""
        for key in (pool, ""):
            if key in self.bid_prices:
                v = self.bid_prices[key]
                if isinstance(v, (tuple, list)) and len(v) == 2:
                    return _clean_price(v[0]), _clean_price(v[1])
                p = _clean_price(v)
                return p, p
        p = _clean_price(self.annotations.get("armadaproject.io/bidPrice", 0.0))
        return p, p

    def with_(self, **kw) -> "JobSpec":
        return replace(self, **kw)


@dataclass(frozen=True)
class NodeSpec:
    """A worker node as reported by an executor."""

    id: str
    name: str = ""
    executor: str = ""
    pool: str = "default"
    taints: tuple[Taint, ...] = ()
    labels: dict = field(default_factory=dict)
    total_resources: dict = field(default_factory=dict)
    # Resources already used by pods outside the scheduler's control,
    # per priority level: {priority: {resource: qty}}.
    unallocatable_by_priority: dict = field(default_factory=dict)
    unschedulable: bool = False

    def label_value(self, key: str):
        return self.labels.get(key)


@dataclass(frozen=True)
class QueueSpec:
    name: str
    priority_factor: float = 1.0

    @property
    def weight(self) -> float:
        # weight = 1 / priorityFactor, as in the reference scheduling context
        # construction (scheduling_algo.go:411+).
        return 1.0 / max(self.priority_factor, 1e-9)


@dataclass(frozen=True)
class RunningJob:
    """A job currently bound to a node (input to round snapshots)."""

    job: JobSpec
    node_id: str
    scheduled_at_priority: int
    # When the active run was leased (market anti-churn ordering:
    # longer-running jobs reschedule first, comparison.go:148-153).
    leased_ts: float = 0.0
    # Cross-pool away job: its run belongs to a pool that borrows nodes
    # from the round's pool (run.pool in awayAllocationPools,
    # scheduling_algo.go:421-426,658-666). It accounts under the phantom
    # "<queue>-away" fairness bucket (context/util.go CalculateAwayQueueName)
    # and is an eviction candidate only when bound to one of this round's
    # nodes; unbound away jobs contribute allocation pressure only.
    away: bool = False
