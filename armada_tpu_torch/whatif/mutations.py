"""Composable hypothetical edits applied to a forked round state.

Each mutation is a small dataclass with `apply(state: ForkState)`; a
plan applies them in order, then re-solves. The wire shape (gRPC both
encodings, `armadactl whatif` flags, `GET /api/whatif` params) is a
list of dicts: `{"kind": "...", ...}` — `mutation_from_dict` is the
single decoder, so every surface accepts the same vocabulary:

  cordon_node / uncordon_node   {"name": node_id}
  remove_node                   {"name": node_id}
  add_nodes                     {"count": n, "cpu": "8", "memory": ...,
                                 "gpu": ..., "name": prefix,
                                 "executor": ..., "requests": {...}}
  drain_executor                {"name": executor}  (cordon + staged
                                 preempt-requeue inside the rollout —
                                 the same DrainController execution
                                 runs, whatif/drain.py)
  cordon_executor               {"name": executor}
  inject_gang / inject_jobs     {"queue": q, "count": n,
                                 "gang_cardinality": c, "cpu": ...,
                                 "memory": ..., "gpu": ...,
                                 "priority_class": ..., "requests": {...}}
  scale_queue                   {"name": q, "weight": w} or
                                {"name": q, "priority_factor": pf}
  policy                        {"policy": "proportional"} — flip the
                                forked pool's fairness policy
                                (solver/policy.py) and re-solve; the
                                plan's fairness_delta names the payers

Injected jobs are normalized through the SAME snapshot-build helper the
SubmitChecker uses (`services/submit_check.static_check`), so checker
and planner feasibility semantics cannot drift.

This is the port's copy of the JAX package's whatif/mutations.py: the
same vocabulary, applied to the same ForkState, gives the same state.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field, replace as dc_replace

from ..core.types import Gang, JobSpec, NodeSpec, QueueSpec
from .fork import ForkState

_inject_counter = itertools.count()


class Mutation:
    """Base class; subclasses implement apply(state)."""

    kind = ""

    def apply(self, state: ForkState) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        d.update(dataclasses.asdict(self))
        if d.get("uncordon"):
            # Round-trip the uncordon variants to their own kind so
            # to_dict() output feeds back through mutation_from_dict.
            d["kind"] = "un" + d["kind"]
        return d


def _requests_from(d: dict) -> dict:
    """Resource requests from either a full `requests` dict or the
    cpu/memory/gpu convenience scalars (the proto wire's shape)."""
    req = dict(d.get("requests") or {})
    if not req:
        if d.get("cpu"):
            req["cpu"] = str(d["cpu"])
        if d.get("memory"):
            req["memory"] = str(d["memory"])
        if d.get("gpu") and str(d.get("gpu")) not in ("0", ""):
            req["nvidia.com/gpu"] = str(d["gpu"])
    return req


@dataclass
class CordonNode(Mutation):
    kind = "cordon_node"
    name: str = ""
    uncordon: bool = False

    def apply(self, state: ForkState) -> None:
        found = False
        for i, node in enumerate(state.nodes):
            if node.id == self.name:
                state.nodes[i] = dc_replace(
                    node, unschedulable=not self.uncordon
                )
                found = True
        if not found:
            raise KeyError(f"node {self.name!r} not in the fork")


@dataclass
class RemoveNode(Mutation):
    kind = "remove_node"
    name: str = ""

    def apply(self, state: ForkState) -> None:
        before = len(state.nodes)
        state.nodes = [n for n in state.nodes if n.id != self.name]
        if len(state.nodes) == before:
            raise KeyError(f"node {self.name!r} not in the fork")
        state.node_executor.pop(self.name, None)
        # Jobs running on the removed node are displaced immediately:
        # they reappear queued (the reconciliation path would requeue
        # gang jobs; the hypothetical models the optimistic recovery).
        displaced = [r for r in state.running if r.node_id == self.name]
        state.running = [r for r in state.running if r.node_id != self.name]
        state.queued = [r.job for r in displaced] + state.queued


@dataclass
class AddNodes(Mutation):
    kind = "add_nodes"
    count: int = 1
    name: str = "whatif-node"
    executor: str = ""
    cpu: str = ""
    memory: str = ""
    gpu: str = ""
    requests: dict = field(default_factory=dict)
    labels: dict = field(default_factory=dict)

    def apply(self, state: ForkState) -> None:
        resources = _requests_from(
            {"requests": self.requests, "cpu": self.cpu or "8",
             "memory": self.memory or "128Gi", "gpu": self.gpu}
        )
        executor = self.executor or f"{self.name}-exec"
        for i in range(int(self.count)):
            nid = f"{self.name}-{i:05d}"
            state.nodes.append(
                NodeSpec(
                    id=nid,
                    name=nid,
                    executor=executor,
                    pool=state.pool,
                    labels=dict(self.labels),
                    total_resources=dict(resources),
                )
            )
            state.node_executor[nid] = executor


@dataclass
class CordonExecutor(Mutation):
    kind = "cordon_executor"
    name: str = ""
    uncordon: bool = False

    def apply(self, state: ForkState) -> None:
        if self.uncordon:
            state.cordoned_executors.discard(self.name)
        else:
            state.cordoned_executors.add(self.name)


@dataclass
class DrainExecutor(Mutation):
    """Drain = cordon now + staged preempt-requeue at the deadline,
    executed INSIDE the rollout by the same DrainController the live
    control plane runs (whatif/drain.py) — dry-run and execution share
    one code path by construction."""

    kind = "drain_executor"
    name: str = ""
    deadline_s: float | None = None

    def apply(self, state: ForkState) -> None:
        if self.name not in set(state.node_executor.values()) | {
            n.executor for n in state.nodes
        }:
            raise KeyError(f"executor {self.name!r} not in the fork")
        state.drain_executors.append((self.name, self.deadline_s))


@dataclass
class InjectGang(Mutation):
    kind = "inject_gang"
    queue: str = ""
    count: int = 1
    gang_cardinality: int = 0
    cpu: str = ""
    memory: str = ""
    gpu: str = ""
    priority_class: str = ""
    requests: dict = field(default_factory=dict)
    node_selector: dict = field(default_factory=dict)

    def apply(self, state: ForkState) -> None:
        if not self.queue:
            raise ValueError("inject_gang needs a queue")
        requests = _requests_from(
            {"requests": self.requests, "cpu": self.cpu or "1",
             "memory": self.memory or "1Gi", "gpu": self.gpu}
        )
        if not any(q.name == self.queue for q in state.queues):
            state.queues.append(QueueSpec(self.queue))
        serial = next(_inject_counter)
        card = int(self.gang_cardinality)
        gang = None
        if card > 0:
            gang_id = f"whatif-gang-{serial}"
            gang = Gang(id=gang_id, cardinality=card)
            state.injected_gangs.append((gang_id, self.queue, card))
        n = int(self.count) if card <= 0 else card
        # Hypothetical jobs sort AFTER every real queued job (newest
        # submission): submitted_ts past any live stamp.
        last_ts = max(
            [j.submitted_ts for j in state.queued]
            + [r.job.submitted_ts for r in state.running]
            + [0.0]
        )
        for i in range(n):
            jid = f"whatif-{serial}-{i:04d}"
            state.queued.append(
                JobSpec(
                    id=jid,
                    queue=self.queue,
                    jobset=f"whatif-{serial}",
                    priority_class=self.priority_class,
                    requests=dict(requests),
                    node_selector=dict(self.node_selector),
                    gang=gang,
                    submitted_ts=last_ts + 1.0 + serial,
                )
            )
            state.injected_job_ids.append(jid)


@dataclass
class ScaleQueue(Mutation):
    kind = "scale_queue"
    name: str = ""
    weight: float | None = None
    priority_factor: float | None = None

    def apply(self, state: ForkState) -> None:
        pf = self.priority_factor
        if pf is None:
            if self.weight is None or self.weight <= 0:
                raise ValueError("scale_queue needs weight or priority_factor")
            pf = 1.0 / float(self.weight)
        found = False
        for i, q in enumerate(state.queues):
            if q.name == self.name:
                state.queues[i] = QueueSpec(q.name, float(pf))
                found = True
        if not found:
            state.queues.append(QueueSpec(self.name, float(pf)))


@dataclass
class SetPolicy(Mutation):
    """Hypothetical fairness-policy flip for the forked pool: the
    rollout re-solves under the candidate objective (solver/policy.py),
    and the plan's fairness_delta names which queues pay for the flip.
    The live analogue is SchedulerService.set_fairness_policy."""

    kind = "policy"
    policy: str = ""

    def apply(self, state: ForkState) -> None:
        from ..solver import policy as fp

        spec = fp.normalize_spec(self.policy)  # ValueError on unknown
        if getattr(state.config, "market_driven", False) and (
            fp.spec_kind(spec) != "drf"
        ):
            raise ValueError(
                "market-driven pools price off the DRF dominant share; "
                f"cannot simulate policy {self.policy!r}"
            )
        pools = dict(getattr(state.config, "fairness_policy_pools", {}) or {})
        pools[state.pool] = fp.spec_to_str(spec)
        state.config = dc_replace(state.config, fairness_policy_pools=pools)


_KINDS = {
    "cordon_node": lambda d: CordonNode(name=d.get("name", d.get("node_id", ""))),
    "uncordon_node": lambda d: CordonNode(
        name=d.get("name", d.get("node_id", "")), uncordon=True
    ),
    "remove_node": lambda d: RemoveNode(name=d.get("name", d.get("node_id", ""))),
    "add_nodes": lambda d: AddNodes(
        count=int(d.get("count", 1) or 1),
        name=d.get("name") or "whatif-node",
        executor=d.get("executor", ""),
        cpu=str(d.get("cpu", "")),
        memory=str(d.get("memory", "")),
        gpu=str(d.get("gpu", "")),
        requests=dict(d.get("requests") or {}),
        labels=dict(d.get("labels") or {}),
    ),
    "cordon_executor": lambda d: CordonExecutor(name=d.get("name", "")),
    "uncordon_executor": lambda d: CordonExecutor(
        name=d.get("name", ""), uncordon=True
    ),
    "drain_executor": lambda d: DrainExecutor(
        name=d.get("name", d.get("executor", "")),
        deadline_s=(
            float(d["deadline_s"]) if d.get("deadline_s") is not None else None
        ),
    ),
    "inject_gang": lambda d: InjectGang(
        queue=d.get("queue", ""),
        count=int(d.get("count", 1) or 1),
        gang_cardinality=int(d.get("gang_cardinality", 0) or 0),
        cpu=str(d.get("cpu", "")),
        memory=str(d.get("memory", "")),
        gpu=str(d.get("gpu", "")),
        priority_class=d.get("priority_class", ""),
        requests=dict(d.get("requests") or {}),
        node_selector=dict(d.get("node_selector") or {}),
    ),
    "scale_queue": lambda d: ScaleQueue(
        name=d.get("name", d.get("queue", "")),
        weight=(float(d["weight"]) if d.get("weight") else None),
        priority_factor=(
            float(d["priority_factor"]) if d.get("priority_factor") else None
        ),
    ),
    "policy": lambda d: SetPolicy(
        policy=str(d.get("policy", d.get("name", "")))
    ),
}
_KINDS["inject_jobs"] = _KINDS["inject_gang"]


def mutation_from_dict(d: dict) -> Mutation:
    kind = d.get("kind", "")
    builder = _KINDS.get(kind)
    if builder is None:
        raise ValueError(
            f"unknown mutation kind {kind!r}; have {sorted(_KINDS)}"
        )
    return builder(d)


def mutations_from_dicts(items) -> list[Mutation]:
    return [mutation_from_dict(d) for d in items or ()]
