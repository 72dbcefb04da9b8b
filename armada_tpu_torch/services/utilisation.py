"""Cluster/pod utilisation reporting.

Mirrors internal/executor/utilisation/
{cluster_utilisation,pod_utilisation,job_utilisation_reporter}.go: the
executor samples per-pod usage, aggregates per node, and computes the
allocatable capacity the scheduler should see — total node resources
minus what NON-framework pods consume (the reference subtracts resources
of pods Armada doesn't manage so it never over-schedules nodes shared
with other workloads).

The agent attaches these reports to its heartbeat nodes:
  - "usage": observed per-node usage (metrics/observability),
  - "unallocatable_by_priority": the non-framework slice, keyed at a
    priority above every scheduling row so every allocatable row excludes
    it (snapshot/round.py applies rows `priorities <= key`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# A priority above every real priority class: the non-framework slice is
# unavailable at EVERY priority row.
ALL_PRIORITIES = 2**31 - 1


@dataclass
class PodUsage:
    run_id: str
    node_id: str
    usage: dict  # {resource: quantity}


@dataclass
class UtilisationReporter:
    """Per-run usage sampling (job_utilisation_reporter.go): a usage
    callback (defaults to "pods use what they request") feeds max/sum
    aggregates that the agent reports alongside lifecycle events."""

    usage_fn: object = None  # (pod record) -> {resource: qty}
    _samples: dict = field(default_factory=dict)  # run_id -> usage dict

    def sample(self, pods: dict[str, dict]):
        for run_id, pod in pods.items():
            if pod.get("phase") != "running":
                continue
            if self.usage_fn is not None:
                usage = self.usage_fn(pod)
            else:
                usage = dict(pod.get("spec", {}).get("requests", {}))
            self._samples[run_id] = {"usage": usage, "node": pod.get("node", "")}
        for run_id in list(self._samples):
            if run_id not in pods:
                del self._samples[run_id]

    def by_node(self) -> dict[str, dict]:
        """Aggregate sampled usage per node (cluster_utilisation.go)."""
        out: dict[str, dict] = {}
        for sample in self._samples.values():
            node = sample["node"]
            bucket = out.setdefault(node, {})
            for name, qty in sample["usage"].items():
                bucket[name] = _add_qty(bucket.get(name), qty)
        return out

    def run_usage(self, run_id: str) -> dict:
        return dict(self._samples.get(run_id, {}).get("usage", {}))


def _add_qty(a, b):
    """Add two Kubernetes quantities (host-side, exact)."""
    from ..core.resources import parse_quantity

    if a is None:
        return b
    return str(parse_quantity(a) + parse_quantity(b))


def node_reports(
    nodes: list[dict],
    framework_usage_by_node: dict[str, dict],
    non_framework_usage_by_node: dict[str, dict] | None = None,
) -> list[dict]:
    """Decorate heartbeat node dicts with utilisation
    (cluster_utilisation.go getAllocatableResourceByNodeType): usage =
    framework + foreign pods; allocatable excludes the foreign slice at
    every priority."""
    non_framework = non_framework_usage_by_node or {}
    out = []
    for node in nodes:
        node = dict(node)
        nid = node["id"]
        usage: dict = {}
        for bucket in (
            framework_usage_by_node.get(nid, {}),
            non_framework.get(nid, {}),
        ):
            for name, qty in bucket.items():
                usage[name] = _add_qty(usage.get(name), qty)
        if usage:
            node["usage"] = usage
        foreign = non_framework.get(nid)
        if foreign:
            unalloc = dict(node.get("unallocatable_by_priority", {}))
            unalloc[ALL_PRIORITIES] = foreign
            node["unallocatable_by_priority"] = unalloc
        out.append(node)
    return out
