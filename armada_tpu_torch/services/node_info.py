"""Executor-side node classification: pools, node types, node groups.

Port of internal/executor/node/node_group.go: each node's
POOL comes from a configurable node label (falling back to the cluster's
pool), with a "-reserved" suffix appended when the node carries a
reservation taint (reservedNodePoolSuffix, node_group.go:91-93); its TYPE
comes from a node-type label, else from the sorted id of the configured
tolerated taints it carries (filterToleratedTaints + nodeGroupId — taints
the executor tolerates are exactly what distinguishes node groups), else
"none". GroupNodesByType buckets nodes for per-type utilisation reports.

Node dicts are the agent's heartbeat records: {"id", "labels": {...},
"taints": [{"key","value","effect"}, ...], ...}.

This is the port's copy of the JAX package's services/node_info.py.
"""

from __future__ import annotations

DEFAULT_NODE_TYPE = "none"
RESERVATION_TAINT_KEY = "armadaproject.io/reservation"


class NodeInfoService:
    def __init__(
        self,
        cluster_pool: str = "default",
        node_pool_label: str = "armadaproject.io/pool",
        node_type_label: str = "armadaproject.io/node-type",
        reserved_node_pool_suffix: str = "reserved",
        tolerated_taints: tuple = (),
    ):
        self.cluster_pool = cluster_pool
        self.node_pool_label = node_pool_label
        self.node_type_label = node_type_label
        self.reserved_node_pool_suffix = reserved_node_pool_suffix
        # The reservation taint is always tolerated (node_group.go:42-44).
        self.tolerated_taints = set(tolerated_taints) | {RESERVATION_TAINT_KEY}

    def get_pool(self, node: dict) -> str:
        pool = node.get("labels", {}).get(
            self.node_pool_label, self.cluster_pool
        )
        if self.reserved_node_pool_suffix and self._reservation(node):
            pool = f"{pool}-{self.reserved_node_pool_suffix}"
        return pool

    def _reservation(self, node: dict) -> str:
        for taint in node.get("taints", ()):
            if taint.get("key") == RESERVATION_TAINT_KEY and taint.get("value"):
                return taint["value"]
        return ""

    def get_type(self, node: dict) -> str:
        label = node.get("labels", {}).get(self.node_type_label)
        if label:
            return label
        relevant = sorted(
            t["key"]
            for t in node.get("taints", ())
            if t.get("key") in self.tolerated_taints
            and t.get("key") != RESERVATION_TAINT_KEY
        )
        return ",".join(relevant) if relevant else DEFAULT_NODE_TYPE

    def group_nodes_by_type(self, nodes: list[dict]) -> dict[str, list[dict]]:
        groups: dict[str, list[dict]] = {}
        for node in nodes:
            groups.setdefault(self.get_type(node), []).append(node)
        return groups

    def decorate(self, nodes: list[dict]) -> list[dict]:
        """Heartbeat enrichment: every node dict gains its derived pool and
        node type, so the scheduler sees per-node pools (a cluster can
        span pools, scheduling_algo.go union semantics) and reports can
        group by type."""
        out = []
        for node in nodes:
            node = dict(node)
            node.setdefault("pool", self.get_pool(node))
            node["node_type"] = self.get_type(node)
            out.append(node)
        return out
