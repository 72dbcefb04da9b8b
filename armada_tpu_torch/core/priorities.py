"""Priority classes and the priority axis of the allocatable tensor.

Mirrors the semantics of the reference's PriorityClass config type
(internal/common/types/ and config/scheduler/config.yaml:89-100)
and the EvictedPriority convention (-1: the row of the allocatable tensor that
counts *everything* bound, including evicted jobs, so that a fit at
EvictedPriority means "schedulable without preempting anyone").
"""

from __future__ import annotations

from dataclasses import dataclass, field

EVICTED_PRIORITY: int = -1
MIN_PRIORITY: int = -(2**31)


@dataclass(frozen=True)
class AwayNodeType:
    """Fallback scheduling target: a well-known node type (named taint set)
    the job may run on at a reduced priority (types.AwayNodeType in the
    reference; nodedb.go:487-501)."""

    priority: int
    well_known_node_type: str


@dataclass(frozen=True)
class PriorityClass:
    name: str
    priority: int
    preemptible: bool = False
    # Per-queue resource-fraction caps for jobs of this class
    # (maximumResourceFractionPerQueue in the reference config).
    maximum_resource_fraction_per_queue: dict[str, float] = field(default_factory=dict)
    # Per-pool overrides of the above.
    maximum_resource_fraction_per_queue_by_pool: dict[str, dict[str, float]] = field(
        default_factory=dict
    )
    # Ordered fallback targets tried after home scheduling fails.
    away_node_types: tuple = ()  # tuple[AwayNodeType, ...]


def priority_levels(priority_classes: dict[str, PriorityClass]) -> list[int]:
    """Distinct scheduling priorities, ascending, prefixed by EvictedPriority.

    This is the P axis of the allocatable[P, N, R] tensor; mirrors
    nodeDbPriorities in the reference nodedb. Away priorities are scheduling
    priorities too, so they get rows.
    """
    levels = {pc.priority for pc in priority_classes.values()}
    for pc in priority_classes.values():
        for away in pc.away_node_types:
            if away.priority <= EVICTED_PRIORITY:
                raise ValueError(
                    f"away priority {away.priority} of class {pc.name!r} must "
                    f"be greater than the evicted priority {EVICTED_PRIORITY}"
                )
            levels.add(away.priority)
    return [EVICTED_PRIORITY] + sorted(levels)
