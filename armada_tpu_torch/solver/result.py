"""Result types for one scheduling round."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class RoundResult:
    """Outcome of one pool scheduling round over a RoundSnapshot's job table.

    Equivalent information to the reference's SchedulerResult
    (scheduled + preempted job lists); kept as dense masks over the
    snapshot's J jobs so oracle and kernel results diff directly.
    """

    # Node index each job is bound to after the round (NO_NODE if unbound).
    assigned_node: np.ndarray  # int32[J]
    # Priority the job is (re)scheduled at.
    scheduled_priority: np.ndarray  # int32[J]
    # Queued jobs newly scheduled this round.
    scheduled_mask: np.ndarray  # bool[J]
    # Running jobs preempted this round.
    preempted_mask: np.ndarray  # bool[J]
    # Fair-share vectors per queue.
    fair_share: np.ndarray  # float64[Q]
    demand_capped_fair_share: np.ndarray  # float64[Q]
    uncapped_fair_share: np.ndarray  # float64[Q]
    termination_reason: str = ""
    # Per-job unschedulable reason ("" if scheduled or not considered).
    unschedulable_reason: list = field(default_factory=list)
    num_loops: int = 0
    # Market mode: spot price set this round (None if not crossed/off).
    spot_price: float | None = None
    # Round-deadline guardrail: the scheduling budget expired before the
    # candidate stream was exhausted; the masks hold the partial placement
    # (a prefix of the full round's decisions).
    truncated: bool = False

    def placements(self, snap) -> dict:
        """{job_id: node_id} for jobs scheduled this round."""
        out = {}
        for j in np.flatnonzero(self.scheduled_mask):
            out[snap.job_ids[j]] = snap.node_ids[self.assigned_node[j]]
        return out

    def preemptions(self, snap) -> list:
        return [snap.job_ids[j] for j in np.flatnonzero(self.preempted_mask)]
