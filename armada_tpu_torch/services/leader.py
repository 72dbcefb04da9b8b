"""Leader election: the standalone mode.

The reference supports `standalone` (always leader) and `kubernetes`
(coordination.k8s.io Lease) modes, with a LeaderToken whose validity gates
publishing (internal/leaderelection/leaderelection.go:16-63).
Kubernetes is out of scope. A cycle captures a token at its start, and
publishes only validate against that token — losing leadership mid-cycle
invalidates the token so the next leader re-derives events idempotently
(scheduler.go:225-233). The JAX package's file-lease mode (multi-process
HA on a shared filesystem) waits for persistence (ROADMAP A1).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass


@dataclass(frozen=True)
class LeaderToken:
    leader: bool
    id: str = ""


class StandaloneLeader:
    """Always the leader (leader.mode=standalone)."""

    def __init__(self):
        self._id = str(uuid.uuid4())

    def get_token(self) -> LeaderToken:
        return LeaderToken(leader=True, id=self._id)

    def validate(self, token: LeaderToken) -> bool:
        return token.leader and token.id == self._id

    def __call__(self) -> bool:  # is_leader interface for SchedulerService
        return True

    def is_holder(self) -> bool:
        """Side-effect-free leadership check (no acquisition attempt)."""
        return True

    def leader_address(self) -> str:
        """Advertised address of the current leader ("" = unknown/self)."""
        return ""
