"""Queue permission grants, as the queue registry stores them.

The JAX package's services/auth.py also holds the principals, the
authenticators and the Authorizer of the gRPC transport; those wait for
ROADMAP A1. The submit service needs only the grant record that
QueueUpsert events carry (pkg/client/queue Permissions).
"""

from __future__ import annotations

from dataclasses import dataclass

QUEUE_VERBS = ("submit", "cancel", "reprioritize", "watch")


@dataclass(frozen=True)
class QueuePermission:
    """One queue permission grant (pkg/client/queue Permissions)."""

    subjects: tuple = ()  # user or group names
    verbs: tuple = QUEUE_VERBS
