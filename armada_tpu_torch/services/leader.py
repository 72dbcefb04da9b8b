"""Leader election: standalone and file-lease modes.

The reference supports `standalone` (always leader) and `kubernetes`
(coordination.k8s.io Lease) modes, with a LeaderToken whose validity gates
publishing (internal/leaderelection/leaderelection.go:16-63).
Kubernetes is out of scope here; the file-lease mode gives multi-process
HA on a shared filesystem with the same token semantics: a cycle captures a
token at its start, and publishes only validate against that token — losing
leadership mid-cycle invalidates the token so the next leader re-derives
events idempotently (scheduler.go:225-233).

This is the port's copy of the JAX package's services/leader.py.
"""

from __future__ import annotations

import os
import time as _time
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


class FileLeaseLeader:
    """Lease file on shared storage: holder renews mtime; takeover after
    lease_duration of silence. Single-writer via atomic create/replace.

    Safety model: the lease file carries a monotonic **fencing counter**,
    incremented on every takeover. First acquisition uses O_EXCL so exactly
    one creator wins; takeover of an expired lease writes fence+1 and
    re-reads to confirm (if two candidates interleave, the later writer's
    file survives and the earlier one's re-read or validate() fails on the
    holder/fence mismatch). A validate-then-publish window remains — a
    candidate can take over after validate() returns and before the publish
    lands — which file storage cannot close without write-time fencing;
    that residual window is safe here because event application is
    idempotent and a deposed leader's events are re-derived identically by
    the new leader (scheduler.go:225-233 recovery semantics)."""

    def __init__(
        self,
        path: str,
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        identity: str | None = None,
        advertise: str = "",
    ):
        self.path = path
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4()}"
        # gRPC address peers can reach this instance at, written into the
        # lease so followers can proxy leader-only RPCs (the reference's
        # leader connection from the Lease holder identity,
        # scheduler reports proxying).
        self.advertise = advertise
        self._epoch = 0
        self._fence = 0

    def _read(self):
        """Returns (holder, ts, fence, address); holder None only when the
        file does not exist. A torn/corrupt file (killed mid-write, disk
        full) parses as holder="" with an expired ts, so candidates recover
        it through the fenced takeover path — O_EXCL creation would
        otherwise fail forever against a file that exists but never
        parses."""
        try:
            with open(self.path) as f:
                raw = f.read()
        except FileNotFoundError:
            return None, 0.0, 0, ""
        try:
            parts = raw.strip().split("\n")
            holder, ts = parts[0], float(parts[1])
            fence = int(parts[2]) if len(parts) > 2 else 0
            address = parts[3] if len(parts) > 3 else ""
            if not holder:
                raise ValueError("empty holder")
            return holder, ts, fence, address
        except (ValueError, IndexError):
            return "", 0.0, 0, ""

    def _write(self, now: float, fence: int):
        tmp = f"{self.path}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{self.identity}\n{now}\n{fence}\n{self.advertise}")
        os.replace(tmp, self.path)

    def try_acquire_or_renew(self, now: float | None = None) -> bool:
        now = _time.time() if now is None else now
        holder, ts, fence, _ = self._read()
        if holder == self.identity:
            self._write(now, fence)
            self._fence = fence
            return True
        if holder is None:
            # First acquisition: O_EXCL so exactly one creator wins.
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return False
            with os.fdopen(fd, "w") as f:
                f.write(f"{self.identity}\n{now}\n1\n{self.advertise}")
            self._fence = 1
            self._epoch += 1
            return True
        if now - ts > self.lease_duration:
            self._write(now, fence + 1)
            # Re-read to confirm we won the race.
            holder2, _, fence2, _ = self._read()
            won = holder2 == self.identity and fence2 == fence + 1
            if won:
                self._fence = fence + 1
                self._epoch += 1
            return won
        return False

    def get_token(self) -> LeaderToken:
        leader = self.try_acquire_or_renew()
        return LeaderToken(leader=leader, id=f"{self.identity}:{self._epoch}")

    def validate(self, token: LeaderToken) -> bool:
        if not token.leader:
            return False
        holder, ts, fence, _ = self._read()
        return (
            holder == self.identity
            and fence == self._fence
            and token.id == f"{self.identity}:{self._epoch}"
            and _time.time() - ts <= self.lease_duration
        )

    def __call__(self) -> bool:
        return self.try_acquire_or_renew()

    def is_holder(self) -> bool:
        """True iff this instance currently holds a fresh lease — read-only
        (no acquisition attempt), safe to call on RPC paths."""
        holder, ts, _, _ = self._read()
        return holder == self.identity and _time.time() - ts <= self.lease_duration

    def leader_address(self) -> str:
        """The holder's advertised gRPC address ("" when the lease is
        stale, torn, or the holder advertised nothing)."""
        holder, ts, _, address = self._read()
        if holder and _time.time() - ts <= self.lease_duration:
            return address
        return ""
