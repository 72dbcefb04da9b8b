"""Deterministic fault injection (chaos) for the control plane.

The reference tests failure behavior ad hoc (killed executors, Pulsar
outages, leader churn in integration environments); here fault injection is
a first-class, SEEDED artifact so failure behavior is reproducible and
assertable. A `FaultPlan` is a declarative schedule of faults on the same
clock its components run on (virtual time in the simulator, wall clock in
live agents); the same seed always yields the same plan, and every
injection decision is a pure function of (plan state, query), so two runs
of one seed produce identical histories — the property the chaos soak
(tools/chaos_soak.py) asserts.

Fault kinds:

  executor_crash   the executor loses all local pod state and stops
                   reporting for the window; on recovery it reports its
                   leased runs as lost (missing-pod reconciliation)
  executor_hang    the executor stops reporting but keeps state
  lease_slow       lease exchanges are delayed (`param` seconds; the
                   simulator models this by deferring lease pickup)
  lease_timeout    lease RPCs fail with a timeout
  torn_log_write   an event-log append "crashes" mid-record, leaving a
                   torn tail for recovery to truncate
  leader_flap      leadership is lost for the window

Network fault kinds — consumed by the TCP chaos proxy
(services/netchaos.py) between real processes, and by the simulator /
FakeExecutor as virtual-clock partitions of the lease wire:

  network_partition  the wire is severed: live connections are killed and
                     new ones refused for the window (both directions)
  network_blackhole  bytes are silently swallowed; connections stay open
                     so callers hang until their own deadline fires
  network_delay      each forwarded chunk is delayed by `param` seconds
  network_throttle   forwarding is rate-limited (`param` scales the
                     byte rate; see netchaos.THROTTLE_BYTES_PER_SEC)
  network_rst        connections are reset (RST, not FIN) mid-stream

Alongside the plan live the degradation primitives injected faults are
met with: seeded exponential backoff with jitter (agent retry loop) and a
per-executor circuit breaker (the server's lease path), so a faulty
executor degrades its own lease flow instead of wedging a cycle.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

NETWORK_FAULT_KINDS = (
    "network_partition",
    "network_blackhole",
    "network_delay",
    "network_throttle",
    "network_rst",
)

# Solver faults — injected at the kernel seam by SolverChaos below, the
# failure family the self-healing solve path (round admission firewall +
# backend failover ladder, solver/validate.py + solver/failover.py)
# exists to contain. Targets are ladder-rung labels ("LOCAL", "oracle",
# "mesh:2x4", "hotwindow:64"); "*" poisons every rung:
#
#   solver_raise            the solve raises mid-round (CUDA runtime
#                           error / device lost / OOM stand-in)
#   solver_hang             the solve hangs past its budget (surfaced as
#                           SolverHangError — the watchdog's verdict)
#   solver_nan_poison       chosen output arrays are corrupted with NaN
#   solver_wrong_placement  decisions are perturbed (à la the replayer's
#                           tiebreak perturbation) into invalid bindings
SOLVER_FAULT_KINDS = (
    "solver_raise",
    "solver_hang",
    "solver_nan_poison",
    "solver_wrong_placement",
)

FAULT_KINDS = (
    "executor_crash",
    "executor_hang",
    "lease_slow",
    "lease_timeout",
    "torn_log_write",
    "leader_flap",
) + NETWORK_FAULT_KINDS + SOLVER_FAULT_KINDS

# Process-lifecycle kinds only: FaultPlan.generate defaults to these so
# pre-existing seeded soaks keep their schedules; network and solver
# kinds are opted into explicitly (tools/chaos_soak.py partition and
# solver-fault plans, netchaos tests).
PROCESS_FAULT_KINDS = tuple(
    k
    for k in FAULT_KINDS
    if k not in NETWORK_FAULT_KINDS + SOLVER_FAULT_KINDS
)


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: a window [start, start+duration) on a target
    ("*" matches any). `count` bounds point-fault firings inside the
    window (-1 = unlimited); `param` is kind-specific (delay seconds for
    lease_slow, torn-byte fraction for torn_log_write)."""

    kind: str
    target: str = "*"
    start: float = 0.0
    duration: float = float("inf")
    count: int = -1
    param: float = 0.0

    def matches(self, kind: str, target: str, now: float) -> bool:
        return (
            self.kind == kind
            and (self.target == "*" or self.target == target)
            and self.start <= now < self.start + self.duration
        )


class FaultPlan:
    """A seeded, declarative schedule of faults.

    Window queries (`active`) are pure; point-fault queries (`fire`)
    consume from the spec's count — still deterministic for a fixed
    sequence of queries, which a seeded run guarantees."""

    def __init__(self, faults=(), seed: int = 0):
        self.faults = tuple(faults)
        self.seed = seed
        for f in self.faults:
            if f.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {f.kind!r}")
        self._fired = [0] * len(self.faults)
        self._observed: set[int] = set()

    def active(self, kind: str, target: str, now: float) -> FaultSpec | None:
        """The first matching window fault, ignoring counts."""
        for i, f in enumerate(self.faults):
            if f.matches(kind, target, now):
                self._observed.add(i)
                return f
        return None

    def fire(self, kind: str, target: str, now: float) -> FaultSpec | None:
        """Consume one firing of the first matching fault with budget
        left; None when nothing fires."""
        for i, f in enumerate(self.faults):
            if not f.matches(kind, target, now):
                continue
            if f.count >= 0 and self._fired[i] >= f.count:
                continue
            self._fired[i] += 1
            return f
        return None

    def fired(self) -> int:
        """Point-fault firings plus window faults a component actually
        hit — "how much chaos really landed" for soak reporting."""
        return sum(self._fired) + len(self._observed)

    @staticmethod
    def generate(
        seed: int,
        duration: float,
        executors=(),
        kinds=None,
        events_per_kind: int = 2,
    ) -> "FaultPlan":
        """A random-but-reproducible plan over [0, duration): same seed,
        same plan. Executor faults pick targets from `executors`.

        Defaults to the process-lifecycle kinds so pre-existing seeded
        schedules are stable; pass kinds including NETWORK_FAULT_KINDS
        entries to draw partition windows (network faults target
        executors too — the severed wire is per executor↔server link)."""
        import numpy as np

        rng = np.random.default_rng(seed)
        kinds = tuple(kinds) if kinds is not None else PROCESS_FAULT_KINDS
        executors = list(executors)
        faults = []
        for kind in kinds:
            for _ in range(events_per_kind):
                start = float(rng.uniform(0.0, duration * 0.7))
                window = float(rng.uniform(duration * 0.05, duration * 0.2))
                if (
                    kind.startswith(("executor", "lease", "network"))
                    and executors
                ):
                    target = str(executors[int(rng.integers(len(executors)))])
                else:
                    target = "*"
                count = 2 if kind == "torn_log_write" else -1
                param = float(rng.uniform(0.1, 0.9))
                faults.append(
                    FaultSpec(kind, target, start, window, count, param)
                )
        faults.sort(key=lambda f: (f.start, f.kind, f.target))
        return FaultPlan(faults, seed=seed)


class VirtualClock:
    """Mutable clock shared between the simulator and chaos-aware
    components (ChaosLeader, CrashRecoveringLog): the sim advances `now`,
    everyone else reads it."""

    def __init__(self, now: float = 0.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


class ChaosLeader:
    """Leader-election wrapper honoring `leader_flap` windows: while a
    flap is active this instance is not the leader and previously issued
    tokens fail validation — exactly the mid-cycle-deposed-leader path
    the token protocol guards (scheduler.cycle drops the publish)."""

    def __init__(self, inner, plan: FaultPlan, clock=None):
        self.inner = inner
        self.plan = plan
        self.clock = clock if clock is not None else _time.time

    def _flapping(self) -> bool:
        return self.plan.active("leader_flap", "leader", self.clock()) is not None

    def get_token(self):
        from .leader import LeaderToken

        if self._flapping():
            return LeaderToken(leader=False)
        return self.inner.get_token()

    def validate(self, token) -> bool:
        if self._flapping():
            return False
        return self.inner.validate(token)

    def __call__(self) -> bool:
        return not self._flapping() and self.inner()

    def is_holder(self) -> bool:
        return not self._flapping() and self.inner.is_holder()

    def leader_address(self) -> str:
        return self.inner.leader_address()


class ExponentialBackoff:
    """Exponential backoff with seeded full jitter: delay_k ~ U(0,
    min(cap, base * 2^k)). Seeded so retry schedules are reproducible in
    chaos runs.

    `budget_s` bounds the CUMULATIVE sleep of one retry streak (reset()
    to reset() / success to success): a retrying lease exchange must
    never sleep past the lease it is renewing (lease_ttl), so the last
    delay is clamped to the remaining budget and, once it is spent,
    `exhausted` flips and further delays poll flat at base_s — the lease
    is already dead, so the caller wants prompt reconnection plus
    anti-entropy, not longer sleeps."""

    def __init__(self, base_s: float = 0.5, cap_s: float = 30.0, seed: int = 0,
                 budget_s: float | None = None):
        import numpy as np

        self.base_s = base_s
        self.cap_s = cap_s
        self.budget_s = budget_s
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self.attempt = 0
        self.spent_s = 0.0

    @property
    def exhausted(self) -> bool:
        return self.budget_s is not None and self.spent_s >= self.budget_s

    def next_delay(self) -> float:
        ceiling = min(self.cap_s, self.base_s * (2.0 ** self.attempt))
        self.attempt += 1
        delay = float(self._rng.uniform(0.0, ceiling))
        if self.budget_s is not None:
            remaining = self.budget_s - self.spent_s
            if remaining <= 0.0:
                return min(self.base_s, self.cap_s)
            delay = min(delay, remaining)
        self.spent_s += delay
        return delay

    def reset(self) -> None:
        import numpy as np

        self.attempt = 0
        self.spent_s = 0.0
        self._rng = np.random.default_rng(self._seed)


class CircuitOpenError(RuntimeError):
    """Raised by a guarded path while its circuit is open: the RPC
    fast-fails (UNAVAILABLE on the wire, identically on both the JSON and
    proto executor wires) and the caller's backoff loop absorbs it."""


class CircuitBreaker:
    """Per-key circuit breaker (the server's lease path keys by executor
    name): closed -> open after `failure_threshold` consecutive failures;
    after `cooldown_s` one probe is allowed (half-open) — success closes,
    failure re-opens."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0):
        import threading

        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = cooldown_s
        self._failures: dict[str, int] = {}
        self._opened_at: dict[str, float] = {}
        self._probing: set[str] = set()
        # Touched from concurrent gRPC worker threads (one per in-flight
        # lease RPC): check-then-act on the probe set and the failure
        # counters must be atomic.
        self._lock = threading.Lock()

    def _state_locked(self, key: str, now: float) -> str:
        if key not in self._opened_at:
            return "closed"
        if now - self._opened_at[key] >= self.cooldown_s:
            return "half-open"
        return "open"

    def state(self, key: str, now: float | None = None) -> str:
        now = _time.monotonic() if now is None else now
        with self._lock:
            return self._state_locked(key, now)

    def allow(self, key: str, now: float | None = None) -> bool:
        now = _time.monotonic() if now is None else now
        with self._lock:
            state = self._state_locked(key, now)
            if state == "closed":
                return True
            if state == "half-open" and key not in self._probing:
                self._probing.add(key)  # exactly one probe per cooldown
                return True
            return False

    def record_success(self, key: str) -> None:
        with self._lock:
            self._failures.pop(key, None)
            self._opened_at.pop(key, None)
            self._probing.discard(key)

    def record_failure(self, key: str, now: float | None = None) -> None:
        now = _time.monotonic() if now is None else now
        with self._lock:
            count = self._failures.get(key, 0) + 1
            self._failures[key] = count
            self._probing.discard(key)
            if count >= self.failure_threshold:
                self._opened_at[key] = now

    def failures(self, key: str) -> int:
        """Consecutive failures recorded against a key (doctor surface)."""
        with self._lock:
            return self._failures.get(key, 0)


class SolverFaultError(RuntimeError):
    """An injected solver fault: the solve raised mid-round (the
    CUDA-runtime-error / device-lost / OOM stand-in)."""


class SolverHangError(SolverFaultError):
    """An injected solver hang past its round budget, surfaced the way a
    watchdog would report it (the in-process seam cannot preempt a truly
    wedged device call, so the chaos plan raises the verdict directly)."""


class SolverChaos:
    """Injects solver faults at the kernel seam (scheduler._solve).

    Attached via SchedulerService.attach_solver_chaos; runs on the same
    clock as the rest of the plan (virtual in the simulator). Fault
    targets match failover-ladder rung labels — a fault targeting
    "LOCAL" fails that rung and the ladder retries below it; a "*"
    fault poisons every rung and the round is rejected and requeued.

    `before_solve` fires raise/hang faults; `corrupt` mutates the solve
    output in place (NaN poison into chosen float arrays, wrong-
    placement perturbation of scheduled bindings) and returns the kinds
    applied so callers can account injections.
    """

    def __init__(self, plan: FaultPlan, clock=None):
        self.plan = plan
        self.clock = clock if clock is not None else _time.monotonic
        self.injected: dict[str, int] = {}

    def _note(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def before_solve(self, rung_label: str) -> None:
        now = self.clock()
        if self.plan.fire("solver_raise", rung_label, now) is not None:
            self._note("solver_raise")
            raise SolverFaultError(
                f"injected solver_raise on rung {rung_label!r}"
            )
        if self.plan.fire("solver_hang", rung_label, now) is not None:
            self._note("solver_hang")
            raise SolverHangError(
                f"injected solver_hang on rung {rung_label!r}: solve "
                "exceeded its round budget"
            )

    def corrupt(self, rung_label: str, out: dict) -> list:
        import numpy as np

        now = self.clock()
        applied = []
        if self.plan.fire("solver_nan_poison", rung_label, now) is not None:
            self._note("solver_nan_poison")
            for key in ("fair_share", "uncapped_fair_share"):
                arr = out.get(key)
                if arr is None:
                    continue
                arr = np.array(arr, dtype=np.float64, copy=True)
                if arr.size:
                    arr.flat[0] = np.nan
                out[key] = arr
            applied.append("solver_nan_poison")
        if (
            self.plan.fire("solver_wrong_placement", rung_label, now)
            is not None
        ):
            self._note("solver_wrong_placement")
            sched = np.array(out.get("scheduled_mask"), dtype=bool, copy=True)
            assigned = np.array(out.get("assigned_node"), copy=True)
            if sched.any():
                # Reflect scheduled bindings into invalid negative
                # indices (NO_NODE is -1; anything below is garbage a
                # miscompiled gather could emit — and would silently
                # wrap to the wrong node if committed).
                assigned[sched] = -2 - assigned[sched]
            elif sched.size:
                # Nothing scheduled this round: fabricate a scheduled
                # binding onto a garbage node so the window still lands
                # a detectable fault.
                sched.flat[0] = True
                assigned.flat[0] = -5
                out["scheduled_mask"] = sched
            out["assigned_node"] = assigned
            applied.append("solver_wrong_placement")
        return applied


class CrashRecoveringLog:
    """A FileEventLog whose torn-write faults behave like process crashes.

    Wraps a FileEventLog built with a FaultPlan-driven injector and
    sync_every=1 (so the only record at risk is the one being torn). When
    an append tears, the wrapper reopens the log — recovery truncates the
    torn tail — and retries the publish: the at-least-once redelivery a
    restarted publisher performs. Views keep their reference to the
    wrapper across "crashes"."""

    def __init__(self, directory: str, plan: FaultPlan | None = None,
                 clock=None, target: str = "log", **kwargs):
        self.directory = directory
        self.plan = plan
        self.clock = clock if clock is not None else _time.time
        # Fault target this log answers to ("log" historically; front-door
        # shard WALs use "shard-<i>" so one plan can tear a single shard).
        self.target = target
        self.crashes = 0
        self._suppress_once = False
        kwargs["sync_every"] = 1
        self._kwargs = kwargs
        self._open()

    def _injector(self, data_len: int) -> int | None:
        if self.plan is None or self._suppress_once:
            # The retry immediately after a "crash" must succeed — an
            # unlimited-count torn_log_write spec would otherwise re-fire
            # on every retry and publish() would never terminate (the
            # virtual clock cannot advance inside one publish).
            self._suppress_once = False
            return None
        spec = self.plan.fire("torn_log_write", self.target, self.clock())
        if spec is None:
            return None
        frac = spec.param if 0.0 < spec.param < 1.0 else 0.5
        return max(0, min(data_len - 1, int(data_len * frac)))

    def _open(self):
        from ..events.file_log import FileEventLog

        self._inner = FileEventLog(
            self.directory, fault_injector=self._injector, **self._kwargs
        )

    def publish(self, sequence) -> int:
        from ..events.file_log import InjectedFault

        while True:
            try:
                return self._inner.publish(sequence)
            except InjectedFault:
                self.crashes += 1
                self._suppress_once = True  # the restarted retry lands
                self._open()  # recovery truncates the torn tail

    # -- delegation (the EventLog read surface) --

    def read(self, cursor, limit: int = 1000):
        return self._inner.read(cursor, limit)

    def read_jobset(self, queue, jobset, cursor: int = 0):
        return self._inner.read_jobset(queue, jobset, cursor)

    @property
    def end_offset(self) -> int:
        return self._inner.end_offset

    @property
    def start_offset(self) -> int:
        return self._inner.start_offset

    @property
    def dir(self):
        return self._inner.dir

    def compact(self, up_to: int) -> int:
        return self._inner.compact(up_to)

    def watcher(self):
        return self._inner.watcher()

    def remove_watcher(self, cond):
        return self._inner.remove_watcher(cond)

    def flush(self):
        return self._inner.flush()

    def close(self):
        return self._inner.close()
