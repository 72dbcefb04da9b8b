"""Per-tenant admission control: token buckets + quota-weighted shedding.

The reference protects its submit path with per-queue rate limits
(internal/server/submit rate limiting, config.yaml:105-108 analogues) and
sheds work when the store backs up; the fair-allocation literature in
PAPERS.md (1803.00922 on Mesos, 1404.2266 proportional fairness) argues
that overload shedding must be tenant-aware — a global gate lets one hot
queue starve every other tenant's intake.

Two regimes, one `admit()` surface:

  normal    each tenant draws from its own token bucket (rate/burst) and
            a shared global bucket. A tenant flooding past its rate is
            shed with a computed retry-after while every other tenant's
            bucket is untouched.

  overload  the downstream gate (services/backpressure.CompositeGate —
            store capacity, ingest lag, round-deadline pressure) is
            unhealthy. Intake drops to a trickle (`overload_rate`)
            apportioned by QUOTA WEIGHT (1/priorityFactor, the same
            weight fair share uses): each tenant's trickle bucket refills
            at overload_rate * w / sum(w over recently active tenants),
            so a hot tenant exhausts its slice and is shed first while
            light high-quota tenants keep a (reduced) flow. The shed
            reason carries the downstream gate's own reason.

Every rejection is an `AdmissionError` with `retry_after_s` — the
transport maps it to RESOURCE_EXHAUSTED plus a `retry-after` trailing
header so clients back off deliberately instead of timing out
(ApiClient/ProtoApiClient honor it with a bounded jittered backoff).

`DeadlineExpired` is the submit wire's deadline propagation: the client
deadline travels to the server gate and the ingest enqueue; work that
cannot possibly be acknowledged in time is dropped EARLY (before the
durable WAL append — after the append it is acked and always applies,
never half-applied).
"""

from __future__ import annotations

import threading
import time as _time


class AdmissionError(RuntimeError):
    """Submission shed by admission control. `retry_after_s` is the
    server-computed earliest useful retry instant (seconds from now)."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(
            f"{reason}; retry after {max(0.0, retry_after_s):.3f}s"
        )
        self.reason = reason
        self.retry_after_s = max(0.0, float(retry_after_s))


class DeadlineExpired(RuntimeError):
    """The caller's deadline expired before the work could be durably
    acknowledged; dropped at `stage` ("gate" = before any processing,
    "enqueue" = before the WAL append). Never raised after the ack."""

    def __init__(self, stage: str, detail: str = ""):
        super().__init__(
            f"deadline expired before {stage}"
            + (f": {detail}" if detail else "")
        )
        self.stage = stage


class TokenBucket:
    """Classic token bucket. `try_take(n)` returns 0.0 on admit or the
    seconds until n tokens will be available (the retry-after hint).
    Rates are tokens/second; `now` is injectable (virtual clocks)."""

    def __init__(self, rate: float, burst: float, now: float | None = None):
        self.rate = max(1e-9, float(rate))
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._last = now

    def _refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
        elapsed = max(0.0, now - self._last)
        self._last = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)

    def try_take(self, n: float = 1.0, now: float | None = None) -> float:
        now = _time.monotonic() if now is None else now
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        deficit = n - self.tokens
        return deficit / self.rate


class TenantAdmission:
    """Tenant-aware admission in front of the backpressure stack.

    `quota_of(tenant) -> weight` supplies the fair-share weight
    (1/priorityFactor; ControlPlane wires it to the queue registry) —
    raising a hot tenant's priority factor shrinks its overload slice,
    the runbook's "adjust quota" lever. `downstream` is any object with
    check() -> (healthy, reason) (CompositeGate / StoreHealthMonitor).
    """

    def __init__(
        self,
        tenant_rate: float = 1000.0,
        tenant_burst: float = 2000.0,
        global_rate: float = 10_000.0,
        global_burst: float = 20_000.0,
        overload_rate: float = 100.0,
        downstream=None,
        quota_of=None,
        metrics=None,
        active_window_s: float = 30.0,
    ):
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = float(tenant_burst)
        self.overload_rate = float(overload_rate)
        self.downstream = downstream
        self.quota_of = quota_of
        self.metrics = metrics
        self.active_window_s = active_window_s
        self._global = TokenBucket(global_rate, global_burst)
        self._tenant: dict[str, TokenBucket] = {}
        self._trickle: dict[str, TokenBucket] = {}
        self._last_seen: dict[str, float] = {}  # overload-slice membership
        # admit() is called from concurrent gRPC worker threads: the
        # lock guards every bucket read-modify-write (a lost token
        # decrement would admit a flood past its configured rate) as
        # well as the counters feeding metrics and the lookout view.
        # Reentrant because _note runs inside the admit critical
        # section.
        self._lock = threading.RLock()
        self.admitted: dict[str, int] = {}
        self.shed: dict[str, int] = {}
        self.last_shed_reason: dict[str, str] = {}

    # ---- introspection (lookout /api/frontdoor) ----

    def snapshot(self) -> dict:
        with self._lock:
            tenants = sorted(
                set(self.admitted) | set(self.shed),
                key=lambda t: -(self.shed.get(t, 0)),
            )
            return {
                "tenants": [
                    {
                        "tenant": t,
                        "admitted": self.admitted.get(t, 0),
                        "shed": self.shed.get(t, 0),
                        "last_shed_reason": self.last_shed_reason.get(t, ""),
                    }
                    for t in tenants
                ],
            }

    # ---- the gate ----

    def _weight(self, tenant: str) -> float:
        if self.quota_of is None:
            return 1.0
        try:
            w = float(self.quota_of(tenant))
        except Exception:
            return 1.0
        return w if w > 0.0 else 1.0

    def _note(self, tenant: str, n: int, shed_reason: str | None) -> None:
        with self._lock:
            if shed_reason is None:
                self.admitted[tenant] = self.admitted.get(tenant, 0) + n
            else:
                self.shed[tenant] = self.shed.get(tenant, 0) + n
                self.last_shed_reason[tenant] = shed_reason
        m = self.metrics
        if m is not None and getattr(m, "registry", None) is not None:
            if shed_reason is None:
                m.frontdoor_admitted.labels(tenant=tenant).inc(n)
            else:
                # Reason label keeps cardinality bounded: the reason CLASS,
                # not the free-text downstream detail.
                kind = shed_reason.split(":", 1)[0]
                m.frontdoor_shed.labels(tenant=tenant, reason=kind).inc(n)

    def admit(self, tenant: str, n: int = 1, now: float | None = None) -> None:
        """Admit n submissions for `tenant` or raise AdmissionError.
        Pass `now` on a virtual clock (sim/soak); wall monotonic
        otherwise. Counting is per JOB, not per RPC, so one huge batch
        cannot sail under a per-request limit."""
        now = _time.monotonic() if now is None else now
        healthy, reason = (True, "")
        if self.downstream is not None:
            healthy, reason = self.downstream.check()
        with self._lock:
            if not healthy:
                self._last_seen[tenant] = now
                wait = self._trickle_take(tenant, n, now)
                if wait > 0.0:
                    shed_reason = f"overload:{reason}"
                    self._note(tenant, n, shed_reason)
                    raise AdmissionError(
                        f"control plane overloaded ({reason}); tenant "
                        f"{tenant!r} is over its quota-weighted overload "
                        "slice",
                        wait,
                    )
                self._note(tenant, n, None)
                return
            bucket = self._tenant.get(tenant)
            if bucket is None:
                bucket = self._tenant[tenant] = TokenBucket(
                    self.tenant_rate, self.tenant_burst, now=now
                )
            wait = bucket.try_take(n, now)
            if wait > 0.0:
                self._note(tenant, n, "tenantRate")
                raise AdmissionError(
                    f"tenant {tenant!r} exceeded its submission rate "
                    f"({self.tenant_rate:.0f}/s, burst "
                    f"{self.tenant_burst:.0f})",
                    wait,
                )
            wait = self._global.try_take(n, now)
            if wait > 0.0:
                # The tenant bucket already debited; refund so a globally
                # shed request does not double-charge the tenant's own
                # budget.
                bucket.tokens = min(bucket.burst, bucket.tokens + n)
                self._note(tenant, n, "globalRate")
                raise AdmissionError(
                    "front door exceeded the global submission rate "
                    f"({self._global.rate:.0f}/s)",
                    wait,
                )
            self._note(tenant, n, None)

    def _trickle_take(self, tenant: str, n: int, now: float) -> float:
        """Overload mode: one trickle bucket per recently active tenant,
        refilling at overload_rate x (its quota share). Rates are
        recomputed as the active set shifts, so a tenant going quiet
        returns its slice to the others."""
        stale = [
            t
            for t, ts in self._last_seen.items()
            if now - ts > self.active_window_s
        ]
        for t in stale:
            self._last_seen.pop(t, None)
            self._trickle.pop(t, None)
        total_w = sum(self._weight(t) for t in self._last_seen) or 1.0
        share = self._weight(tenant) / total_w
        rate = max(1e-9, self.overload_rate * share)
        bucket = self._trickle.get(tenant)
        if bucket is None:
            # A fresh overload bucket starts with one slice-second of
            # burst, not a full normal-mode burst: overload means drain,
            # not another burst window.
            bucket = self._trickle[tenant] = TokenBucket(
                rate, max(1.0, rate), now=now
            )
        else:
            bucket.rate = rate
            bucket.burst = max(1.0, rate)
        return bucket.try_take(n, now)
