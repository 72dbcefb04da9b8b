"""Health checking: startup + liveness surface.

Mirrors internal/common/health/ (startup checker, multi
checker, HTTP handler wired per service at schedulerapp.go:71-75): each
component registers a named checker; the multi-checker aggregates; an
HTTP endpoint exposes /health (liveness) and /health/startup.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class StartupCompleteChecker:
    """Satisfied once the component signals it finished starting
    (health/startup_complete_checker.go)."""

    def __init__(self, name: str = "startup"):
        self.name = name
        self._complete = False

    def mark_complete(self):
        self._complete = True

    def check(self) -> tuple[bool, str]:
        return (True, "started") if self._complete else (False, "starting")


class FuncChecker:
    """Wraps a callable returning (ok, detail)."""

    def __init__(self, name: str, fn):
        self.name = name
        self.fn = fn

    def check(self) -> tuple[bool, str]:
        try:
            result = self.fn()
            if isinstance(result, tuple):
                return bool(result[0]), str(result[1])
            return bool(result), ""
        except Exception as e:  # a crashing checker is unhealthy
            return False, f"checker raised: {e!r}"


class HeartbeatChecker:
    """Healthy while beats keep arriving within the timeout (used for the
    scheduler cycle loop: a wedged cycle turns the service unhealthy)."""

    def __init__(self, name: str, timeout_s: float):
        self.name = name
        self.timeout_s = timeout_s
        self._last = time.monotonic()

    def beat(self):
        self._last = time.monotonic()

    def check(self) -> tuple[bool, str]:
        age = time.monotonic() - self._last
        ok = age <= self.timeout_s
        return ok, f"last beat {age:.1f}s ago (timeout {self.timeout_s}s)"


class BackpressureChecker:
    """Adapts a backpressure monitor (check() -> (healthy, reason); see
    services/backpressure.py — StoreHealthMonitor, RoundDeadlinePressure)
    into a named health checker with the monitor's reason attached.

    advisory=True reports the tripped reason in the /health payload
    WITHOUT failing the aggregate: round-deadline pressure means the
    scheduler is degrading as designed (committing partial rounds, still
    making progress) — failing the liveness probe for it would invite an
    orchestrator restart loop that helps nothing. Intake shedding for
    such signals belongs on the submit gate (CompositeGate), not
    liveness."""

    def __init__(self, name: str, monitor, advisory: bool = False):
        self.name = name
        self.monitor = monitor
        self.advisory = advisory

    def check(self) -> tuple[bool, str]:
        try:
            healthy, reason = self.monitor.check()
        except Exception as e:  # a crashing monitor is unhealthy
            return False, f"monitor raised: {e!r}"
        if not healthy and self.advisory:
            return True, f"advisory (degraded but live): {reason}"
        return bool(healthy), reason or "ok"


class FencedExecutorChecker:
    """Advisory surface for lease fencing (services/grpc_api.py): names
    executors that were fenced — their runs reassigned after a partition
    — and have not yet completed an anti-entropy ExecutorSync. Always
    healthy: a fenced executor is the PROTOCOL working (stale exchanges
    rejected FAILED_PRECONDITION until the sync lands); failing liveness
    for it would restart a perfectly good scheduler. The detail string is
    the operator's cue that a partition healed badly or an agent is not
    running the sync."""

    def __init__(self, scheduler, name: str = "fenced-executors"):
        self.name = name
        self.scheduler = scheduler

    def check(self) -> tuple[bool, str]:
        breached = sorted(getattr(self.scheduler, "fence_breached", ()))
        if not breached:
            return True, "no fenced executors"
        fences = {
            name: self.scheduler.executor_fence(name) for name in breached
        }
        return True, (
            "advisory (degraded but live): executors awaiting "
            f"post-fence sync: {fences}"
        )


class SolverLadderChecker:
    """Advisory surface for the self-healing solve path (solver/
    failover.py): names ladder rungs whose circuit breakers are open or
    half-open, and the count of recent admission-firewall rejections.
    Always healthy: a degraded ladder means the containment is WORKING
    (rounds still land on lower rungs, poisoned rounds are quarantined,
    nothing invalid commits) — restarting the scheduler for it would
    throw away the breaker state that is routing around the fault. The
    detail string is the operator's cue to run `armadactl doctor`."""

    def __init__(self, scheduler, name: str = "solver-ladder"):
        self.name = name
        self.scheduler = scheduler

    def check(self) -> tuple[bool, str]:
        report = getattr(self.scheduler, "doctor_report", None)
        if report is None:
            return True, "no solve ladder on this scheduler"
        doc = report()
        degraded = [
            f"{row['rung']}={row['state']}"
            for row in doc.get("ladder", ())
            if row.get("state") not in ("closed", "disabled")
        ]
        rejections = len(doc.get("rejections") or ())
        if not degraded and not rejections:
            return True, "all solver rungs closed, no recent rejections"
        return True, (
            "advisory (degraded but live): "
            f"rungs [{', '.join(degraded) or 'all closed'}], "
            f"{rejections} recent round rejection(s) — "
            "see `armadactl doctor`"
        )


class MultiChecker:
    """health/multi_checker.go: all registered checkers must pass."""

    def __init__(self, *checkers):
        self.checkers = list(checkers)

    def add(self, checker):
        self.checkers.append(checker)

    def check(self) -> tuple[bool, dict]:
        results = {}
        ok = True
        for checker in self.checkers:
            c_ok, detail = checker.check()
            results[checker.name] = {"ok": c_ok, "detail": detail}
            ok = ok and c_ok
        return ok, results


def serve_health(
    checker: MultiChecker,
    startup: StartupCompleteChecker | None = None,
    port: int = 0,
):
    """HTTP health endpoint: /health (liveness via the multi-checker) and
    /health/startup (the startup checker alone). Returns (server, port);
    server runs on a daemon thread."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/health/startup" and startup is not None:
                ok, detail = startup.check()
                body = {"ok": ok, "detail": detail}
            elif self.path in ("/health", "/healthz"):
                ok, body = checker.check()
                body = {"ok": ok, "checks": body}
            else:
                self.send_response(404)
                self.end_headers()
                return
            data = json.dumps(body).encode()
            self.send_response(200 if body["ok"] else 503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):  # quiet
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]
