"""SLO tracking: multi-window burn rates over declared latency objectives.

Everything before this gated on bit-exactness (replay) or throughput
(bench); nothing gated on what a USER feels — round latency, queue
wait, submit latency. This module is that layer:

- `SLOSpec` (core/config.py): a declared objective over one signal —
  an observation counts GOOD iff value <= threshold_s, and the
  objective is the required good fraction.
- `SLOTracker`: bounded per-SLO event windows with burn rates. Burn
  rate over a window = error_rate / error_budget where error_budget =
  1 - objective; 1.0 means spending the budget exactly at the rate
  that exhausts it at the window's end. The alerting shape is the SRE
  -workbook multiwindow multi-burn-rate rule: a breach requires the
  FAST window (default 5 min at 14x) AND the SLOW window (default 1 h
  at 6x) to both exceed their thresholds — fast-only spikes and
  long-tail noise don't page.
- `evaluate()`: the gate face (tools/slo_gate.py, soak --slo flags):
  over a finite run, an SLO breaches when its lifetime compliance
  falls below the objective or the multiwindow alert fired at any
  observation.

Clock discipline: `observe(..., now=)` takes the caller's clock — the
simulator's virtual time, a soak's virtual clock, or wall time in the
live control plane — so burn windows mean the same thing in every
harness. Values are durations in seconds on whatever signal the SLO
declares; the vocabulary is open (soaks add e.g. shard-lag signals).
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque

from ..core.config import SLOSpec

# The default objectives a tracker runs with when the config declares
# none. round-latency mirrors the reference's 5s maxSchedulingDuration
# guard (config/scheduler/config.yaml:83); frontdoor-p99 mirrors the
# committed frontdoor_soak SLO.
DEFAULT_SLOS = (
    SLOSpec(
        name="round-latency",
        signal="round_seconds",
        threshold_s=5.0,
        objective=0.99,
        description="99% of scheduling cycles complete within 5s (the "
        "reference's maxSchedulingDuration operating point)",
    ),
    SLOSpec(
        name="queue-wait",
        signal="queue_wait_seconds",
        threshold_s=300.0,
        objective=0.95,
        description="95% of jobs receive their first lease within 5 "
        "minutes of submission",
    ),
    SLOSpec(
        name="frontdoor-p99",
        signal="frontdoor_submit_seconds",
        threshold_s=0.25,
        objective=0.99,
        description="99% of submits ack (admission + durable shard-WAL "
        "append) within 250ms",
    ),
)

# Ring-buffer bound per SLO: at one scheduling cycle per second a slow
# window of an hour needs 3600 events; 100k covers every configured
# window at soak rates while bounding memory.
MAX_EVENTS = 100_000


class SLOTracker:
    """Thread-safe (observations arrive from gRPC workers, the cycle
    thread and ingest callbacks); all windows prune lazily on read."""

    def __init__(self, slos=(), metrics=None, clock=None,
                 keep_observations: int = 0):
        self.slos: tuple[SLOSpec, ...] = tuple(slos) or DEFAULT_SLOS
        self.metrics = metrics
        self._clock = clock or _time.time
        self._lock = threading.Lock()
        # keep_observations > 0 retains the raw (signal, value, now)
        # stream (bounded) — the soaks export it as an observation
        # document tools/slo_gate.py re-evaluates offline.
        self._history: deque | None = (
            deque(maxlen=keep_observations) if keep_observations else None
        )
        # slo name -> deque[(ts, good)], bounded at MAX_EVENTS with an
        # explicit prune that maintains the running good count — so
        # compliance is O(1) to read and covers the RETENTION WINDOW,
        # not the process lifetime: a long-running control plane's
        # compliance heals after an incident instead of carrying it
        # forever (finite gate runs under the cap see every event, so
        # the gate semantics are unchanged).
        self._events: dict[str, deque] = {s.name: deque() for s in self.slos}
        self._window_good: dict[str, int] = {s.name: 0 for s in self.slos}
        # Whether the multiwindow alert ever fired (the gate's memory of
        # a mid-run burn even if the tail recovered).
        self._ever_breached: dict[str, float | None] = {
            s.name: None for s in self.slos
        }
        self._by_signal: dict[str, list[SLOSpec]] = {}
        for s in self.slos:
            self._by_signal.setdefault(s.signal, []).append(s)

    @classmethod
    def from_config(cls, config, metrics=None, clock=None) -> "SLOTracker":
        return cls(getattr(config, "slos", ()) or (), metrics=metrics,
                   clock=clock)

    def observes(self, signal: str) -> bool:
        """Whether any declared SLO covers this signal — callers can
        skip measuring entirely when nothing listens."""
        return signal in self._by_signal

    # -- observation ---------------------------------------------------

    def observe(self, signal: str, value: float, now: float | None = None):
        specs = self._by_signal.get(signal)
        if not specs:
            return
        now = self._clock() if now is None else float(now)
        if self._history is not None:
            with self._lock:
                self._history.append((signal, float(value), now))
        m = self.metrics
        for spec in specs:
            good = float(value) <= spec.threshold_s
            with self._lock:
                events = self._events[spec.name]
                events.append((now, good))
                if good:
                    self._window_good[spec.name] += 1
                while len(events) > MAX_EVENTS:
                    _, was_good = events.popleft()
                    if was_good:
                        self._window_good[spec.name] -= 1
            if m is not None and getattr(m, "registry", None) is not None:
                m.slo_events.labels(
                    slo=spec.name, verdict="good" if good else "bad"
                ).inc()
            if not good and self._ever_breached[spec.name] is None:
                # Breach memory can only transition once, and only a bad
                # event can newly fire the alert — so the O(window) burn
                # scans run at most once per bad event UNTIL the first
                # breach and never again (a sustained breach must not
                # turn the submit hot path quadratic).
                burn_fast = self._burn(spec, spec.fast_burn_window_s, now)
                burn_slow = self._burn(spec, spec.slow_burn_window_s, now)
                if (
                    burn_fast >= spec.fast_burn_threshold
                    and burn_slow >= spec.slow_burn_threshold
                ):
                    self._ever_breached[spec.name] = now

    # -- burn math -----------------------------------------------------

    def _burn(self, spec: SLOSpec, window_s: float, now: float) -> float:
        """Error-budget burn rate over the trailing window; 0.0 on an
        empty window."""
        with self._lock:
            events = self._events[spec.name]
            total = bad = 0
            for ts, good in reversed(events):
                if ts < now - window_s:
                    break
                total += 1
                if not good:
                    bad += 1
        if total == 0:
            return 0.0
        budget = max(1e-9, 1.0 - spec.objective)
        return (bad / total) / budget

    def burn_rates(self, now: float | None = None) -> dict:
        """{slo: {"fast": burn, "slow": burn}} over each SLO's windows."""
        now = self._clock() if now is None else float(now)
        return {
            s.name: {
                "fast": round(self._burn(s, s.fast_burn_window_s, now), 3),
                "slow": round(self._burn(s, s.slow_burn_window_s, now), 3),
            }
            for s in self.slos
        }

    def update_metrics(self, now: float | None = None):
        """Refresh the slo_burn_rate / slo_compliance gauges (called
        once per scheduling cycle — burn math is O(window events))."""
        m = self.metrics
        if m is None or getattr(m, "registry", None) is None:
            return
        now = self._clock() if now is None else float(now)
        for s in self.slos:
            m.slo_burn_rate.labels(slo=s.name, window="fast").set(
                self._burn(s, s.fast_burn_window_s, now)
            )
            m.slo_burn_rate.labels(slo=s.name, window="slow").set(
                self._burn(s, s.slow_burn_window_s, now)
            )
            with self._lock:
                good = self._window_good[s.name]
                total = len(self._events[s.name])
            if total:
                m.slo_compliance.labels(slo=s.name).set(good / total)

    # -- reading -------------------------------------------------------

    def snapshot(self, now: float | None = None) -> dict:
        """The `/api/slo` / `armadactl slo` document. Counts and
        compliance cover the retention window (last MAX_EVENTS
        observations per SLO): live status heals after an incident;
        `breached_at` separately remembers a fired multiwindow alert
        for finite-run gates."""
        now = self._clock() if now is None else float(now)
        slos = []
        for s in self.slos:
            with self._lock:
                good = self._window_good[s.name]
                total = len(self._events[s.name])
            bad = total - good
            fast = self._burn(s, s.fast_burn_window_s, now)
            slow = self._burn(s, s.slow_burn_window_s, now)
            slos.append(
                {
                    "name": s.name,
                    "signal": s.signal,
                    "threshold_s": s.threshold_s,
                    "objective": s.objective,
                    "description": s.description,
                    "observed": total,
                    "good": good,
                    "bad": bad,
                    "compliance": round(good / total, 6) if total else None,
                    "burn": {
                        "fast": {
                            "window_s": s.fast_burn_window_s,
                            "rate": round(fast, 3),
                            "threshold": s.fast_burn_threshold,
                        },
                        "slow": {
                            "window_s": s.slow_burn_window_s,
                            "rate": round(slow, 3),
                            "threshold": s.slow_burn_threshold,
                        },
                    },
                    "alerting": (
                        fast >= s.fast_burn_threshold
                        and slow >= s.slow_burn_threshold
                    ),
                    "breached_at": self._ever_breached[s.name],
                }
            )
        return {"slos": slos, "now": now}

    def observations(self) -> list[dict]:
        """The retained raw stream (keep_observations > 0), in the
        tools/slo_gate.py observation-document shape."""
        with self._lock:
            history = list(self._history or ())
        return [
            {"signal": s, "value": v, "now": t} for s, v, t in history
        ]

    # -- the gate face -------------------------------------------------

    def evaluate(self, now: float | None = None) -> dict:
        """Finite-run verdict for tools/slo_gate.py and the soak --slo
        flags: per-SLO breach strings + ok flag. An SLO with zero
        observations is reported but never breaches (a run that simply
        does not exercise a signal must not fail its gate). Compliance
        is over the retention window — identical to lifetime for any
        run under MAX_EVENTS observations per SLO, i.e. every gate use;
        the multiwindow breach memory catches mid-run burns that a
        recovered tail would otherwise hide."""
        snap = self.snapshot(now=now)
        breaches = []
        for s in snap["slos"]:
            if not s["observed"]:
                continue
            if s["compliance"] is not None and s["compliance"] < s["objective"]:
                breaches.append(
                    f"{s['name']}: compliance {s['compliance']:.4f} below "
                    f"objective {s['objective']} "
                    f"({s['bad']}/{s['observed']} over "
                    f"{s['threshold_s']}s on {s['signal']})"
                )
            elif s["breached_at"] is not None:
                breaches.append(
                    f"{s['name']}: multiwindow burn alert fired at "
                    f"t={s['breached_at']:.1f} (fast>="
                    f"{s['burn']['fast']['threshold']}x and slow>="
                    f"{s['burn']['slow']['threshold']}x) even though "
                    "lifetime compliance recovered"
                )
        return {"slos": snap["slos"], "breaches": breaches,
                "ok": not breaches}
