"""Online solver autotuning: a bounded hill-climb with hysteresis.

The controller closes the loop the `hot-window-autotune` gap described:
the solve profile already measures the rewindow rate and the
pass1/gather split every round, so between rounds the controller nudges
the per-pool hot-window size toward the regime those signals indicate —

  - many REWINDOWs per solve: the window drains before pass 1 finishes,
    every re-gather costs a host round-trip → grow the window (double);
  - zero rewindows with the gather/scatter segment dominating the
    compacted solve: the window is oversized for the live frontier,
    each gather moves more rows than pass 1 consumes → shrink (halve);
  - persistent NON-compacted rounds with an above-floor window: the
    window may have out-grown the engagement geometry (the kernel
    vetoes compaction when 2*Q*Ws >= S) and no compacted profile will
    ever say so → shrink back toward the floor (the recovery path for
    an over-grow, which would otherwise persist forever).

Moves are pow2 steps (the window round is padded to pow2 buckets — an
arbitrary-size move would only change the padding) bounded to
[autotune_min_window_slots, autotune_max_window_slots], and a move
needs `autotune_hysteresis_rounds` CONSECUTIVE rounds of the same
signal followed by an equal cooldown before the next judgement, so a
single bursty round cannot flap the window.

Only perf-only knobs ever move: the hot window and the budgeted
driver's starting chunk are bit-exact with the uncompacted kernel by
construction (tests/test_torch_hotwindow.py), so an adoption can change
WHEN the round finishes, never WHAT it decides. Every adoption is logged,
counted in `scheduler_autotune_adjustments_total`, and written to the
tuning store (workload "live", per pool) so it survives restart via
the control plane's checkpoint pass.

This is the port's copy of the JAX package's autotune/controller.py. It
reads the solve profile of the port's host-driven driver
(`solver/kernel.py::solve_round`: `compacted`, `rewindows`, `gather_s`,
`pass1_s`, the same keys filled the same way), and decides exactly what
the JAX package's controller decides for the same profiles.
"""

from __future__ import annotations

import dataclasses
import time

from .store import TunedParams, TuningStore, current_target, make_entry

# Signal thresholds for one observed round: `REWINDOW_HIGH` or more
# re-gathers reads as window-starved; a gather/scatter share at or
# above `GATHER_FRAC_HIGH` of the compacted solve (with zero
# rewindows) reads as window-oversized.
REWINDOW_HIGH = 4
GATHER_FRAC_HIGH = 0.5

# Bounded history of adopted changes kept for introspection/tests.
ADOPTION_LOG_MAX = 256


@dataclasses.dataclass
class _PoolState:
    params: TunedParams
    grow_streak: int = 0
    shrink_streak: int = 0
    # Rounds in a row the kernel ran with the window configured but NOT
    # engaged (fused path / precheck veto). A window grown past the
    # engagement geometry (2*Q*Ws >= S) produces exactly this — and no
    # compacted profile ever arrives to shrink it back, so disengaged
    # rounds themselves are the recovery signal.
    disengaged_streak: int = 0
    cooldown: int = 0
    source: str = "config"


class AutotuneController:
    def __init__(self, config, store: TuningStore | None = None, *,
                 enabled: bool | None = None):
        self.config = config
        self.enabled = (
            bool(getattr(config, "autotune_enabled", False))
            if enabled is None
            else bool(enabled)
        )
        self.store = store if store is not None else TuningStore()
        self.hysteresis = max(
            1, int(getattr(config, "autotune_hysteresis_rounds", 3))
        )
        self.min_window = max(
            1, int(getattr(config, "autotune_min_window_slots", 64))
        )
        self.max_window = max(
            self.min_window,
            int(getattr(config, "autotune_max_window_slots", 1 << 16)),
        )
        # The kernel clamps the effective window at its head lookahead
        # (Ws = pow2(max(window, lookahead))): shrinking the CONFIGURED
        # window below that is a no-op the profile can never confirm,
        # so the climb would march to the bound adopting ineffective
        # moves. The shrink floor is therefore the larger of the
        # operator bound and the lookahead (one shared rule:
        # SchedulingConfig.window_lookahead).
        self.window_floor = max(self.min_window, config.window_lookahead())
        self._target: dict | None = None
        self._pools: dict[str, _PoolState] = {}
        self.adoptions: list[dict] = []

    # -- parameter resolution ------------------------------------------

    def target(self) -> dict:
        if self._target is None:
            self._target = current_target()
        return self._target

    def _state(self, pool: str) -> _PoolState:
        st = self._pools.get(pool)
        if st is None:
            # Boot-time adoption: the persisted store (pool-specific
            # online entry beats the offline "*" profile, newest wins)
            # seeds the vector; config is the fallback.
            entry = self.store.lookup(self.target(), pool)
            if entry is not None:
                st = _PoolState(
                    params=TunedParams.from_dict(entry["params"]),
                    source=entry.get("source", "store"),
                )
            else:
                st = _PoolState(params=TunedParams.from_config(self.config))
            self._pools[pool] = st
        return st

    def params_for(self, pool: str) -> TunedParams | None:
        """The vector the NEXT solve of this pool should run with, or
        None when autotuning is disabled (static config applies)."""
        if not self.enabled:
            return None
        return self._state(pool).params

    # -- the observe/adjust loop ---------------------------------------

    def observe_round(self, pool: str, profile: dict | None, *,
                      solve_s: float | None = None, metrics=None,
                      log=None) -> dict | None:
        """Feed one solved round's profile; returns the adoption dict
        when this observation tripped a parameter change, else None.
        A round that did NOT run compacted (no profile — the fused
        path — or a host-driven profile with compacted=False) while a
        window above the floor is configured is itself a signal: the
        window may have grown past the engagement geometry (the kernel
        vetoes compaction when 2*Q*Ws >= S), in which case no compacted
        profile will ever arrive to shrink it back. Persistent
        disengagement therefore shrinks toward the floor with the same
        hysteresis — self-correcting after an over-grow (or an
        over-grown store entry restored at boot), and harmless when
        rounds are simply small: the window only matters when engaged,
        and the grow signal re-adapts it when load returns. Callers
        must only feed rounds the single-device kernel actually solved
        (the scheduler skips mesh/oracle rounds)."""
        if not self.enabled:
            return None
        st = self._state(pool)
        self._note_gauges(pool, st, metrics)
        if not profile or not profile.get("compacted"):
            return self._observe_disengaged(pool, st, metrics=metrics, log=log)
        st.disengaged_streak = 0
        if st.cooldown > 0:
            st.cooldown -= 1
            return None
        rewindows = int(profile.get("rewindows", 0))
        gather_s = float(profile.get("gather_s") or 0.0)
        pass1_s = float(profile.get("pass1_s") or 0.0)
        gather_frac = gather_s / max(gather_s + pass1_s, 1e-9)
        if rewindows >= REWINDOW_HIGH:
            st.grow_streak += 1
            st.shrink_streak = 0
        elif rewindows == 0 and gather_frac >= GATHER_FRAC_HIGH:
            st.shrink_streak += 1
            st.grow_streak = 0
        else:
            st.grow_streak = st.shrink_streak = 0
            return None
        window = st.params.hot_window_slots
        if window <= 0:
            # Compaction off: there is no window to climb from (and a
            # compacted profile should be impossible here anyway).
            st.grow_streak = st.shrink_streak = 0
            return None
        # One doubling/halving per adoption, clamped to the bounds
        # WITHOUT ever moving against the signal: a window below the
        # min bound may still grow (toward it), but never "shrinks" up
        # to it, and a grow from below the bound is one doubling, not a
        # jump to 2x the bound.
        if st.grow_streak >= self.hysteresis:
            proposed = min(window * 2, self.max_window)
            direction = "grow"
            if proposed <= window:
                proposed = window  # at/above the cap: no move
        elif st.shrink_streak >= self.hysteresis:
            proposed = max(window // 2, self.window_floor)
            direction = "shrink"
            if proposed >= window:
                proposed = window  # at/below the floor: no move
        else:
            return None
        st.grow_streak = st.shrink_streak = 0
        if proposed == window:
            return None  # already at the bound
        return self._adopt(
            pool, st, direction, proposed,
            signal={
                "rewindows": rewindows,
                "gather_frac": round(gather_frac, 3),
                "solve_s": solve_s,
            },
            metrics=metrics, log=log,
        )

    def _observe_disengaged(self, pool, st, *, metrics, log):
        """See observe_round: persistent non-compacted rounds shrink an
        above-floor window back toward engageable territory."""
        st.grow_streak = st.shrink_streak = 0
        if st.params.hot_window_slots <= self.window_floor:
            st.disengaged_streak = 0
            return None
        if st.cooldown > 0:
            st.cooldown -= 1
            return None
        st.disengaged_streak += 1
        if st.disengaged_streak < self.hysteresis:
            return None
        st.disengaged_streak = 0
        proposed = max(st.params.hot_window_slots // 2, self.window_floor)
        return self._adopt(
            pool, st, "shrink", proposed,
            signal={"disengaged": True, "rewindows": 0, "gather_frac": None,
                    "solve_s": None},
            metrics=metrics, log=log,
        )

    def _adopt(self, pool, st, direction, window, *, signal, metrics, log):
        old = st.params
        st.params = dataclasses.replace(old, hot_window_slots=int(window))
        st.source = "online"
        st.cooldown = self.hysteresis  # let the new setting settle
        self.store.put(
            make_entry(
                st.params,
                target=self.target(),
                workload="live",
                pool=pool,
                source="online",
                meta={"direction": direction, **signal},
            )
        )
        adoption = {
            "pool": pool,
            "direction": direction,
            "from": old.hot_window_slots,
            "to": st.params.hot_window_slots,
            "signal": signal,
            "ts": time.time(),
        }
        self.adoptions.append(adoption)
        del self.adoptions[:-ADOPTION_LOG_MAX]
        if metrics is not None and getattr(metrics, "registry", None) is not None:
            metrics.autotune_adjustments.labels(
                pool=pool, direction=direction
            ).inc()
        self._note_gauges(pool, st, metrics)
        if log is not None:
            try:
                log.with_fields(
                    pool=pool, direction=direction,
                    window_from=adoption["from"], window_to=adoption["to"],
                    **{k: v for k, v in signal.items() if v is not None},
                ).info("autotune adopted a hot-window change")
            except Exception:  # noqa: BLE001 - logging is advisory
                pass
        return adoption

    def _note_gauges(self, pool, st, metrics):
        if metrics is None or getattr(metrics, "registry", None) is None:
            return
        metrics.autotune_window_slots.labels(pool=pool).set(
            st.params.hot_window_slots
        )
        metrics.autotune_chunk_loops.labels(pool=pool).set(
            st.params.chunk_loops
        )
        metrics.autotune_store_entries.set(len(self.store))
