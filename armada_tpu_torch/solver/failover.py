"""Solver backend failover ladder: retry a failed round down-backend.

A round that raises, hangs past its budget, or fails the admission
firewall (solver/validate.py) is retried WITHIN the same cycle down a
configured ladder of backends. Which ladder depends on where the
service solves.

On the CUDA card (the default device) the ladder stays on the card and
on the configured kernel path, with `solve_kernel_path="cuda"`:

    mesh:<spec>  ->  local:cuda

(`mesh:<spec>` only when the service has a mesh.) There is no rung on
the "lax" path and none on the host: a round that fails on its last
rung (a kernel that fails to build or launch, a CUDA error, device
lost, OOM, a rejected output) is rejected with its cause recorded, and
its work stays queued for the next cycle. So a kernel fault can never
hide behind a plain-path or host solve.

On the CPU (`device="cpu"`, as the parity tests run it) the kernel
backend keeps the JAX package's full ladder, with the port's rungs:

    mesh:<spec>  ->  local:cuda  ->  LOCAL  ->  hotwindow:64  ->  oracle

(`local:cuda` there runs the kernels' plain versions, as every wrapper
does on a CPU tensor; LOCAL and hotwindow the "lax" path.)

Each rung carries a per-backend circuit breaker (services/chaos.py's
CircuitBreaker, the PR-1 class, driven on the ROUND counter instead of
wall clock): `failure_threshold` consecutive failures open the rung and
it is skipped for `solverFailoverCooldown` rounds; after the cooldown
the rung goes half-open and is re-probed via a SHADOW solve — the live
round runs on a healthy rung while the probe's output is validated and
discarded — so a flaky backend earns its way back without ever touching
a committed placement. The TERMINAL rung (the oracle on the CPU's
ladder, `local:<path>` on the card's) is always allowed even with its
breaker open; with it the ladder can only fail a round by rejection,
never by having nowhere left to run.

Failovers carry attribution into round spans, job timelines, and
`scheduler_solver_failover_total{from,to,cause}`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import DEFAULT_DEVICE

_STATE_CODE = {"closed": 0, "half-open": 1, "open": 2}


@dataclass(frozen=True)
class Rung:
    """One ladder entry. kind: "mesh" | "local" | "hotwindow" | "oracle";
    param is the mesh spec (mesh) or the forced window size (hotwindow)."""

    kind: str
    label: str
    param: object = None


def build_ladder(backend: str, mesh, config, *, device) -> tuple:
    """The rung sequence for a scheduler's configured solve path,
    primary first. `device` is the service's: None or a CUDA device
    gives the card's ladder, which ends on the configured kernel path;
    any other device (the CPU) the full ladder down to the oracle."""
    rungs = []
    if backend == "kernel":
        if mesh is not None:
            rungs.append(Rung("mesh", f"mesh:{mesh}", mesh))
        # A configured non-lax solve kernel path (ops/kernels.py: "cuda"
        # runs the hand-written kernels) is its own rung ABOVE plain
        # LOCAL (the plain LOCAL / hotwindow rungs below force lax).
        kpath = str(getattr(config, "solve_kernel_path", "lax") or "lax")
        if kpath == "lax":
            rungs.append(Rung("local", "LOCAL"))
        else:
            rungs.append(Rung("local", f"local:{kpath}", kpath))
        if torch.device(DEFAULT_DEVICE if device is None else device).type == "cuda":
            # The card's ladder ends here: a round that fails on the
            # configured path is rejected and requeued, never re-solved
            # on the plain path or the host.
            return tuple(rungs)
        if kpath != "lax":
            rungs.append(Rung("local", "LOCAL"))
        # A degraded retry on a DIFFERENT solve program: a forced small
        # hot window (fixed, independent of the configured size) runs
        # pass 1 over a compacted round.
        rungs.append(Rung("hotwindow", "hotwindow:64", 64))
    rungs.append(Rung("oracle", "oracle"))
    return tuple(rungs)


class FailoverLadder:
    """Breaker-gated rung selection, clocked on the round counter."""

    def __init__(self, rungs, *, failure_threshold: int = 3,
                 cooldown_rounds: int = 8):
        from ..services.chaos import CircuitBreaker

        self.rungs = tuple(rungs)
        if not self.rungs:
            raise ValueError("failover ladder needs at least one rung")
        self.cooldown_rounds = max(1, int(cooldown_rounds))
        # cooldown_s is denominated in ROUNDS: every query passes the
        # cycle counter as `now`, so "seconds" of cooldown are rounds.
        self.breaker = CircuitBreaker(
            failure_threshold=failure_threshold,
            cooldown_s=float(self.cooldown_rounds),
        )

    def plan(self, cycle: int) -> tuple:
        """(live, probes) for this round: `live` is the ordered rung
        list the round may solve on (closed breakers, terminal rung
        always included last); `probes` are half-open rungs granted
        their one shadow probe this round."""
        live = []
        probes = []
        for rung in self.rungs[:-1]:
            state = self.breaker.state(rung.label, now=float(cycle))
            if state == "closed":
                live.append(rung)
            elif state == "half-open" and self.breaker.allow(
                rung.label, now=float(cycle)
            ):
                probes.append(rung)
        live.append(self.rungs[-1])  # terminal fallback, breaker or not
        return live, probes

    def record_success(self, label: str, cycle: int) -> None:
        self.breaker.record_success(label)

    def record_failure(self, label: str, cycle: int) -> None:
        self.breaker.record_failure(label, now=float(cycle))

    def state(self, label: str, cycle: int) -> str:
        return self.breaker.state(label, now=float(cycle))

    def snapshot(self, cycle: int) -> list:
        """Per-rung breaker view for the doctor surfaces (`armadactl
        doctor`, GET /api/doctor)."""
        out = []
        for i, rung in enumerate(self.rungs):
            state = self.breaker.state(rung.label, now=float(cycle))
            failures = self.breaker.failures(rung.label)
            out.append(
                {
                    "rung": rung.label,
                    "kind": rung.kind,
                    "state": state,
                    "state_code": _STATE_CODE[state],
                    "consecutive_failures": int(failures),
                    "terminal": i == len(self.rungs) - 1,
                }
            )
        return out
