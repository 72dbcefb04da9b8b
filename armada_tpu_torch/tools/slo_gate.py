"""SLO gate: evaluate a recorded run against declared latency SLOs.

The port's counterpart of the JAX package's `tools/slo_gate.py`. It
replays a run's latency observations through the SLO tracker
(armada_tpu_torch/services/slo.py) and exits non-zero when any declared
objective is breached.

Inputs (repeatable, mixed):

  - `.atrace` flight-recorder bundles, recorded by either package: every
    recorded round becomes a `round_seconds` observation (its recorded
    solve_s less any kernel build inside it, timestamped by the round's
    virtual `now` when present);
  - observation documents: {"observations": [{"signal", "value",
    "now"}]}.

The JAX package's gate also reads its bench artifacts; the port's bench
is not written yet, so any other document is unusable here.

SLO declarations come from --config (a scheduling YAML with an `slos:`
block), defaulting to services/slo.DEFAULT_SLOS; `--override
NAME=THRESHOLD[:OBJECTIVE]` tightens one in place:

    python -m armada_tpu_torch.tools.slo_gate tests/fixtures/sim_steady.atrace
    python -m armada_tpu_torch.tools.slo_gate tests/fixtures/sim_steady.atrace \
        --override round-latency=1e-6   # exits 1

Exit codes: 0 = every SLO met, 1 = breach, 2 = unusable (no
observations decoded / unknown override / unreadable input).
"""

from __future__ import annotations

import argparse
import json


def observations_from_atrace(path: str) -> list[tuple[str, float, float]]:
    """(signal, value, now) per recorded round. Rounds without a
    virtual `now` (bench-recorded bundles) index sequentially so burn
    windows still have an ordering."""
    from ..trace import load_trace

    trace = load_trace(path)
    out = []
    for i, rec in enumerate(trace.rounds):
        profile = rec.raw.get("profile") or {}
        solve_s = rec.raw.get("solve_s")
        if solve_s is None:
            # Older bundles: fall back to the profile's segment sum.
            solve_s = sum(
                float(profile.get(f"{seg}_s", 0.0))
                for seg in ("setup", "pass1", "gather", "finish")
            ) or None
        if solve_s is None:
            continue
        # Rounds recorded with compile telemetry (the observatory
        # header): gate the WARM cost — a one-time build inside a
        # recorded solve is not the round latency users feel at steady
        # state (and the gate would otherwise fail every bundle whose
        # first round paid a cold build).
        compiles = profile.get("compiles") or {}
        solve_s = max(
            0.0, float(solve_s) - float(compiles.get("compile_seconds", 0.0))
        )
        now = rec.raw.get("now")
        out.append(
            ("round_seconds", float(solve_s),
             float(now) if now is not None else float(i))
        )
    return out


def observations_from_doc(doc: dict) -> list[tuple[str, float, float]]:
    """Observations out of an explicit observations document."""
    out = []
    if not isinstance(doc.get("observations"), list):
        raise ValueError("not an observations document")
    for i, o in enumerate(doc["observations"]):
        try:
            out.append((str(o["signal"]), float(o["value"]), float(o.get("now", i))))
        except (KeyError, TypeError, ValueError):
            continue
    return out


def apply_overrides(slos, overrides: list[str]):
    """NAME=THRESHOLD[:OBJECTIVE] replacements; raises ValueError on an
    unknown name (a typo must not silently gate nothing)."""
    import dataclasses

    by_name = {s.name: s for s in slos}
    for spec in overrides:
        name, _, rest = spec.partition("=")
        if name not in by_name:
            raise ValueError(
                f"--override {spec!r}: no declared SLO named {name!r} "
                f"(have {sorted(by_name)})"
            )
        threshold, _, objective = rest.partition(":")
        changes = {"threshold_s": float(threshold)}
        if objective:
            changes["objective"] = float(objective)
        by_name[name] = dataclasses.replace(by_name[name], **changes)
    return tuple(by_name.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("inputs", nargs="+",
                    help=".atrace bundles or observation JSON documents")
    ap.add_argument("--config", default=None,
                    help="scheduling YAML declaring an slos: block "
                    "(default: the built-in DEFAULT_SLOS)")
    ap.add_argument("--override", action="append", default=[],
                    metavar="NAME=THRESHOLD[:OBJECTIVE]",
                    help="tighten/replace one declared SLO in place "
                    "(repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON line")
    args = ap.parse_args(argv)

    from ..services.slo import DEFAULT_SLOS, SLOTracker

    slos = DEFAULT_SLOS
    if args.config:
        from ..core.config import load_config

        slos = load_config(args.config).slos or DEFAULT_SLOS
    try:
        slos = apply_overrides(slos, args.override)
    except ValueError as e:
        print(f"slo_gate: {e}")
        return 2

    observations: list[tuple[str, float, float]] = []
    for path in args.inputs:
        try:
            if path.endswith(".atrace"):
                observations += observations_from_atrace(path)
            else:
                with open(path) as f:
                    observations += observations_from_doc(json.load(f))
        except Exception as e:  # noqa: BLE001 - unusable input is exit 2
            print(f"slo_gate: cannot read {path}: {e}")
            return 2
    if not observations:
        print("slo_gate: no SLO observations decoded from the inputs")
        return 2

    tracker = SLOTracker(slos)
    # Burn windows need time order however many inputs were mixed.
    observations.sort(key=lambda o: o[2])
    for signal, value, now in observations:
        tracker.observe(signal, value, now=now)
    report = tracker.evaluate(now=observations[-1][2])
    report["observations"] = len(observations)
    if args.json:
        print(json.dumps(report))
    else:
        for s in report["slos"]:
            if not s["observed"]:
                continue
            print(
                f"{s['name']}: {s['good']}/{s['observed']} good "
                f"(compliance {s['compliance']:.4f} vs objective "
                f"{s['objective']}) on {s['signal']} <= "
                f"{s['threshold_s']}s"
            )
        for line in report["breaches"]:
            print("BREACH " + line)
        verdict = "OK" if report["ok"] else "BREACHED"
        print(
            f"slo_gate: {len(observations)} observation(s) across "
            f"{len(args.inputs)} input(s): {verdict}"
        )
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
