"""Offline parameter search over a flight-recorder corpus.

The tuner replays every (untruncated) recorded round through
`solver/kernel.solve_round` once per candidate parameter vector, on the
"cuda" kernel path (the hand-written fill kernels, as the scheduler's
`local:cuda` rung runs them) and on `device` (the CUDA card unless the
caller asks for the CPU),
REQUIRING the decision stream to stay bit-exact with the recording
(the `trace/replayer.compare_round` contract — placements, evictions,
priorities, shares, spot price, and the pass-1 loop count on
kernel-recorded rounds), then times warm re-solves of the whole corpus
per candidate and selects the fastest qualifying vector. A candidate
that diverges anywhere is disqualified outright: a tuning that buys
speed by changing placements is a broken kernel, not a tuning.

The static-config baseline (the bundle header's config summary) is
always measured alongside the grid, so the report states exactly what
the selected vector buys on this host — and ties go to the baseline
(candidates are measured in order, baseline first, and selection is a
strict improvement), so noise can never flip production config for
nothing.

The selected vector is emitted as a tuning-store entry keyed by this
process's target signature and the corpus's workload fingerprint
(`tools/autotune.py` writes it as a store-format JSON profile that
`SchedulingConfig.autotune_profile` loads at boot).

Timing: every solve returns its decisions as host arrays
(`solve_round`'s readback of the decision stream), so each timed corpus
pass ends with the card synchronised behind its last round.

This is the port's copy of the JAX package's autotune/offline.py; it
checks candidates with the port's `trace/replayer.compare_round`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import statistics
import time

from ..core.config import HOT_WINDOW_MIN_SLOTS_DEFAULT
from .store import TunedParams, current_target, make_entry

# The default candidate windows: the pow2 buckets around the shipped
# hotWindowSlots default (4096), each paired with the shipped
# engagement floor. Small corpora (fixtures) pass explicit tiny grids.
DEFAULT_WINDOWS = (1024, 2048, 4096, 8192, 16384)


def default_grid(
    windows=DEFAULT_WINDOWS,
    min_slots=(HOT_WINDOW_MIN_SLOTS_DEFAULT,),
    chunks=(1,),
) -> list[TunedParams]:
    return [
        TunedParams(int(w), int(m), max(1, int(c)))
        for w in windows
        for m in min_slots
        for c in chunks
    ]


def workload_fingerprint(traces) -> str:
    """Stable digest of what the corpus IS: per-round pool/shape
    signature plus each bundle's config fingerprint. Two corpora with
    the same fingerprint exercise the same solve regime, so a tuned
    profile keyed by it transfers between them."""
    sig = []
    for trace in traces:
        for rec in trace.rounds:
            sig.append([rec.pool, int(rec.num_jobs), int(rec.num_queues)])
    sig.sort()
    sig.append([str(t.header.get("config_fingerprint")) for t in traces])
    return hashlib.sha256(json.dumps(sig).encode()).hexdigest()[:16]


def baseline_params(traces) -> TunedParams:
    """The static-config vector recorded in the corpus headers (older
    bundles predate the min-slots summary key — the shipped default
    applies, exactly what the scheduler would have run)."""
    summary = (traces[0].header.get("config_summary") or {}) if traces else {}
    return TunedParams(
        hot_window_slots=int(summary.get("hot_window_slots") or 0),
        hot_window_min_slots=int(
            summary.get("hot_window_min_slots", HOT_WINDOW_MIN_SLOTS_DEFAULT)
        ),
        chunk_loops=1,
    )


def _corpus_rounds(traces, max_rounds):
    rounds = []
    for trace in traces:
        for rec in trace.rounds:
            if rec.truncated:
                # A budget-cut decision stream is a wall-clock-dependent
                # prefix, not a deterministic target (replayer contract).
                continue
            rounds.append(rec)
            if max_rounds is not None and len(rounds) >= max_rounds:
                return rounds
    return rounds


def tune_corpus(
    traces,
    candidates,
    *,
    max_rounds: int | None = None,
    repeats: int = 3,
    allow_foreign: bool = False,
    pool: str | None = None,
    log=None,
    device=None,
) -> dict:
    """Search `candidates` (TunedParams) over the corpus; returns

      {"rounds": n, "workload": fp, "results": [...], "selected": entry,
       "baseline": {...}, "ok": bool}

    Every solve runs on `device`, on the "cuda" path.
    `selected` is a tuning-store entry (store.make_entry) for the
    fastest bit-exact candidate — the baseline itself when nothing
    strictly beats it. ok=False when ANY candidate (baseline included)
    diverged: that is a solver bug the replay gate must hear about,
    not a tuning outcome.
    """
    from ..solver.kernel import solve_round
    from ..trace.replayer import check_target, compare_round

    for trace in traces:
        check_target(trace.header, allow_foreign=allow_foreign)
    # One corpus = one recorded config: the baseline vector (and the
    # ties-to-baseline protection) is read from the bundle headers, so
    # bundles recorded under different configs would get a baseline
    # some of their rounds never ran statically. Tune them separately.
    fingerprints = {t.header.get("config_fingerprint") for t in traces}
    if len(fingerprints) > 1:
        raise ValueError(
            "corpus mixes bundles recorded under different scheduling "
            f"configs ({sorted(str(f) for f in fingerprints)}): the "
            "static-config baseline would be wrong for some rounds — "
            "tune each bundle separately"
        )
    rounds = _corpus_rounds(traces, max_rounds)
    if not rounds:
        raise ValueError("no replayable rounds in the corpus")
    devs = [
        dataclasses.replace(rec.device_round(), kernel_path="cuda")
        for rec in rounds
    ]

    base = baseline_params(traces)
    # Rounds recorded while an online controller was active were solved
    # with ITS vector, not the header config's — the "baseline" row is
    # then hypothetical (a vector those rounds never ran statically).
    # Surfaced rather than refused: the timings are still valid, only
    # the baseline label needs the caveat.
    autotuned_rounds = sum(
        1 for rec in rounds if (rec.raw.get("solver") or {}).get("autotuned")
    )
    labeled = [("baseline", base)]
    for params in candidates:
        if params == base:
            continue  # already measured as the baseline
        labeled.append((f"w{params.hot_window_slots}"
                        f"@{params.hot_window_min_slots}"
                        f"c{params.chunk_loops}", params))

    results = []
    for label, params in labeled:
        def solve(dev, params=params):
            return solve_round(
                dev,
                window=params.hot_window_slots or None,
                window_min_slots=params.hot_window_min_slots,
                chunk_loops=params.chunk_loops,
                device=device,
            )

        divergences = []
        for rec, dev in zip(rounds, devs):
            # The first solve per shape pays any kernel build and the
            # allocator's growth — it doubles as the bit-exactness check
            # so timing below is warm-vs-warm.
            out = solve(dev)
            divs = compare_round(rec, out)
            if divs:
                divergences.append(
                    {"round": rec.raw.get("i"), "divergences": divs}
                )
        wall_s = None
        if not divergences:
            times = []
            for _ in range(max(1, repeats)):
                t0 = time.monotonic()
                for dev in devs:
                    solve(dev)
                times.append(time.monotonic() - t0)
            wall_s = statistics.median(times)
        result = {
            "label": label,
            "params": params.as_dict(),
            "bit_exact": not divergences,
            "wall_s": None if wall_s is None else round(wall_s, 4),
            "divergences": divergences,
        }
        results.append(result)
        if log:
            status = (
                f"{wall_s:.4f}s" if wall_s is not None
                else f"DIVERGED x{len(divergences)}"
            )
            log(f"{label}: {status}")

    qualifying = [r for r in results if r["bit_exact"]]
    base_result = results[0]
    selected_result = base_result if base_result["bit_exact"] else None
    for r in qualifying:
        # Strictly faster only: measurement noise must not displace the
        # operator's static config for an equal-speed candidate.
        if selected_result is None or r["wall_s"] < selected_result["wall_s"]:
            selected_result = r
    selected = None
    if selected_result is not None:
        fp = workload_fingerprint(traces)
        pools = {rec.pool for rec in rounds}
        entry_pool = pool or (pools.pop() if len(pools) == 1 else "*")
        selected = make_entry(
            TunedParams.from_dict(selected_result["params"]),
            target=current_target(),
            workload=fp,
            pool=entry_pool,
            source="offline",
            baseline_s=base_result["wall_s"],
            tuned_s=selected_result["wall_s"],
            meta={
                "rounds": len(rounds),
                "traces": [t.path for t in traces],
                "label": selected_result["label"],
            },
        )
    if autotuned_rounds and log:
        log(
            f"note: {autotuned_rounds}/{len(rounds)} round(s) were "
            "recorded with online autotuning active — the 'baseline' "
            "row times the header's static config, which those rounds "
            "did not actually run"
        )
    return {
        "rounds": len(rounds),
        "workload": workload_fingerprint(traces),
        "autotuned_rounds": autotuned_rounds,
        "results": results,
        "baseline": base_result,
        "selected": selected,
        "ok": all(r["bit_exact"] for r in results),
    }
