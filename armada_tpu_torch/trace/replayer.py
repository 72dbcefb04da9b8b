"""Deterministic replay of recorded rounds + divergence classification.

The replayer reconstructs a recorded round's DeviceRound bit-for-bit
and re-solves it with the port's `solve_round` under any solver spec:

  - "LOCAL"          — the fused single-device solve on the "cuda" path,
                       the hand-written kernels (the service's first
                       rung, `local:cuda`)
  - "cuda", "lax"    — the fused solve on that kernel path
  - "hotwindow[:W]"  — hot-window compacted pass 1 on the "cuda" path
                       (window_min_slots=0 so compaction engages at any
                       scale it can shrink); "lax:hotwindow[:W]" on the
                       "lax" path, as the failover ladder's hotwindow
                       rung runs it
  - "2x2", "4", 4    — the node-sharded mesh solve (parallel/multihost
                       resolve_solver spellings; 2D = HierarchicalDist),
                       on the "cuda" path; "lax:2x2" on the "lax" path

The JAX package's kernel paths ("blocked", "pallas", "native") are not
the port's and are refused by name. Every solve runs on the replay's
`device` (the CUDA card unless the caller asks for the CPU); a mesh spec
puts all its shards on that device.

and compares the decision stream against the recorded one. Divergences
classify as:

  placement          — any decision array differs (placements, evictions,
                       priorities, fair shares, spot price)
  loop_stream        — decisions identical but the pass-1 loop count
                       differs (the solver took a different path to the
                       same answer; kernel-recorded rounds only)
  fairness_ledger    — the fairness block (per-queue share ledger +
                       preemption attribution, observe/fairness.py)
                       recomputed from the round's own DeviceRound and
                       the REPLAYED decisions differs from the recorded
                       block: the replay delivered different shares or
                       attributed preemptions differently (rounds from
                       pre-fairness bundles simply lack the block)
  profile_regression — replayed solve wall clock beyond
                       `profile_threshold` x the recorded solve time
                       (opt-in: wall clocks only compare on one host)
  retrace            — a kernel library was built or loaded during a
                       round whose shape signature was already replayed
                       under the same solver (observe/compiles.py
                       telemetry): a warm cycle must find every library
                       loaded, so any build here is the silent
                       warm-recompile failure mode
  resident_drift     — two-bundle differential only (`diff_traces`): the
                       same scenario recorded under rebuild and under
                       device-resident snapshot mode
                       (snapshot/residency.py) disagrees — a solver
                       input leaf, a decision array, or the fairness
                       block differs between the paired rounds, meaning
                       the delta-applied resident round drifted from
                       the rebuilt-from-jobdb truth

Replay REFUSES a bundle whose target signature (host CPU features,
toolchain and card, x64 mode) differs from this process unless
explicitly overridden: silently diffing against decisions produced by
different arithmetic reports phantom divergences. The override is sound
for x64-recorded traces — exact int64/float64 decisions are
host-independent (the oracle-parity contract) — which is why committed
fixture traces replay everywhere; an x64-mode mismatch always refuses.
The port runs x64 only, so a bundle recorded with x64=False (a JAX
float32 run) always refuses here.

This is the port's copy of the JAX package's trace/replayer.py; it reads
the same `atrace/1` bundles, so either package's recording replays on
the other.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .codec import TraceFormatError, decode_device_round, decode_field, decode_record

_JOB_KEYS = (
    "assigned_node",
    "scheduled_priority",
    "scheduled_mask",
    "preempted_mask",
)
_QUEUE_KEYS = ("fair_share", "demand_capped_fair_share", "uncapped_fair_share")

PERTURBATIONS = ("tiebreak",)


class TraceTargetMismatch(RuntimeError):
    """The bundle was recorded on a different target than this process."""


class CrossPolicyMismatch(RuntimeError):
    """Two bundles recorded under different fairness policies were
    handed to a bit-exact differential: every share and most placements
    legitimately differ, so a drift verdict would be meaningless. Only
    an EXPLICIT policy A/B (allow_cross_policy=True, or
    tools/policy_ab.py which compares scorecards rather than bits) may
    compare across policies."""


def trace_policies(trace: Trace) -> dict:
    """The fairness-policy stamp from a bundle's header (recorder
    config_summary). Pre-policy bundles read as all-DRF."""
    summary = (trace.header or {}).get("config_summary") or {}
    return {
        "default": str(summary.get("fairness_policy_default") or "drf"),
        "pools": {
            str(k): str(v)
            for k, v in (summary.get("fairness_policy_pools") or {}).items()
        },
    }


@dataclasses.dataclass
class RoundRecord:
    raw: dict

    def __getitem__(self, key):
        return self.raw[key]

    @property
    def pool(self) -> str:
        return self.raw.get("pool", "")

    @property
    def num_jobs(self) -> int:
        return int(self.raw["num_jobs"])

    @property
    def num_queues(self) -> int:
        return int(self.raw["num_queues"])

    @property
    def truncated(self) -> bool:
        return bool(self.raw.get("truncated", False))

    @property
    def backend(self) -> str:
        return str(self.raw.get("solver", {}).get("backend", "kernel"))

    def device_round(self):
        return decode_device_round(self.raw["dev"])

    def decisions(self) -> dict:
        return {k: decode_field(v) for k, v in self.raw["decisions"].items()}


@dataclasses.dataclass
class Trace:
    path: str
    header: dict
    rounds: list


def load_trace(path: str) -> Trace:
    header = None
    rounds = []
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            record = decode_record(line)
            kind = record.get("kind")
            if kind == "header":
                if header is not None:
                    raise TraceFormatError(
                        f"{path}:{ln + 1}: second header record — the file "
                        "holds multiple recording sessions appended "
                        "together; later rounds would compare against the "
                        "first session's target/config/seeds. Re-record to "
                        "a fresh bundle (TraceRecorder replaces existing "
                        "files unless append=True)."
                    )
                header = record
                continue
            if kind == "round":
                rounds.append(RoundRecord(record))
                continue
            raise TraceFormatError(f"{path}:{ln + 1}: unknown record kind {kind!r}")
    if header is None:
        raise TraceFormatError(f"{path}: no header record — not an .atrace bundle")
    return Trace(path=path, header=header, rounds=rounds)


def check_target(header: dict, *, allow_foreign: bool = False) -> None:
    """Raise TraceTargetMismatch unless this process matches the
    bundle's recorded target signature (see module docstring)."""
    from .recorder import _target_signature

    recorded = header.get("target") or {}
    current = _target_signature()
    if bool(recorded.get("x64")) != current["x64"]:
        raise TraceTargetMismatch(
            f"trace was recorded with x64={recorded.get('x64')} but this "
            f"process runs x64={current['x64']}: decision arithmetic "
            "differs (approximate float32 vs exact float64 costs) — "
            "replay comparison would be meaningless. Re-record the bundle "
            "with x64 on."
        )
    mismatched = [
        k
        for k in ("host_cpu", "xla")
        if recorded.get(k) is not None and recorded.get(k) != current[k]
    ]
    if mismatched and not allow_foreign:
        detail = ", ".join(
            f"{k}: recorded {recorded.get(k)!r} != current {current[k]!r}"
            for k in mismatched
        )
        raise TraceTargetMismatch(
            f"trace target signature mismatch ({detail}): this bundle was "
            "recorded on a different host/toolchain, so its compiled "
            "decisions may be stale for this target. Pass "
            "allow_foreign=True (--allow-foreign) only for x64-recorded "
            "traces, whose exact decisions are host-independent."
        )


PORT_PATHS = ("cuda", "lax")
REFERENCE_PATHS = ("blocked", "pallas", "native")


def replay_solver(spec, header: dict | None = None, *, device=None):
    """(label, dev -> numpy output dict) for one solver spec string (see
    the module docstring), solving on `device` (the CUDA card unless the
    caller asks for the CPU)."""
    from ..solver.kernel import solve_round

    label = str(spec)
    kl = label.lower()
    path, _, meshspec = kl.partition(":")
    if path in REFERENCE_PATHS:
        raise ValueError(
            f"solver spec {label!r} names a kernel path of the JAX package; "
            f"the port's paths are {', '.join(PORT_PATHS)} (and LOCAL, "
            "hotwindow[:W], a mesh spec, or <path>:<mesh>)"
        )
    if kl == "local":
        path, meshspec = "cuda", ""
    if path in PORT_PATHS and not meshspec:
        return (
            "LOCAL" if kl == "local" else f"kernel:{path}",
            lambda dev: solve_round(
                dataclasses.replace(dev, kernel_path=path), device=device
            ),
        )
    if path == "hotwindow":
        path, meshspec = "cuda", kl
    if meshspec.startswith("hotwindow"):
        _, _, width = meshspec.partition(":")
        if width:
            window = int(width)
        else:
            summary = (header or {}).get("config_summary") or {}
            window = int(summary.get("hot_window_slots") or 0) or max(
                4, 2 * int(summary.get("batch_fill_window") or 2)
            )
        prefix = "" if path == "cuda" else f"kernel:{path}:"
        return (
            f"{prefix}hotwindow:{window}",
            lambda dev: solve_round(
                dataclasses.replace(dev, kernel_path=path),
                window=window, window_min_slots=0, device=device,
            ),
        )
    # Anything else is a mesh spelling ("2x2", "4", an int, a tuple),
    # optionally behind a kernel path ("lax:2x2").
    from ..parallel.mesh import pad_nodes
    from ..parallel.multihost import parse_mesh_spec, resolve_solver

    if path in PORT_PATHS:
        mesh_label, mesh = meshspec, meshspec
    else:
        path, mesh_label, mesh = "cuda", label, spec
    if isinstance(mesh, str) and mesh.isdigit():
        mesh = int(mesh)
    devices = None
    if device is not None:
        devices = [device] * parse_mesh_spec(mesh).n_shards
    run = resolve_solver(mesh, kernel_path=path, devices=devices)

    def solve(dev):
        dev = dataclasses.replace(dev, kernel_path=path)
        out = run(pad_nodes(dev, run.n_shards))
        return {k: np.asarray(v) for k, v in out.items()}

    prefix = "" if path == "cuda" else f"kernel:{path}:"
    return f"{prefix}mesh:{mesh_label}", solve


def perturb_device_round(dev, kind: str):
    """A deliberately-buggy candidate kernel, simulated at the input
    seam: 'tiebreak' reverses the node-id tie-break ranking, the kind
    of silent ordering regression the replay gate exists to catch.
    Placements move wherever two nodes tie on the best-fit key."""
    if kind == "tiebreak":
        rank = np.asarray(dev.node_id_rank)
        return dataclasses.replace(
            dev, node_id_rank=(rank.max() - rank).astype(rank.dtype)
        )
    raise ValueError(f"unknown perturbation {kind!r}; have {PERTURBATIONS}")


def _first_diffs(a, b, limit=4):
    idx = np.flatnonzero(np.asarray(a) != np.asarray(b))[:limit]
    return [int(i) for i in idx]


def compare_fairness(rec: RoundRecord, dev, out: dict):
    """`fairness_ledger` divergence: recompute the canonical fairness
    block from the recorded DeviceRound + the REPLAYED output and diff
    it against the recorded block (both normalized through JSON — the
    recorded one crossed it, and doubles round-trip exactly). Returns a
    divergence dict or None; rounds without a recorded block (pre-
    fairness bundles) always pass."""
    import json

    recorded = rec.raw.get("fairness")
    if not recorded:
        return None
    from ..observe.fairness import ledger_from_device_round

    recomputed = ledger_from_device_round(
        dev, out, rec.num_jobs, rec.num_queues
    )
    want = json.loads(json.dumps(recorded, sort_keys=True))
    got = json.loads(json.dumps(recomputed, sort_keys=True))
    if want == got:
        return None
    details = []
    w_rows = (want.get("ledger") or {}).get("queues", [])
    g_rows = (got.get("ledger") or {}).get("queues", [])
    for q, (a, b) in enumerate(zip(w_rows, g_rows)):
        if a != b:
            fields = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
            details.append(f"queue[{q}] differs on {fields}")
            break
    if want.get("preemptions") != got.get("preemptions"):
        details.append("preemption attribution differs")
    for key in ("jain", "max_regret", "delivered_total"):
        if (want.get("ledger") or {}).get(key) != (got.get("ledger") or {}).get(key):
            details.append(f"{key} differs")
            break
    return {
        "kind": "fairness_ledger",
        "key": "fairness",
        "detail": "replayed fairness ledger diverges from the recorded "
        "block: " + ("; ".join(details) or "structural mismatch"),
    }


def _shape_signature(dev) -> tuple:
    """The (fields, shapes, dtypes) signature that decides
    which kernel libraries and buffer shapes a DeviceRound's solve
    touches. Two rounds with the same signature must replay WITHOUT
    building or loading anything: the first replay of each signature
    warms the libraries, and a build on a later same-signature round is
    an unexpected warm rebuild. Built from the DeviceRound fields, in
    order, as the JAX package's pytree signature is."""
    return tuple(
        (f.name, tuple(v.shape), str(v.dtype)) if hasattr(v, "shape")
        else (f.name, type(v).__name__)
        for f in dataclasses.fields(dev)
        for v in (getattr(dev, f.name),)
    )


def compare_round(rec: RoundRecord, out: dict, *, compare_loops: bool | None = None):
    """Divergences between a recorded round's decisions and a replayed
    output dict. Arrays compare on the UNPADDED prefix (the recorded
    round and the replay may pad differently); returns a list of
    {kind, key, detail} dicts, empty when bit-exact."""
    recorded = rec.decisions()
    J, Q = rec.num_jobs, rec.num_queues
    oracle = rec.backend == "oracle"
    if compare_loops is None:
        # Oracle loop accounting is not the kernel's (the parity suite
        # excludes num_loops); only kernel-recorded rounds pin the stream.
        compare_loops = not oracle
    ids = rec.raw.get("ids") or {}
    job_ids = ids.get("jobs")
    divergences = []
    for key in _JOB_KEYS + _QUEUE_KEYS:
        if key not in recorded or key not in out:
            continue
        n = J if key in _JOB_KEYS else Q
        want = np.asarray(recorded[key])[:n]
        got = np.asarray(out[key])[:n]
        if not np.array_equal(want, got, equal_nan=True):
            where = _first_diffs(want, got)
            detail = f"{key}[:{n}] differs at indices {where}"
            if key in _JOB_KEYS and job_ids:
                names = [job_ids[i] for i in where if i < len(job_ids)]
                detail += f" (jobs {names})"
            divergences.append({"kind": "placement", "key": key, "detail": detail})
    if "spot_price" in recorded and "spot_price" in out and not oracle:
        want = float(np.asarray(recorded["spot_price"]))
        got = float(np.asarray(out["spot_price"]))
        if not (want == got or (np.isnan(want) and np.isnan(got))):
            divergences.append(
                {
                    "kind": "placement",
                    "key": "spot_price",
                    "detail": f"spot_price {want} != {got}",
                }
            )
    if compare_loops and "num_loops" in recorded and "num_loops" in out:
        want = int(np.asarray(recorded["num_loops"]))
        got = int(np.asarray(out["num_loops"]))
        if want != got:
            same = "identical decisions via " if not divergences else ""
            divergences.append(
                {
                    "kind": "loop_stream",
                    "key": "num_loops",
                    "detail": f"{same}a different loop stream: recorded "
                    f"{want} loops, replayed {got}",
                }
            )
    return divergences


def _diff_device_rounds(dev_a, dev_b) -> list[str]:
    """Field names (with a short detail) where two padded DeviceRounds
    are not bit-identical. NaNs compare by bits, so a NaN payload equal
    on both sides does NOT read as drift."""
    diffs = []
    for f in dataclasses.fields(dev_a):
        a, b = getattr(dev_a, f.name), getattr(dev_b, f.name)
        if hasattr(a, "shape") or hasattr(b, "shape"):
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape or a.dtype != b.dtype:
                diffs.append(
                    f"{f.name}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"
                )
                continue
            ab, bb = a.tobytes(), b.tobytes()
            if ab != bb:
                raw = np.flatnonzero(
                    np.frombuffer(ab, np.uint8) != np.frombuffer(bb, np.uint8)
                )
                first = int(raw[0] // max(1, a.itemsize))
                diffs.append(f"{f.name}: first differing element flat[{first}]")
        else:
            same = a == b
            try:
                same = bool(same) or (np.isnan(a) and np.isnan(b))
            except (TypeError, ValueError):
                same = bool(same)
            if not same:
                diffs.append(f"{f.name}: {a!r} != {b!r}")
    return diffs


def diff_traces(
    trace_a: Trace,
    trace_b: Trace,
    *,
    max_rounds: int | None = None,
    allow_cross_policy: bool = False,
    log=None,
) -> dict:
    """Two-bundle differential: pair rounds of two recordings of the
    SAME scenario by (pool, cycle) and diff each pair bit-for-bit —
    every DeviceRound leaf the solver consumed, the unpadded decision
    stream (including num_loops and spot_price), and the fairness
    block. The intended use is the residency correctness gate: record
    one run with `snapshot_mode="incremental"` (rebuild/re-upload every
    cycle) and one with `snapshot_mode="resident"` (delta scatter
    updates into persistent device buffers); any difference means the
    delta-applied round drifted from the rebuilt truth and classifies
    as `resident_drift`. Rounds present in only one bundle are listed
    under "unmatched" and fail the gate too — a cycle that solved under
    one mode but not the other is itself a divergence.

    Returns {"pairs", "unmatched", "results", "divergences", "ok"}.

    Refuses bundles whose recorded fairness policies differ (header
    pinning): a cross-policy diff legitimately diverges everywhere, so
    the drift verdict means nothing. allow_cross_policy=True is the
    explicit A/B escape hatch (the result then carries both policy
    stamps); scorecard-level comparison lives in tools/policy_ab.py.
    """
    import json

    pol_a, pol_b = trace_policies(trace_a), trace_policies(trace_b)
    cross_policy = pol_a != pol_b
    if cross_policy and not allow_cross_policy:
        raise CrossPolicyMismatch(
            f"bundle {trace_a.path} was recorded under fairness policies "
            f"{pol_a} but {trace_b.path} under {pol_b}: a bit-exact "
            "differential across policies is meaningless. Pass "
            "allow_cross_policy=True only for an explicit policy A/B, "
            "or compare scorecards with tools/policy_ab.py."
        )

    def index(trace):
        by_key = {}
        for rec in trace.rounds:
            cyc = rec.raw.get("cycle")
            key = (rec.pool, cyc if cyc is not None else rec.raw.get("i"))
            by_key.setdefault(key, []).append(rec)
        return by_key

    a_idx, b_idx = index(trace_a), index(trace_b)
    unmatched = sorted(
        f"{pool}@cycle={cyc}"
        for pool, cyc in set(a_idx) ^ set(b_idx)
    )
    results = []
    by_kind: dict[str, int] = {}
    pairs = 0
    for key in sorted(set(a_idx) & set(b_idx), key=lambda k: (str(k[0]), str(k[1]))):
        for rec_a, rec_b in zip(a_idx[key], b_idx[key]):
            if max_rounds is not None and pairs >= max_rounds:
                break
            pairs += 1
            divergences = []
            for d in _diff_device_rounds(rec_a.device_round(), rec_b.device_round()):
                divergences.append(
                    {
                        "kind": "resident_drift",
                        "key": "dev",
                        "detail": f"solver input differs: {d}",
                    }
                )
            dec_a, dec_b = rec_a.decisions(), rec_b.decisions()
            J, Q = rec_a.num_jobs, rec_a.num_queues
            for dk in _JOB_KEYS + _QUEUE_KEYS + ("num_loops", "spot_price"):
                if dk not in dec_a or dk not in dec_b:
                    if dk in dec_a or dk in dec_b:
                        divergences.append(
                            {
                                "kind": "resident_drift",
                                "key": dk,
                                "detail": f"{dk} recorded in one bundle only",
                            }
                        )
                    continue
                n = J if dk in _JOB_KEYS else Q if dk in _QUEUE_KEYS else None
                want = np.asarray(dec_a[dk])[:n] if n else np.asarray(dec_a[dk])
                got = np.asarray(dec_b[dk])[:n] if n else np.asarray(dec_b[dk])
                if not np.array_equal(want, got, equal_nan=True):
                    divergences.append(
                        {
                            "kind": "resident_drift",
                            "key": dk,
                            "detail": f"decision {dk} differs at indices "
                            f"{_first_diffs(want, got)}",
                        }
                    )
            fair_a = json.loads(json.dumps(rec_a.raw.get("fairness"), sort_keys=True))
            fair_b = json.loads(json.dumps(rec_b.raw.get("fairness"), sort_keys=True))
            if fair_a != fair_b:
                divergences.append(
                    {
                        "kind": "resident_drift",
                        "key": "fairness",
                        "detail": "fairness ledger differs between bundles",
                    }
                )
            for d in divergences:
                by_kind[d["kind"]] = by_kind.get(d["kind"], 0) + 1
            results.append(
                {
                    "pool": key[0],
                    "cycle": key[1],
                    "solver_a": rec_a.raw.get("solver"),
                    "solver_b": rec_b.raw.get("solver"),
                    "divergences": divergences,
                }
            )
            if log:
                status = "OK" if not divergences else (
                    "DRIFT " + "; ".join(d["detail"] for d in divergences)
                )
                log(f"pool={key[0]} cycle={key[1]}: {status}")
    ok = not by_kind and not unmatched
    out = {
        "trace_a": trace_a.path,
        "trace_b": trace_b.path,
        "pairs": pairs,
        "unmatched": unmatched,
        "results": results,
        "divergences": by_kind,
        "ok": ok,
    }
    if cross_policy:
        out["cross_policy"] = True
        out["policy_a"] = pol_a
        out["policy_b"] = pol_b
    return out


def replay_trace(
    trace: Trace,
    *,
    solvers=("LOCAL",),
    max_rounds: int | None = None,
    profile_threshold: float | None = None,
    perturb: str | None = None,
    allow_foreign: bool = False,
    flag_retraces: bool = True,
    metrics=None,
    log=None,
    device=None,
) -> dict:
    """Replay a bundle under each solver spec; returns the gate report:

      {"rounds": n_replayed, "skipped": n, "results": [...],
       "divergences": {kind: count}, "ok": bool}

    Truncated rounds are skipped (a budget-cut decision stream is a
    wall-clock-dependent prefix, not a deterministic target). `metrics`
    (services.metrics.SchedulerMetrics) gets the replay-divergence
    counter bumped per divergence kind. Every solve runs on `device`
    (the CUDA card unless the caller asks for the CPU)."""
    check_target(trace.header, allow_foreign=allow_foreign)
    from ..observe.compiles import TELEMETRY

    # Warm-rebuild audit (flag_retraces): the first replay of each
    # round-shape signature per solver warms the kernel libraries; any
    # build or load on a LATER round with an already-seen signature is
    # classified `retrace` — the silent warm-cycle compile the
    # observatory exists to catch.
    telemetry_live = flag_retraces
    seen_shapes: dict[str, set] = {}
    resolved = [replay_solver(s, trace.header, device=device) for s in solvers]
    results = []
    by_kind: dict[str, int] = {}
    replayed = skipped = 0
    for rec in trace.rounds:
        if max_rounds is not None and replayed >= max_rounds:
            break
        if rec.truncated:
            skipped += 1
            if log:
                log(f"round {rec.raw.get('i')}: skipped (budget-truncated)")
            continue
        dev = rec.device_round()
        if perturb:
            dev = perturb_device_round(dev, perturb)
        replayed += 1
        for label, solve in resolved:
            warm = False
            if telemetry_live:
                sig = _shape_signature(dev)
                warm = sig in seen_shapes.setdefault(label, set())
                # Thread-scoped: a concurrent solve elsewhere in the
                # process must not read as this round's retrace.
                comp0 = TELEMETRY.thread_snapshot()
            t0 = time.monotonic()
            out = solve(dev)
            replay_s = time.monotonic() - t0
            divergences = compare_round(rec, out)
            fairness_div = compare_fairness(rec, dev, out)
            if fairness_div is not None:
                divergences.append(fairness_div)
            if telemetry_live:
                delta = TELEMETRY.delta_since(comp0, thread=True)
                seen_shapes[label].add(sig)
                if warm and (delta["compiles"] or delta["traces"]):
                    divergences.append(
                        {
                            "kind": "retrace",
                            "key": "xla",
                            "detail": "warm shape rebuilt: "
                            f"{delta['traces']} load(s), "
                            f"{delta['compiles']} compile(s) "
                            f"({delta['compile_seconds']}s) on an "
                            "already-replayed round signature",
                        }
                    )
            if profile_threshold and rec.raw.get("solve_s") is not None:
                # The first solve of a (solver, shape) pays the build;
                # the recorded solve_s is a warm steady-state number. Time
                # a SECOND solve so the comparison is warm-vs-warm, and
                # floor tiny recorded times so sub-ms rounds don't trip
                # on scheduler noise.
                t1 = time.monotonic()
                solve(dev)
                warm_s = time.monotonic() - t1
                base = max(float(rec.raw["solve_s"]), 0.01)
                if warm_s > base * profile_threshold:
                    divergences.append(
                        {
                            "kind": "profile_regression",
                            "key": "solve_s",
                            "detail": f"warm replay {warm_s:.3f}s > "
                            f"{profile_threshold:.2f}x recorded "
                            f"{base:.3f}s",
                        }
                    )
            for d in divergences:
                by_kind[d["kind"]] = by_kind.get(d["kind"], 0) + 1
                if (
                    metrics is not None
                    and getattr(metrics, "registry", None) is not None
                ):
                    metrics.trace_replay_divergences.labels(kind=d["kind"]).inc()
            results.append(
                {
                    "round": rec.raw.get("i"),
                    "pool": rec.pool,
                    "solver": label,
                    "replay_s": round(replay_s, 4),
                    "divergences": divergences,
                }
            )
            if log:
                status = "OK" if not divergences else (
                    "DIVERGED " + "; ".join(d["detail"] for d in divergences)
                )
                log(
                    f"round {rec.raw.get('i')} pool={rec.pool} "
                    f"solver={label}: {status}"
                )
    return {
        "trace": trace.path,
        "rounds": replayed,
        "skipped": skipped,
        "results": results,
        "divergences": by_kind,
        "ok": not by_kind,
    }
