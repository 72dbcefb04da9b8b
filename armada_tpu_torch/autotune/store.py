"""The persisted tuning store: which solver parameters run where.

One entry = one tuned parameter vector for one (target signature,
workload fingerprint, pool) key. Entries come from two producers:

  - the OFFLINE tuner (`autotune/offline.py`, `tools/autotune.py`):
    a corpus search over recorded `.atrace` rounds, keyed by the
    corpus's workload fingerprint with pool "*" unless every round
    belongs to one pool;
  - the ONLINE controller (`autotune/controller.py`): hill-climb
    adoptions from the live solve profile, keyed per pool with
    workload "live".

Lookup is target-exact (host CPU features + the torch and CUDA
toolchain with the card and its power limit + x64 mode, the same
signature the flight recorder refuses foreign bundles on,
`trace/recorder.py::_target_signature`): parameters tuned on different arithmetic or a different toolchain
say nothing about this host. Within a target, a pool-specific entry
beats a wildcard one and newer beats older — so an online adoption
supersedes the offline profile it started from, and both survive a
restart through `services/checkpoint.CheckpointStore` (the control
plane saves `store.dump()` alongside the view checkpoints; the store
is NOT a registered log view because it consumes no events and must
never hold back log compaction). The workload fingerprint keys
storage and provenance, not live adoption: the scheduler cannot know
its upcoming workload's fingerprint at boot, so it adopts the newest
target+pool match and lets the online controller adapt from there —
loading only the profile tuned for the deployment's workload is the
operator's lever (`autotuneProfile`).

Every knob in a TunedParams vector is perf-only BY CONSTRUCTION:
`hot_window_slots` / `hot_window_min_slots` select how much of the
round the compacted pass-1 driver gathers per chunk (bit-exact with
the uncompacted kernel, tests/test_torch_hotwindow.py), and
`chunk_loops` only sets the budgeted driver's starting host-sync stride.
Placement can never depend on a store entry.

This is the port's copy of the JAX package's autotune/store.py; the
entry and file formats are the same.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time

FORMAT = 1


@dataclasses.dataclass(frozen=True)
class TunedParams:
    """One perf-only solver parameter vector (see module docstring)."""

    hot_window_slots: int
    hot_window_min_slots: int = 0
    chunk_loops: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "TunedParams":
        return TunedParams(
            hot_window_slots=int(d.get("hot_window_slots", 0)),
            hot_window_min_slots=int(d.get("hot_window_min_slots", 0)),
            chunk_loops=max(1, int(d.get("chunk_loops", 1) or 1)),
        )

    @staticmethod
    def from_config(config) -> "TunedParams":
        """The static-config vector — the baseline every tuned vector is
        measured against and the fallback when the store has nothing."""
        return TunedParams(
            hot_window_slots=int(getattr(config, "hot_window_slots", 0) or 0),
            hot_window_min_slots=int(
                getattr(config, "hot_window_min_slots", 0) or 0
            ),
            chunk_loops=1,
        )


def target_digest(target: dict) -> str:
    """Stable digest of a target signature dict (recorder's
    host_cpu/xla/x64 triple; the port's "xla" names its torch and CUDA
    toolchain and card). Tolerates extra keys."""
    canon = json.dumps(
        {
            "host_cpu": target.get("host_cpu"),
            "xla": target.get("xla"),
            "x64": bool(target.get("x64")),
        },
        sort_keys=True,
    )
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def current_target() -> dict:
    """This process's target signature (shared with the flight
    recorder, so a trace and a tuned profile recorded together key
    identically)."""
    from ..trace.recorder import _target_signature

    return _target_signature()


def make_entry(
    params: TunedParams,
    *,
    target: dict | str,
    workload: str,
    pool: str = "*",
    source: str = "offline",
    baseline_s: float | None = None,
    tuned_s: float | None = None,
    meta: dict | None = None,
    created: float | None = None,
) -> dict:
    return {
        "target": target if isinstance(target, str) else target_digest(target),
        "workload": workload,
        "pool": pool or "*",
        "params": params.as_dict(),
        "source": source,
        "baseline_s": baseline_s,
        "tuned_s": tuned_s,
        "meta": dict(meta or {}),
        "created": time.time() if created is None else created,
    }


class TuningStore:
    """In-memory entry map with JSON/checkpoint round-trips."""

    def __init__(self):
        self._entries: dict[str, dict] = {}

    @staticmethod
    def key(entry: dict) -> str:
        return (
            f"{entry['target']}/{entry.get('pool') or '*'}/"
            f"{entry.get('workload') or '*'}"
        )

    def put(self, entry: dict) -> str:
        key = self.key(entry)
        self._entries[key] = dict(entry)
        return key

    def entries(self) -> list[dict]:
        return list(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(
        self, target: dict | str, pool: str, workload: str | None = None
    ) -> dict | None:
        """Best entry for this target + pool: pool-specific beats the
        "*" wildcard, then an exact `workload` fingerprint match (when
        the caller knows one — tools and tests do; the live scheduler
        does NOT, its workload's fingerprint is unknowable before it
        solves), then newest `created` wins. The fingerprint always
        keys STORAGE — profiles for different workloads never overwrite
        each other — but boot-time adoption is deliberately
        newest-matching-wins: the operator controls which profile file
        is loaded, and the online controller adapts from whatever seed
        it gets. None when no entry matches the target signature
        (foreign tunings never apply)."""
        digest = target if isinstance(target, str) else target_digest(target)
        best = None
        best_rank = None
        for entry in self._entries.values():
            if entry.get("target") != digest:
                continue
            entry_pool = entry.get("pool") or "*"
            if entry_pool not in (pool, "*"):
                continue
            rank = (
                # A config-named operator profile outranks everything —
                # including checkpoint-restored online adoptions — for
                # as long as it is configured (the flag is stripped on
                # checkpoint load, so it never outlives the config).
                bool(entry.get("operator")),
                entry_pool == pool,
                workload is not None and entry.get("workload") == workload,
                float(entry.get("created") or 0.0),
            )
            if best_rank is None or rank > best_rank:
                best, best_rank = entry, rank
        return best

    # -- persistence ---------------------------------------------------

    def dump(self) -> dict:
        return {"format": FORMAT, "entries": dict(self._entries)}

    def load(self, state: dict) -> None:
        """Replace the store contents from a checkpoint dump. Unknown
        formats are ignored (an old binary reading a future checkpoint
        keeps its config defaults rather than mis-parsing)."""
        if not isinstance(state, dict) or state.get("format") != FORMAT:
            return
        entries = state.get("entries") or {}
        self._entries = {k: dict(v) for k, v in entries.items()}
        for entry in self._entries.values():
            # Operator precedence (see lookup) asserts the CURRENT
            # config, not a past boot's: a checkpointed profile entry
            # reverts to normal ranking until merge_json re-marks it.
            entry.pop("operator", None)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=2, sort_keys=True)
            f.write("\n")

    def merge_json(self, path: str, *, operator: bool = False) -> int:
        """Merge a tuned-profile file (tools/autotune.py output — the
        same schema as dump()) over the current contents; returns the
        number of entries merged. operator=True marks the merged
        entries as the config-named override, which outranks every
        other entry in lookup until the next checkpoint load."""
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("format") != FORMAT:
            raise ValueError(
                f"{path}: not a tuning-store file (format {FORMAT} expected)"
            )
        entries = doc.get("entries") or {}
        for entry in entries.values():
            entry = dict(entry)
            if operator:
                entry["operator"] = True
            self.put(entry)
        return len(entries)
