"""The flight recorder: append scheduler rounds to an `.atrace` bundle.

One recorder = one bundle. The first write emits a header carrying the
trace format version, the target signature (host CPU features, the
torch and CUDA toolchain with the card's name and power limit, and the
x64 mode — a replay on a foreign host refuses instead of silently
comparing against decisions made by different arithmetic), the
scheduling-config fingerprint, and any RNG / fault-plan seeds the
caller supplies. Every round record then holds the bit-exact padded
DeviceRound the solver saw plus the decision stream it produced.

This is the port's copy of the JAX package's trace/recorder.py, and
writes the same `atrace/1` format: a bundle recorded by either package
replays on the other. The target signature is the port's own
(`_target_signature`).

Hooked into `services/scheduler.py` (attach_trace_recorder) and
`sim/simulator.py` (trace_path=...). Recording must never fail a round:
callers wrap record_round in a try/except and log.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import time

import numpy as np

from .codec import FORMAT, encode_device_round, encode_field, encode_record

# The decision-stream keys a replayed solve is compared against. These
# are exactly solver/kernel.solve_round's array outputs: masks/nodes/
# priorities over the padded job axis, shares over the padded queue
# axis, the market spot price, and the pass-1 loop count (the loop
# stream — host-driven and fused drivers run loop-for-loop identical,
# tests/test_torch_hotwindow.py).
DECISION_KEYS = (
    "assigned_node",
    "scheduled_priority",
    "scheduled_mask",
    "preempted_mask",
    "fair_share",
    "demand_capped_fair_share",
    "uncapped_fair_share",
    "spot_price",
    "num_loops",
)

# Above this many jobs the id vocabularies are dropped by default: a 1M
# job round's id lists dwarf the tensor payload and replay equality is
# index-based anyway (ids only prettify divergence reports).
AUTO_IDS_MAX_JOBS = 100_000


def config_fingerprint(config) -> str:
    """Stable digest of the scheduling config. repr of the (frozen)
    dataclass tree is deterministic per process and content-addressed
    enough for replay bookkeeping — the round inputs themselves are
    recorded bit-exactly, the fingerprint only labels them."""
    return hashlib.sha256(repr(config).encode()).hexdigest()[:16]


def host_cpu_signature() -> str:
    """Stable hash of the host's CPU: its machine type and one core's
    ISA feature flags (the JAX package hashes the same flags)."""
    import platform

    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:
        parts.append(platform.processor())
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def toolchain_signature() -> str:
    """The torch and CUDA versions and the card the solves run on, with
    its power limit as nvidia-smi prints it: `torch-<v> cuda-<v> <name>,
    <limit>`, or `torch-<v> cpu` where no card is present. It stands
    where the JAX package's header names its XLA target."""
    import torch

    head = f"torch-{torch.__version__}"
    if not torch.cuda.is_available():
        return f"{head} cpu"
    card = torch.cuda.get_device_name(0)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip() or card
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{head} cuda-{torch.version.cuda} {card}"


def _target_signature() -> dict:
    # The port solves with float64 costs and int64 keys only, so its x64
    # mode is always on.
    return {
        "host_cpu": host_cpu_signature(),
        "xla": toolchain_signature(),
        "x64": True,
    }


class TraceRecorder:
    def __init__(
        self,
        path: str,
        *,
        source: str = "scheduler",
        config=None,
        seeds: dict | None = None,
        meta: dict | None = None,
        record_ids: bool | None = None,
        max_rounds: int | None = None,
        append: bool = False,
    ):
        """One recorder = one bundle = one recording session. By default
        an existing file at `path` is REPLACED at the first write: a
        bundle holds exactly one header, and appending a new session
        under an old header would replay later rounds against the wrong
        target signature / config fingerprint / seeds (load_trace
        refuses multi-header bundles). append=True is for resuming the
        same logical session only."""
        self.path = path
        self.source = source
        self.seeds = dict(seeds or {})
        self.meta = dict(meta or {})
        self.record_ids = record_ids
        self.max_rounds = max_rounds
        self.rounds_recorded = 0
        self.bytes_written = 0
        self._config = config
        self._append = append
        self._header_written = False
        self._fh = None

    # -- plumbing ------------------------------------------------------

    def _open(self):
        if self._fh is None:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a" if self._append else "w")
        return self._fh

    def _write(self, record: dict, metrics=None, pool: str | None = None) -> int:
        line = encode_record(record) + "\n"
        fh = self._open()
        fh.write(line)
        fh.flush()
        n = len(line.encode())
        self.bytes_written += n
        if metrics is not None and getattr(metrics, "registry", None) is not None:
            metrics.trace_bytes_written.inc(n)
            if record.get("kind") == "round":
                metrics.trace_rounds_recorded.labels(pool=pool or "").inc()
        return n

    def _write_header(self, config, metrics=None):
        cfg = config if config is not None else self._config
        summary = {}
        if cfg is not None:
            summary = {
                "market_driven": bool(cfg.market_driven),
                "batch_fill_window": int(cfg.batch_fill_window),
                "hot_window_slots": int(getattr(cfg, "hot_window_slots", 0)),
                # The offline tuner's baseline vector needs the floor
                # too; older bundles lack the key (readers default it).
                "hot_window_min_slots": int(
                    getattr(cfg, "hot_window_min_slots", 0)
                ),
                "priority_classes": sorted(cfg.priority_classes),
                # Fairness policy (solver/policy.py): default + per-pool
                # map, so the replayer can refuse a cross-policy
                # comparison up front (each round's DeviceRound also
                # carries its own fairness_policy meta). Older bundles
                # lack the keys (pre-policy == DRF everywhere).
                "fairness_policy_default": str(
                    getattr(cfg, "fairness_policy_default", "drf")
                ),
                "fairness_policy_pools": dict(
                    getattr(cfg, "fairness_policy_pools", {})
                ),
            }
        self._write(
            {
                "kind": "header",
                "format": FORMAT,
                "created": time.time(),
                "source": self.source,
                "target": _target_signature(),
                "config_fingerprint": (
                    config_fingerprint(cfg) if cfg is not None else None
                ),
                "config_summary": summary,
                "seeds": self.seeds,
                "meta": self.meta,
                # Round observatory (observe/): rounds in this
                # bundle carry cost accounting in their profile blocks —
                # `transfer` (bytes up/down, donated buffers) and
                # `compiles` (kernel build/load deltas) — so replay can diff
                # COST against the recording, not just decisions; plus
                # the fairness ledger + preemption attribution per round
                # (`fairness` blocks — a replay recomputation mismatch
                # is the fairness_ledger divergence kind). Older bundles
                # simply lack the keys (readers default absent).
                "observatory": {"transfer_ledger": True,
                                "compile_telemetry": True,
                                "fairness_ledger": True},
            },
            metrics=metrics,
        )
        self._header_written = True

    def wants_ids(self, num_jobs: int) -> bool:
        """Whether this bundle records id vocabularies at this round
        size — callers can skip BUILDING the O(J) id lists entirely."""
        if self.record_ids is None:
            return num_jobs <= AUTO_IDS_MAX_JOBS
        return bool(self.record_ids)

    # -- recording -----------------------------------------------------

    def record_round(
        self,
        *,
        pool: str,
        dev,
        decisions: dict,
        num_jobs: int,
        num_queues: int,
        config=None,
        cycle: int | None = None,
        now: float | None = None,
        solver: dict | None = None,
        truncated: bool = False,
        profile: dict | None = None,
        solve_s: float | None = None,
        ids: dict | None = None,
        fairness: dict | None = None,
        metrics=None,
    ) -> bool:
        """Append one round. `dev` is the padded DeviceRound exactly as
        handed to the solver; `decisions` the solver's output dict (any
        superset of DECISION_KEYS — extra keys like `profile` are taken
        from the explicit kwargs instead). Returns False when the
        bundle's max_rounds cap is reached."""
        if self.max_rounds is not None and self.rounds_recorded >= self.max_rounds:
            return False
        if not self._header_written:
            self._write_header(config, metrics=metrics)
        record_ids = self.wants_ids(num_jobs)
        record = {
            "kind": "round",
            "i": self.rounds_recorded,
            "pool": pool,
            "cycle": cycle,
            "now": now,
            "num_jobs": int(num_jobs),
            "num_queues": int(num_queues),
            "solver": dict(solver or {}),
            "truncated": bool(truncated),
            "profile": dict(profile) if profile else None,
            "solve_s": solve_s,
            "dev": encode_device_round(dev),
            "decisions": {
                k: encode_field(np.asarray(decisions[k]))
                for k in DECISION_KEYS
                if k in decisions
            },
            "ids": dict(ids) if (ids and record_ids) else None,
            # Fairness observatory (observe/fairness.py): the canonical
            # index-based per-round share ledger + preemption
            # attribution. Plain JSON (doubles round-trip exactly), so
            # a replay's recomputation from this record's own dev +
            # decisions compares bit-for-bit (the fairness_ledger
            # divergence kind).
            "fairness": dict(fairness) if fairness else None,
        }
        self._write(record, metrics=metrics, pool=pool)
        self.rounds_recorded += 1
        return True

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
