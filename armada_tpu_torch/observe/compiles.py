"""Compile and load telemetry for the port's kernel libraries.

The port compiles one thing at run time: each `csrc/<name>.cu` is built
by `nvcc` into a shared library under `build/kernels/` and bound with
ctypes at its first use (ops/kernels.py). A warm scheduling cycle that
quietly rebuilt or reloaded a library would pay seconds inside what the
profile calls "solve"; this module makes that visible. It is the
counterpart of the JAX package's `observe/xla.py`, and keeps its keys,
so the metrics, the round profile and the replayer read the same dict:

    compiles, compile_seconds  one per nvcc run, and its wall clock
    traces                     one per library load (`ctypes.CDLL`) and
                               per C symbol bound from it
    cache_hits, cache_misses   a library found already built, or one
                               that had to be built
    alloc_segments             the growth of the CUDA caching allocator's
                               segment count (`torch.cuda.memory_stats`,
                               "segment.all.allocated"): a new cudaMalloc.
                               Reported, never classified as a retrace.

`ops/kernels.py` calls the `note_*` hooks; callers bracket a region:

    snap = TELEMETRY.thread_snapshot()
    out = solve_round(dev)
    delta = TELEMETRY.delta_since(snap, thread=True)  # zeros when warm

Counts are kept process-wide and per scope. A thread has its own scope
unless it adopts another's: the shard threads of a sharded round
(parallel/comm.py) adopt the scope of the thread that started the
round, so a library that a shard thread builds lands in the round's
delta, and a neighbour thread's build does not.
"""

from __future__ import annotations

import contextlib
import threading

# The keys of a telemetry snapshot or delta, in reporting order.
FIELDS = ("traces", "compiles", "compile_seconds", "cache_hits", "cache_misses")
ALLOC_KEY = "alloc_segments"


def _zero() -> dict:
    return {"traces": 0, "compiles": 0, "compile_seconds": 0.0,
            "cache_hits": 0, "cache_misses": 0}


def alloc_segments() -> int:
    """Segments the CUDA caching allocator has ever taken from the
    driver, summed over the cards this process has initialised (0 where
    it has none). Reads no card that CUDA has not initialised."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return 0
        return sum(
            int(torch.cuda.memory_stats(d).get("segment.all.allocated", 0))
            for d in range(torch.cuda.device_count())
        )
    except Exception:  # noqa: BLE001 - telemetry must not fail a round
        return 0


class CompileTelemetry:
    """Monotonic counters, process-wide and per scope; thread-safe. All
    reads go through snapshot()/thread_snapshot()/delta_since(), so a
    caller never sees a torn multi-field update."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._totals = _zero()

    # -- scopes ----------------------------------------------------------

    def scope(self) -> dict:
        """This thread's counter scope (created on first use)."""
        counts = getattr(self._local, "counts", None)
        if counts is None:
            counts = self._local.counts = _zero()
        return counts

    @contextlib.contextmanager
    def adopt(self, scope: dict):
        """Credit this thread's events to `scope` (another thread's, from
        scope()) until the block ends."""
        prev = getattr(self._local, "counts", None)
        self._local.counts = scope
        try:
            yield
        finally:
            self._local.counts = prev

    def _add(self, key: str, value=1):
        counts = self.scope()
        with self._lock:
            counts[key] += value
            self._totals[key] += value

    # -- hooks (ops/kernels.py) -----------------------------------------

    def note_cache(self, hit: bool):
        self._add("cache_hits" if hit else "cache_misses")

    def note_compile(self, seconds: float):
        counts = self.scope()
        with self._lock:
            for c in (counts, self._totals):
                c["compiles"] += 1
                c["compile_seconds"] += float(seconds)

    def note_load(self):
        self._add("traces")

    # -- reading ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Process-wide totals, for single-threaded brackets."""
        with self._lock:
            out = dict(self._totals)
        out[ALLOC_KEY] = alloc_segments()
        return out

    def thread_snapshot(self) -> dict:
        """This thread's scope: only what this thread, and the threads
        that adopted its scope, built or loaded counts. alloc_segments
        is the process-wide allocator count either way."""
        counts = self.scope()
        with self._lock:
            out = dict(counts)
        out[ALLOC_KEY] = alloc_segments()
        return out

    def delta_since(self, snapshot: dict, *, thread: bool = False) -> dict:
        """Counter movement since `snapshot`, compile_seconds rounded for
        JSON. `thread=True` diffs this thread's scope, as it must when
        the baseline came from thread_snapshot()."""
        now = self.thread_snapshot() if thread else self.snapshot()
        out = {k: now[k] - snapshot.get(k, 0) for k in FIELDS + (ALLOC_KEY,)}
        out["compile_seconds"] = round(out["compile_seconds"], 4)
        return out


# Process-wide singleton; ops/kernels.py reports into it.
TELEMETRY = CompileTelemetry()
