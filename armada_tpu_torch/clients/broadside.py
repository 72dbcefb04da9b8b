"""Broadside: load bench for the job-state store with pluggable backends.

The reference's broadside (internal/broadside/{orchestrator,ingester,
querier,metrics,configuration,db}/) benchmarks the lookout view under
production-shaped load: a pluggable database backend, an ingester that
simulates the full job lifecycle, a querier that simulates UI traffic, an
optional warmup that resets metrics at steady state, periodic progress
logging, and a JSON report of per-operation latency histograms.

Same architecture here, sized to this framework's in-process design:

- Backend seam: `InprocBackend` drives the real event log -> LookoutStore
  -> QueryApi materialization pipeline entirely in-process (the analogue of
  the reference's in-memory db backend, broadside/db/memory.go);
  `GrpcBackend` points the same actors at a live control plane.
- Ingest actors publish submit batches AND walk them through the lifecycle
  (queued -> leased -> running -> succeeded/failed/cancelled, the
  broadside/jobspec/state.go transition mix).
- Query actors alternate job-table pages, state aggregations, and job
  detail lookups (broadside/querier/querier.go query families).

CLI:
  python -m armada_tpu_torch.clients.broadside --backend inproc --duration 10
  python -m armada_tpu_torch.clients.broadside --backend grpc --server H:P ...

This is the port's copy of the JAX package's clients/broadside.py: the
in-process and SQLite backends stand on the port's event log, Lookout
views and query API; the gRPC backend reaches a server through
`services.grpc_api.connect`, which needs `grpc`.
"""

from __future__ import annotations

import argparse
import json
import random
import threading
import time
from dataclasses import dataclass

from .load_tester import percentile


@dataclass(frozen=True)
class BroadsideConfig:
    """configuration.Configuration, reduced to the knobs that matter."""

    backend: str = "inproc"  # inproc | grpc | sqlite
    server: str = "127.0.0.1:50051"
    duration_s: float = 10.0
    warmup_s: float = 0.0
    ingest_actors: int = 2
    query_actors: int = 4
    batch: int = 50
    queues: int = 4
    # Fractions of each batch finishing in each terminal state
    # (jobspec/state.go lifecycle mix); the rest stay running.
    succeed_fraction: float = 0.6
    fail_fraction: float = 0.1
    cancel_fraction: float = 0.05
    progress_every_s: float = 30.0
    output: str = ""  # report file path; "" = stdout only
    seed_jobs: int = 0  # historical rows ingested before the clock starts


class OpStats:
    """Latency recorder for one operation family
    (broadside/metrics/histogram.go): thread-safe, resettable at warmup."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._lat: list[float] = []
        self._errors = 0
        self._units = 0  # e.g. jobs ingested (count tracks batches)

    def record(self, seconds: float, units: int = 1):
        with self._lock:
            self._lat.append(seconds)
            self._units += units

    def error(self):
        with self._lock:
            self._errors += 1

    def reset(self):
        with self._lock:
            self._lat.clear()
            self._errors = 0
            self._units = 0

    def snapshot(self, wall_s: float) -> dict:
        with self._lock:
            lat, errors, units = list(self._lat), self._errors, self._units
        out = {
            "ops": len(lat),
            "errors": errors,
            "ops_per_s": round(len(lat) / wall_s, 2) if wall_s else 0.0,
        }
        if units != len(lat):
            out["units"] = units
            out["units_per_s"] = round(units / wall_s, 2) if wall_s else 0.0
        if lat:
            out.update(
                p50_ms=round(percentile(lat, 50) * 1e3, 3),
                p90_ms=round(percentile(lat, 90) * 1e3, 3),
                p99_ms=round(percentile(lat, 99) * 1e3, 3),
                max_ms=round(max(lat) * 1e3, 3),
            )
        return out


class InprocBackend:
    """The framework's own materialization pipeline under test: event log
    -> LookoutStore (independent cursor) -> QueryApi. A pump thread applies
    the log continuously, so queries race ingestion exactly as the UI races
    the lookout ingester in production."""

    name = "inproc"

    def __init__(self):
        from ..events import InMemoryEventLog
        from ..services.queryapi import QueryApi

        self.log = InMemoryEventLog()
        self.store = self._make_store()
        self.query = QueryApi(lookout=self.store)
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._pump_loop, daemon=True)
        self._pump.start()
        self._seq = 0
        self._seq_lock = threading.Lock()
        self.recent_ids: list[str] = []

    def _make_store(self):
        from ..services.lookout_ingester import LookoutStore

        return LookoutStore(self.log)

    def _pump_loop(self):
        while not self._stop.is_set():
            if self.store.sync() == 0:
                time.sleep(0.001)

    def lag_events(self) -> int:
        return self.store.lag_events

    def submit_batch(self, queue: str, jobset: str, n: int, cfg: BroadsideConfig):
        """One ingest step: n submits plus their lifecycle transitions, a
        single publish per phase (the reference ingester batches inserts
        the same way, broadside/ingester/ingester.go)."""
        from ..core.types import JobSpec
        from ..events import (
            CancelJob,
            EventSequence,
            JobErrors,
            JobRunLeased,
            JobRunRunning,
            JobRunSucceeded,
            JobSucceeded,
            SubmitJob,
        )
        from ..events.model import new_id

        with self._seq_lock:
            base = self._seq
            self._seq += n
        now = time.time()
        ids = [new_id("bs") for _ in range(n)]
        self.log.publish(
            EventSequence.of(
                queue,
                jobset,
                *[
                    SubmitJob(
                        created=now,
                        job=JobSpec(
                            id=ids[i],
                            queue=queue,
                            jobset=jobset,
                            requests={"cpu": "1", "memory": "1Gi"},
                            submitted_ts=now,
                        ),
                    )
                    for i in range(n)
                ],
            )
        )
        # Clamp the ranges to be disjoint: succeed takes the head, fail the
        # next slice, cancel the tail — fractions summing past 1 must not
        # emit conflicting terminal events for one job id.
        n_succeed = min(int(n * cfg.succeed_fraction), n)
        n_fail = min(int(n * cfg.fail_fraction), n - n_succeed)
        n_cancel = min(int(n * cfg.cancel_fraction), n - n_succeed - n_fail)
        leases = [
            JobRunLeased(
                created=now,
                job_id=ids[i],
                run_id=new_id("run"),
                executor="bs-ex",
                node_id=f"bs-node-{base % 64}",
                pool="default",
            )
            for i in range(n - n_cancel)
        ]
        self.log.publish(EventSequence.of(queue, jobset, *leases))
        self.log.publish(
            EventSequence.of(
                queue,
                jobset,
                *[
                    JobRunRunning(created=now, job_id=lease.job_id, run_id=lease.run_id)
                    for lease in leases
                ],
            )
        )
        terminal = []
        # Success is run-anchored (jobdb/ingest.py drops a JobSucceeded
        # whose latest run did not report SUCCEEDED — partition fencing):
        # emit the run's success alongside, like the real executor wire.
        for i in range(n_succeed):
            terminal.append(
                JobRunSucceeded(
                    created=now, job_id=ids[i], run_id=leases[i].run_id
                )
            )
            terminal.append(JobSucceeded(created=now, job_id=ids[i]))
        terminal += [
            JobErrors(created=now, job_id=ids[n_succeed + i], error="oom killed")
            for i in range(n_fail)
        ]
        terminal += [
            CancelJob(created=now, job_id=ids[n - 1 - i], reason="broadside")
            for i in range(n_cancel)
        ]
        if terminal:
            self.log.publish(EventSequence.of(queue, jobset, *terminal))
        self.recent_ids = ids  # racy by design; any recent id will do
        return n

    def get_jobs(self, queue: str):
        from ..services.queryapi import JobFilter, Order

        rows, _ = self.query.get_jobs(
            [JobFilter("queue", queue)], Order("submitted", "desc"), 0, 100
        )
        return rows

    def group_jobs(self, queue: str):
        from ..services.queryapi import JobFilter

        return self.query.group_jobs("state", [JobFilter("queue", queue)])

    def job_details(self, job_id: str):
        return self.query.job_details(job_id)

    def teardown(self):
        self._stop.set()
        self._pump.join(timeout=2)


class SqliteBackend(InprocBackend):
    """The persistent lookout store under the same pipeline: event log ->
    SqliteLookoutStore (WAL file) -> QueryApi. Compares disk-backed
    materialization + query latency against the in-proc dict store — the
    reference Broadside's reason to exist is exactly this backend matrix
    (internal/broadside/orchestrator/doc.go)."""

    name = "sqlite"

    def _make_store(self):
        import tempfile

        from ..services.lookout_sqlite import SqliteLookoutStore

        self._tmp = tempfile.TemporaryDirectory(prefix="broadside-sqlite-")
        return SqliteLookoutStore(self.log, f"{self._tmp.name}/lookout.db")

    def teardown(self):
        super().teardown()
        self.store.close()
        self._tmp.cleanup()


class GrpcBackend:
    """The same actor mix against a live control plane's gRPC surface."""

    name = "grpc"

    def __init__(self, server: str):
        from ..services.grpc_api import connect

        self.server = server
        self._connect = connect
        self.client = connect(server)
        self.recent_ids: list[str] = []

    def new_channel(self):
        return self._connect(self.server)

    def lag_events(self) -> int:
        return 0  # not observable over the wire

    def ensure_queues(self, queues):
        """Queue setup happens once before actors start — connection and
        queue creation must not pollute measured op latency."""
        for queue in queues:
            try:
                self.client.create_queue(queue)
            except Exception:
                pass

    def submit_batch(self, queue: str, jobset: str, n: int, cfg, client=None):
        client = client or self.client
        ids = client.submit_jobs(
            queue,
            jobset,
            [{"requests": {"cpu": "1", "memory": "1Gi"}} for _ in range(n)],
        )
        if isinstance(ids, list):
            self.recent_ids = ids
        return n

    def get_jobs(self, queue: str, client=None):
        client = client or self.client
        return client.get_jobs(
            filters=[{"field": "queue", "value": queue}], take=100
        )

    def group_jobs(self, queue: str, client=None):
        client = client or self.client
        return client.group_jobs(
            "state", filters=[{"field": "queue", "value": queue}]
        )

    def job_details(self, job_id: str, client=None):
        client = client or self.client
        return client.get_jobs(
            filters=[{"field": "job_id", "value": job_id}], take=1
        )

    def teardown(self):
        pass


class Runner:
    """orchestrator.Runner: setup -> seed -> actors -> warmup reset ->
    progress ticks -> duration -> teardown -> report."""

    def __init__(self, cfg: BroadsideConfig, backend=None):
        self.cfg = cfg
        if backend is None:
            backend = {
                "grpc": lambda: GrpcBackend(cfg.server),
                "sqlite": SqliteBackend,
            }.get(cfg.backend, InprocBackend)()
        self.backend = backend
        self.stats = {
            name: OpStats(name)
            for name in ("ingest", "get_jobs", "group_jobs", "job_details")
        }
        self._stop = threading.Event()
        self._started = time.time()

    def _queue(self, i: int) -> str:
        return f"broadside-{i % self.cfg.queues}"

    def _ingest_actor(self, idx: int):
        cfg = self.cfg
        client = (
            self.backend.new_channel()
            if hasattr(self.backend, "new_channel")
            else None
        )
        jobset = f"bs-{idx}"
        i = 0
        while not self._stop.is_set():
            t0 = time.time()
            try:
                kwargs = {"client": client} if client is not None else {}
                n = self.backend.submit_batch(
                    self._queue(i), jobset, cfg.batch, cfg, **kwargs
                )
                self.stats["ingest"].record(time.time() - t0, units=n)
            except Exception:
                self.stats["ingest"].error()
            i += 1

    def _query_actor(self, idx: int):
        client = (
            self.backend.new_channel()
            if hasattr(self.backend, "new_channel")
            else None
        )
        kwargs = {"client": client} if client is not None else {}
        rng = random.Random(idx)
        while not self._stop.is_set():
            roll = rng.random()
            queue = self._queue(rng.randrange(self.cfg.queues))
            # Query mix (querier.go families): one (name, thunk) choice so
            # success and error always land in the same OpStats bucket.
            if roll < 0.45:
                name = "get_jobs"
                op = lambda: self.backend.get_jobs(queue, **kwargs)
            elif roll < 0.8:
                name = "group_jobs"
                op = lambda: self.backend.group_jobs(queue, **kwargs)
            else:
                ids = self.backend.recent_ids
                if not ids:
                    continue
                job_id = rng.choice(ids)
                name = "job_details"
                op = lambda: self.backend.job_details(job_id, **kwargs)
            t0 = time.time()
            try:
                op()
                self.stats[name].record(time.time() - t0)
            except Exception:
                self.stats[name].error()

    def run(self) -> dict:
        cfg = self.cfg
        if hasattr(self.backend, "ensure_queues"):
            self.backend.ensure_queues(
                [self._queue(i) for i in range(cfg.queues)]
            )
        # Seed historical rows before the measured window (the reference
        # populates historical job data before starting actors).
        if cfg.seed_jobs:
            seeded = batch_i = 0
            while seeded < cfg.seed_jobs:
                n = min(cfg.batch, cfg.seed_jobs - seeded)
                # Rotate batches across every queue (indexing by job count
                # skips queues whenever batch % queues == 0).
                self.backend.submit_batch(self._queue(batch_i), "bs-seed", n, cfg)
                seeded += n
                batch_i += 1
            # Measure steady state, not catch-up: wait for the view to
            # drain the seed backlog before the clock starts (the
            # reference's warmup exists for exactly this).
            deadline = time.time() + 600
            while self.backend.lag_events() > 0 and time.time() < deadline:
                time.sleep(0.05)
        threads = [
            threading.Thread(target=self._ingest_actor, args=(i,), daemon=True)
            for i in range(cfg.ingest_actors)
        ] + [
            threading.Thread(target=self._query_actor, args=(i,), daemon=True)
            for i in range(cfg.query_actors)
        ]
        for t in threads:
            t.start()
        if cfg.warmup_s:
            time.sleep(cfg.warmup_s)
            for s in self.stats.values():
                s.reset()  # steady-state measurements only
        t_start = time.time()
        deadline = t_start + cfg.duration_s
        next_progress = t_start + cfg.progress_every_s
        while time.time() < deadline:
            time.sleep(min(0.2, max(0.0, deadline - time.time())))
            if time.time() >= next_progress:
                elapsed = time.time() - t_start
                print(
                    json.dumps(
                        {
                            "progress_s": round(elapsed, 1),
                            "ingested": self.stats["ingest"].snapshot(elapsed),
                            "lag_events": self.backend.lag_events(),
                        }
                    )
                )
                next_progress += cfg.progress_every_s
        self._stop.set()
        for t in threads:
            t.join(timeout=5)
        wall = time.time() - t_start
        self.backend.teardown()
        report = {
            "backend": self.backend.name,
            "duration_s": round(wall, 2),
            "warmup_s": cfg.warmup_s,
            "config": {
                "ingest_actors": cfg.ingest_actors,
                "query_actors": cfg.query_actors,
                "batch": cfg.batch,
                "queues": cfg.queues,
                "seed_jobs": cfg.seed_jobs,
            },
            "final_lag_events": self.backend.lag_events(),
            **{name: s.snapshot(wall) for name, s in self.stats.items()},
        }
        if cfg.output:
            with open(cfg.output, "w") as f:
                json.dump(report, f, indent=2)
        return report


def main(argv=None):
    ap = argparse.ArgumentParser(prog="armada-tpu-broadside")
    ap.add_argument(
        "--backend", choices=("inproc", "grpc", "sqlite"), default="inproc"
    )
    ap.add_argument("--server", default="127.0.0.1:50051")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--warmup", type=float, default=0.0)
    ap.add_argument("--ingest-actors", type=int, default=2)
    ap.add_argument("--query-actors", type=int, default=4)
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--queues", type=int, default=4)
    ap.add_argument("--seed-jobs", type=int, default=0)
    ap.add_argument("--output", default="")
    args = ap.parse_args(argv)
    cfg = BroadsideConfig(
        backend=args.backend,
        server=args.server,
        duration_s=args.duration,
        warmup_s=args.warmup,
        ingest_actors=args.ingest_actors,
        query_actors=args.query_actors,
        batch=args.batch,
        queues=args.queues,
        seed_jobs=args.seed_jobs,
        output=args.output,
    )
    report = Runner(cfg).run()
    print(json.dumps(report))
    errors = sum(report[k].get("errors", 0) for k in
                 ("ingest", "get_jobs", "group_jobs", "job_details"))
    return 0 if errors == 0 else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
