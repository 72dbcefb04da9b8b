"""Single-process control-plane assembly.

Wires the full stack the way the reference's `mage dev:up fake-executor`
does (server + scheduler + ingesters + fake executors, zero Kubernetes):
event log, scheduler cycle loop, submission API, query API, reports,
metrics, gRPC endpoint. One process; every component is the same object the
distributed deployment uses.

This is the port's copy of the JAX package's services/server.py. What
differs: the kernel backend is the default and solves on `device` (the
CUDA card unless the caller asks for the CPU, `device="cpu"`); `mesh` is
the port's mesh spec (`parallel.multihost.resolve_solver`: "HxC", an
int, a `parallel.mesh.DeviceMesh`). Like the reference, the constructor
serves gRPC (`ApiServer.serve`), so it needs `grpc`; the parts it wires
run without it.
"""

from __future__ import annotations

import os
import threading
import time as _time

from ..core.config import SchedulingConfig
from ..events import InMemoryEventLog
from .fake_executor import FakeExecutor, make_nodes
from .grpc_api import ApiServer
from .leader import StandaloneLeader
from .metrics import SchedulerMetrics, serve_metrics
from .queryapi import QueryApi
from .scheduler import SchedulerService
from .submit import SubmitService
from .submit_check import SubmitChecker


class ControlPlane:
    def __init__(
        self,
        config: SchedulingConfig | None = None,
        *,
        backend: str = "kernel",
        # Sharded-solve mesh spec for the kernel backend: int (shard
        # count), "HxC" / (hosts, chips) (two-level hierarchy,
        # parallel/multihost.py), or a parallel.mesh.DeviceMesh. None =
        # unsharded.
        mesh=None,
        # The device the kernel backend solves on: the CUDA card unless
        # the caller asks for the CPU ("cpu"); raises where it is missing.
        device=None,
        cycle_period: float = 1.0,
        grpc_port: int = 0,
        metrics_port: int | None = None,
        lookout_port: int | None = None,
        health_port: int | None = None,
        fake_executors: list[dict] | None = None,
        enable_submit_check: bool = False,
        data_dir: str | None = None,
        tls: tuple | None = None,
    ):
        self.config = config or SchedulingConfig()
        self.checkpoints = None
        if data_dir:
            from ..events.file_log import FileEventLog
            from .checkpoint import CheckpointManager, CheckpointStore

            self.log = FileEventLog(data_dir)
            store = CheckpointStore(os.path.join(data_dir, "checkpoints"))
            self.checkpoints = CheckpointManager(store, self.log)
        else:
            self.log = InMemoryEventLog()

        def _ckpt(name):
            return (
                self.checkpoints.store.load(name) if self.checkpoints else None
            )

        self.leader = StandaloneLeader()
        # Store backpressure (services/backpressure.py; the reference's
        # etcd health monitoring): gates submissions and executor pod
        # creation when the log backs up. Signals are config-gated.
        self.store_health = None
        if self.config.store_capacity_bytes or self.config.max_ingest_lag_events:
            from .backpressure import StoreHealthMonitor

            self.store_health = StoreHealthMonitor(
                self.log,
                capacity_bytes=self.config.store_capacity_bytes,
                fraction_of_capacity_limit=(
                    self.config.store_fraction_of_capacity_limit
                ),
                max_ingest_lag_events=self.config.max_ingest_lag_events,
            )
        self.scheduler = SchedulerService(
            self.config, self.log, backend=backend, mesh=mesh,
            is_leader=self.leader, checkpoint=_ckpt("scheduler"), device=device,
        )
        # Solver autopilot (armada_tpu_torch/autotune): the tuning store is
        # restored from its checkpoint first, then any config-named
        # offline profile (tools/autotune.py output) overlays it — the
        # config is the operator's override. The scheduler then adopts
        # the store's per-pool vector at its first round.
        self.autotune = None
        if self.config.autotune_enabled:
            from ..autotune import AutotuneController

            self.autotune = AutotuneController(self.config)
            ck = _ckpt("autotune")
            if ck is not None:
                self.autotune.store.load(ck[1])
            if self.config.autotune_profile:
                try:
                    # operator=True: the config-named profile outranks
                    # checkpoint-restored online adoptions in lookup —
                    # config is the operator's override, every boot it
                    # is configured.
                    self.autotune.store.merge_json(
                        self.config.autotune_profile, operator=True
                    )
                except Exception as e:  # noqa: BLE001 - tuning is advisory
                    print(f"autotune profile load failed: {e!r}")
            self.scheduler.attach_autotune(self.autotune)
        # Submit-side shedding consumes store capacity AND round-deadline
        # pressure (repeated maxSchedulingDuration truncations) through one
        # gate: sustained overload sheds intake instead of growing the
        # backlog unboundedly.
        from .backpressure import CompositeGate

        self.submit_gate = CompositeGate(
            self.store_health, self.scheduler.round_pressure
        )
        self.metrics = SchedulerMetrics()
        self.scheduler.attach_metrics(self.metrics)
        # SLO layer (services/slo.py): declared (or default) objectives
        # over round latency / queue wait / submit latency, tracked with
        # multi-window burn rates — surfaced via GET /api/slo, the
        # SLOStatus RPC (`armadactl slo`) and scheduler_slo_* metrics.
        from .slo import SLOTracker

        self.slo = SLOTracker.from_config(self.config, metrics=self.metrics)
        self.scheduler.attach_slo(self.slo)
        # Front door (armada_tpu_torch/frontdoor): jobset-keyed sharded ingest
        # WALs (the ack point; exactly-once delivery into the log) with
        # per-tenant admission layered in front of the SAME composite
        # gate — during overload the gate's reason drives quota-weighted
        # shedding instead of the submit service's all-or-nothing check.
        # Quota weight is the fair-share weight (1/priorityFactor), read
        # lazily from the queue registry so `armadactl queue update`
        # adjusts a tenant's slice live (the overload runbook's lever).
        self.frontdoor = None
        if self.config.frontdoor_shards > 0:
            from ..frontdoor import FrontDoor, TenantAdmission

            def _quota(tenant: str) -> float:
                q = self.submit.get_queue(tenant)
                return q.spec.weight if q is not None else 1.0

            admission = TenantAdmission(
                tenant_rate=self.config.frontdoor_tenant_rate,
                tenant_burst=self.config.frontdoor_tenant_burst,
                global_rate=self.config.frontdoor_global_rate,
                global_burst=self.config.frontdoor_global_burst,
                overload_rate=self.config.frontdoor_overload_rate,
                downstream=self.submit_gate,
                quota_of=_quota,
                metrics=self.metrics,
            )
            self.frontdoor = FrontDoor(
                self.log,
                num_shards=self.config.frontdoor_shards,
                directory=(
                    os.path.join(data_dir, "frontdoor") if data_dir else None
                ),
                admission=admission,
                metrics=self.metrics,
            )
        self.submit = SubmitService(
            self.config, self.log, scheduler=self.scheduler,
            checkpoint=_ckpt("submit"), store_health=self.submit_gate,
            frontdoor=self.frontdoor, slo=self.slo,
        )
        if self.store_health is not None:
            self.store_health.add_lag_source(
                "scheduler-ingester",
                lambda: max(
                    0, self.log.end_offset - self.scheduler.ingester.cursor
                ),
            )
            if self.frontdoor is not None:
                # Shard lag is ingest lag too: acked-but-undelivered work
                # backs the store up just like an unsynced view.
                self.store_health.add_lag_source(
                    "frontdoor", self.frontdoor.max_lag
                )
        self.query = QueryApi(
            self.scheduler.jobdb, timeline=self.scheduler.timeline
        )
        # What-if planner (armada_tpu_torch/whatif): fork capture on the round
        # seam + bounded shadow-solve worker; the WhatIf/PlanDrain/
        # ExecuteDrain RPCs and lookout's /api/whatif reach it through
        # the scheduler.
        from ..whatif import WhatIfService

        self.whatif = WhatIfService(
            self.scheduler, metrics=self.metrics,
            cycle_interval=cycle_period,
        )
        self.scheduler.attach_whatif(self.whatif)
        self.submit_checker = (
            SubmitChecker(self.config, self.scheduler) if enable_submit_check else None
        )
        self.cycle_period = cycle_period

        self.executors: list[FakeExecutor] = []
        for spec in fake_executors or []:
            self.executors.append(
                FakeExecutor(
                    spec.get("name", f"fake-{len(self.executors)}"),
                    self.log,
                    self.scheduler,
                    nodes=make_nodes(
                        spec.get("name", f"fake-{len(self.executors)}"),
                        count=int(spec.get("nodes", 10)),
                        pool=spec.get("pool", "default"),
                        cpu=str(spec.get("cpu", "8")),
                        memory=str(spec.get("memory", "128Gi")),
                        labels=spec.get("labels"),
                        extra_resources=spec.get("extra_resources"),
                    ),
                    pool=spec.get("pool", "default"),
                    runtime_for=lambda job_id, rt=float(spec.get("runtime", 30.0)): rt,
                )
            )

        from .binoculars import BinocularsService

        self.binoculars = BinocularsService(self.scheduler, self.executors)
        # Per-jobset event-stream view (the event-ingester's Redis streams,
        # eventingester/store/eventstore.go): watchers read partitioned
        # streams instead of scanning the shared log.
        from .event_index import EventStreamIndex

        self.event_index = EventStreamIndex(
            self.log, checkpoint=_ckpt("event_index")
        )
        self.api = ApiServer(
            self.submit,
            self.scheduler,
            self.query,
            self.log,
            self.submit_checker,
            binoculars=self.binoculars,
            event_index=self.event_index,
            store_health=self.store_health,
            frontdoor=self.frontdoor,
        )
        self.grpc_server, self.grpc_port = self.api.serve(grpc_port, tls=tls)
        self.metrics_server, self.metrics_port = (
            serve_metrics(self.metrics, metrics_port)
            if metrics_port is not None
            else (None, None)
        )
        # Independent lookout materialization (the reference's third
        # ingester): its own cursor + rows, synced in the loop; the lookout
        # UI queries it, never the scheduler's jobdb.
        from .lookout_ingester import LookoutStore

        self.lookout_store = LookoutStore(
            self.log, error_rules=self.config.error_categories,
            checkpoint=_ckpt("lookout"),
        )
        if self.checkpoints is not None:
            # Every log consumer that replays on restart must be
            # registered: compaction trails the min checkpointed cursor.
            self.checkpoints.register("scheduler", self.scheduler)
            self.checkpoints.register("submit", self.submit)
            self.checkpoints.register("event_index", self.event_index)
            self.checkpoints.register("lookout", self.lookout_store)
            if self.frontdoor is not None:
                # The shard ingesters' recovery scan starts at their
                # durably saved main-log offsets (drain.json, not the
                # checkpoint store) — register the front door so
                # compaction never deletes the dedup window out from
                # under a restarting shard (idle shards report the log
                # end, not 0, so they cannot stall compaction).
                self.checkpoints.register("frontdoor", self.frontdoor)
        self.lookout = None
        if lookout_port is not None:
            from .lookout_http import LookoutHttpServer

            self.lookout = LookoutHttpServer(
                QueryApi(
                    lookout=self.lookout_store,
                    timeline=self.scheduler.timeline,
                ),
                self.scheduler,
                self.submit,
                lookout_port,
                binoculars=self.binoculars,
                frontdoor=self.frontdoor,
            )
        # Health surface (common/health; schedulerapp.go:71-75).
        from .health import (
            BackpressureChecker,
            FencedExecutorChecker,
            FuncChecker,
            HeartbeatChecker,
            MultiChecker,
            SolverLadderChecker,
            StartupCompleteChecker,
            serve_health,
        )

        self.startup_checker = StartupCompleteChecker()
        self.cycle_checker = HeartbeatChecker(
            "cycle", timeout_s=max(30.0, 20 * cycle_period)
        )
        checkers = [
            self.startup_checker,
            self.cycle_checker,
            FuncChecker(
                "lookout-lag",
                lambda: (
                    self.lookout_store.lag_events < 100_000,
                    f"lag {self.lookout_store.lag_events} events",
                ),
            ),
        ]
        if self.store_health is not None:
            self.store_health.add_lag_source(
                "lookout", lambda: self.lookout_store.lag_events
            )
            checkers.append(
                BackpressureChecker("store", self.store_health)
            )
        # Round-deadline pressure surfaces in /health as ADVISORY detail:
        # a pool truncating round after round is degraded (and sheds
        # intake via the submit gate above), but it is live and making
        # bounded progress — it must not trip the liveness probe into a
        # restart loop (services/backpressure.RoundDeadlinePressure).
        checkers.append(
            BackpressureChecker(
                "round-deadline", self.scheduler.round_pressure,
                advisory=True,
            )
        )
        # Lease fencing is advisory detail too: a fenced executor means
        # the split-brain protocol is WORKING (stale exchanges rejected
        # until its anti-entropy sync) — name it for operators without
        # tripping liveness.
        checkers.append(FencedExecutorChecker(self.scheduler))
        # The solve ladder is advisory as well: open breakers and recent
        # round rejections mean the firewall/failover containment is
        # doing its job — surface them, don't restart over them.
        checkers.append(SolverLadderChecker(self.scheduler))
        self.health = MultiChecker(*checkers)
        self.health_server = None
        if health_port is not None:
            self.health_server, self.health_port = serve_health(
                self.health, self.startup_checker, health_port
            )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._maintenance_lock = threading.Lock()
        self.tasks = None  # BackgroundTaskManager, created by start()

    def _loop(self):
        while not self._stop.is_set():
            now = _time.time()
            if self.frontdoor is not None:
                # Drain the shard WALs into the log BEFORE the cycle so
                # this round sees everything acked up to now; injected
                # shard crashes restart in place inside pump().
                self.frontdoor.pump(now=now)
            for ex in self.executors:
                ex.tick(now)
            try:
                # The maintenance lock serializes checkpointing with the
                # cycle (checkpoint_state must not observe a cursor from
                # before a sync whose effects it dumps — the two ran
                # inline in this loop before the task manager existed).
                with self._maintenance_lock:
                    self.scheduler.cycle(now=now)
                self.cycle_checker.beat()
            except Exception as e:  # keep the loop alive; next cycle retries
                print(f"cycle error: {e!r}")
            self.lookout_store.sync()
            # scheduler_cycle_seconds is observed inside
            # SchedulerService.cycle itself — simulator-driven cycles
            # tick it too, not only this loop.
            self._stop.wait(self.cycle_period)

    def _prune_views(self):
        """Retention: the lookout pruner (internal/lookout/pruner) + the
        event ingester's per-jobset stream expiry."""
        cutoff = _time.time() - self.config.terminal_job_retention_s
        self.lookout_store.prune(cutoff)
        self.event_index.prune(cutoff)

    def _checkpoint_views(self):
        """Bounded restart + bounded disk: checkpoint all views, drop log
        segments they have all materialized (services/checkpoint.py).
        Serialized against the scheduler cycle (see _loop)."""
        with self._maintenance_lock:
            self.submit.sync()
            self.event_index.sync()
            self._save_autotune()
            self.checkpoints.checkpoint_and_compact()

    def _save_autotune(self):
        """Persist the tuning store next to the view checkpoints. NOT a
        registered view: it consumes no log events, so its (meaningless)
        cursor must never hold back log compaction."""
        if self.autotune is not None and self.checkpoints is not None:
            self.checkpoints.store.save(
                "autotune", 0, self.autotune.store.dump()
            )

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        # Maintenance loops run under the background task manager
        # (common/task BackgroundTaskManager): named, panic-contained,
        # duration-observed, joined on stop.
        from ..utils.tasks import BackgroundTaskManager

        maintenance_interval = max(30.0, 600 * self.cycle_period)
        self.tasks = BackgroundTaskManager()
        self.tasks.register(self._prune_views, maintenance_interval, "prune")
        if self.checkpoints is not None:
            self.tasks.register(
                self._checkpoint_views, maintenance_interval, "checkpoint"
            )
        self.startup_checker.mark_complete()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        stragglers: list = []
        if self.tasks is not None:
            stragglers = self.tasks.stop_all(timeout=5.0)
            if stragglers:
                print(f"background tasks still running: {stragglers}")
        if self.checkpoints is not None and "checkpoint" not in stragglers:
            # Clean shutdown writes a final checkpoint so the next start
            # replays (near-)nothing; a kill-9 still recovers from the
            # last periodic checkpoint + suffix replay. Skipped if the
            # periodic checkpoint task straggled past its join timeout —
            # two writers on the same .tmp files would tear both.
            try:
                with self._maintenance_lock:
                    self.submit.sync()
                    self.event_index.sync()
                    self._save_autotune()
                    self.checkpoints.save_all()
            except Exception as e:
                print(f"final checkpoint failed: {e!r}")
        self.grpc_server.stop(grace=0.5)
        if self.metrics_server:
            self.metrics_server.shutdown()
        if self.lookout:
            self.lookout.stop()
        if self.health_server:
            self.health_server.shutdown()
        if self.frontdoor is not None:
            self.frontdoor.close()
        if hasattr(self.log, "close"):
            self.log.close()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.grpc_port}"
