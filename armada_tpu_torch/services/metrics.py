"""Prometheus metrics for the scheduler and control plane.

Covers the reference's headline scheduler metrics
(internal/scheduler/metrics/{metrics,cycle_metrics}.go):
cycle time, per-queue/pool fair share vs actual share, demand, scheduled and
preempted counts, and job state-transition counters. Exposed via
prometheus_client's text endpoint.

This is the port's copy of the JAX package's services/metrics.py, with
the same metric families under the same names, so dashboards and the
tests' family lists hold for either package. prometheus_client is
optional: without it `registry` is None, every seam skips its metrics
and `render()` returns b"", as in the JAX package.

The `scheduler_xla_*` families keep their names but count what the port
compiles and loads at run time (observe/compiles.py): `compiles_total`
and `compile_seconds` the nvcc builds of the kernel libraries,
`retraces_total` the library loads and symbol binds, `cache_events_total`
a library found built (hit) or built (miss). A warm cycle moves none.
"""

from __future__ import annotations

try:
    from prometheus_client import (
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
        generate_latest,
    )

    HAVE_PROMETHEUS = True
except Exception:  # pragma: no cover
    HAVE_PROMETHEUS = False


class SchedulerMetrics:
    def __init__(self, registry=None):
        if not HAVE_PROMETHEUS:
            self.registry = None
            return
        self.registry = registry or CollectorRegistry()
        r = self.registry
        self.cycle_time = Histogram(
            "scheduler_cycle_seconds",
            "Wall-clock time of one scheduling cycle",
            registry=r,
        )
        self.solve_time = Histogram(
            "scheduler_solve_seconds",
            "Device solve time within a cycle",
            ["pool"],
            registry=r,
        )
        self.fair_share = Gauge(
            "scheduler_queue_fair_share",
            "Demand-capped adjusted fair share",
            ["pool", "queue"],
            registry=r,
        )
        self.actual_share = Gauge(
            "scheduler_queue_actual_share",
            "Actual share of pool resources",
            ["pool", "queue"],
            registry=r,
        )
        self.idealised_value = Gauge(
            "scheduler_queue_idealised_value",
            "Theoretical max value on a single mega node "
            "(idealised_value.go; market pools)",
            ["pool", "queue"],
            registry=r,
        )
        self.realised_value = Gauge(
            "scheduler_queue_realised_value",
            "Value actually placed this round (market pools)",
            ["pool", "queue"],
            registry=r,
        )
        self.skipped_executors = Gauge(
            "scheduler_skipped_executors",
            "Executors excluded from the current round (cordoned or lagging)",
            registry=r,
        )
        self.scheduled_jobs = Counter(
            "scheduler_jobs_scheduled_total",
            "Jobs scheduled",
            ["pool", "queue"],
            registry=r,
        )
        self.preempted_jobs = Counter(
            "scheduler_jobs_preempted_total",
            "Jobs preempted",
            ["pool", "queue"],
            registry=r,
        )
        self.considered_jobs = Gauge(
            "scheduler_jobs_considered",
            "Jobs considered in the last round",
            ["pool"],
            registry=r,
        )
        self.job_state_transitions = Counter(
            "scheduler_job_state_transitions_total",
            "Job state transitions observed",
            ["state"],
            registry=r,
        )
        self.event_log_offset = Gauge(
            "event_log_end_offset", "End offset of the event log", registry=r
        )
        # ---- depth mirroring metrics/cycle_metrics.go + state_metrics.go ----
        # Preemptions by mechanism (cycle_metrics.go:531 preemption types):
        # round (fairness/urgency in the solve), oversubscription repair,
        # reconciliation, optimiser.
        self.preempted_by_type = Counter(
            "scheduler_jobs_preempted_by_type_total",
            "Jobs preempted, by preemption mechanism",
            ["pool", "type"],
            registry=r,
        )
        # Per-queue state-transition counters with queue granularity.
        self.queue_state_transitions = Counter(
            "scheduler_queue_job_state_transitions_total",
            "Job state transitions by queue",
            ["queue", "state"],
            registry=r,
        )
        # Time-in-state at transition (state_metrics.go checkpoint
        # intervals): queued->leased, leased->running, running->done.
        self.state_seconds = Histogram(
            "scheduler_job_state_seconds",
            "Seconds spent in the previous state at each transition",
            ["transition"],
            buckets=(0.1, 1, 5, 15, 60, 300, 1800, 7200, 86400),
            registry=r,
        )
        self.queue_demand = Gauge(
            "scheduler_queue_demand",
            "Queue demand as dominant-share cost",
            ["pool", "queue"],
            registry=r,
        )
        # Ingestion lag (common/ingest/metrics + topic_delay_monitor.go):
        # events between the log end and the ingester cursor.
        self.ingester_lag = Gauge(
            "ingester_lag_events",
            "Events the scheduler ingester has not applied yet",
            registry=r,
        )
        self.snapshot_build_seconds = Histogram(
            "scheduler_snapshot_build_seconds",
            "Host-side snapshot + device-prep time per pool round",
            ["pool"],
            registry=r,
        )
        # Device-resident round state (snapshot/residency.py): which
        # snapshot strategy each pool round actually used, so residency
        # engagement (and per-pool demotions back to rebuild) is
        # observable; and the live drift guard behind the
        # resident_drift divergence kind.
        self.snapshot_mode_total = Counter(
            "scheduler_snapshot_mode_total",
            "Pool rounds by the snapshot strategy actually used",
            ["pool", "mode"],
            registry=r,
        )
        self.resident_drift = Counter(
            "scheduler_resident_drift_total",
            "Device-resident round buffers found drifted from the host "
            "mirror (the resident state was reset and re-uploads next "
            "cycle; the already-committed round was validated against "
            "the mirror by the admission firewall)",
            ["pool"],
            registry=r,
        )
        self.solve_loops = Gauge(
            "scheduler_solve_loops",
            "while-loop iterations of the last device solve",
            ["pool"],
            registry=r,
        )
        # Market mode: per-shape indicative gang price
        # (cycle_metrics.go:681 indicativePrice gauges).
        self.indicative_gang_price = Gauge(
            "scheduler_indicative_gang_price",
            "Minimum bid at which the configured gang shape would schedule",
            ["pool", "shape"],
            registry=r,
        )
        self.indicative_gang_schedulable = Gauge(
            "scheduler_indicative_gang_schedulable",
            "1 if the configured gang shape is currently schedulable",
            ["pool", "shape"],
            registry=r,
        )
        # Round-deadline guardrail (maxSchedulingDuration): rounds cut by
        # the budget, and the consecutive-truncation streak that trips
        # per-pool backpressure (backpressure.RoundDeadlinePressure).
        self.truncated_rounds = Counter(
            "scheduler_rounds_truncated_total",
            "Scheduling rounds truncated by maxSchedulingDuration",
            ["pool"],
            registry=r,
        )
        self.round_truncation_streak = Gauge(
            "scheduler_round_truncation_streak",
            "Consecutive truncated rounds per pool",
            ["pool"],
            registry=r,
        )
        # ---- self-healing solve path (solver/validate.py admission
        # firewall + solver/failover.py backend ladder) ----
        self.round_rejected = Counter(
            "scheduler_round_rejected_total",
            "Scheduling rounds rejected by the admission firewall, by "
            "first violated invariant (nothing committed; a postmortem "
            ".atrace bundle was captured for offline replay)",
            ["pool", "invariant"],
            registry=r,
        )
        self.solver_failover = Counter(
            "scheduler_solver_failover_total",
            "Rounds retried down the solver backend failover ladder",
            ["from", "to", "cause"],
            registry=r,
        )
        self.solver_rung_state = Gauge(
            "scheduler_solver_rung_state",
            "Failover-ladder circuit-breaker state per backend rung "
            "(0 = closed, 1 = half-open, 2 = open)",
            ["rung"],
            registry=r,
        )
        self.executor_heartbeat_age = Gauge(
            "scheduler_executor_heartbeat_age_seconds",
            "Seconds since each executor's last heartbeat",
            ["executor"],
            registry=r,
        )
        # ---- partition / lease-fencing surface (services/netchaos.py
        # chaos + the split-brain protocol in docs/architecture.md) ----
        self.fence_rejections = Counter(
            "scheduler_fence_rejections_total",
            "Lease/report RPCs rejected FAILED_PRECONDITION for carrying "
            "a stale fencing token",
            ["executor", "method"],
            registry=r,
        )
        self.executor_fence = Gauge(
            "scheduler_executor_fence",
            "Current monotonic fencing token per executor (bumped when "
            "its runs are reassigned after a partition)",
            ["executor"],
            registry=r,
        )
        self.executor_reconnects = Counter(
            "scheduler_executor_reconnects_total",
            "Heartbeats that healed a disconnected executor",
            ["executor"],
            registry=r,
        )
        self.reconnect_latency = Histogram(
            "scheduler_executor_reconnect_seconds",
            "Outage length: executor drop (heartbeat expiry) to the "
            "first heartbeat after the heal",
            buckets=(1, 5, 15, 60, 300, 900, 3600, 14400),
            registry=r,
        )
        # ---- two-level mesh surface (parallel/multihost.py): topology,
        # trace-time collective accounting of the compiled sharded round
        # program, and the per-host sharded-solve wall clock — the gauges
        # the DCN cost model in docs/architecture.md regresses against.
        self.solve_mesh_extent = Gauge(
            "scheduler_solve_mesh_extent",
            "Sharded-solve mesh extent by axis (hosts / chips)",
            ["axis"],
            registry=r,
        )
        self.solve_collective_sites = Gauge(
            "scheduler_solve_collective_sites",
            "Cross-shard collective call sites traced into the compiled "
            "round program, by kind (selects / fills / point_ops)",
            ["kind"],
            registry=r,
        )
        self.solve_collective_bytes = Gauge(
            "scheduler_solve_collective_bytes",
            "Bytes one shard receives per execution of all traced "
            "collective sites, by fabric level (ici / dcn)",
            ["level"],
            registry=r,
        )
        self.solve_dcn_scalars_per_select = Gauge(
            "scheduler_solve_dcn_scalars_per_select",
            "Cross-host scalars per candidate selection: one winner "
            "tuple per host (O(hosts x keys), chip count cancels)",
            registry=r,
        )
        self.shard_solve_time = Histogram(
            "scheduler_shard_solve_seconds",
            "Per-host wall clock of the sharded round solve",
            ["pool"],
            registry=r,
        )
        # ---- hot-window solve profile (solver/hotwindow.py): wall clock
        # per solve segment and the pass-1 loop mix, from the host-driven
        # kernel driver. The numbers future perf PRs regress against —
        # "the round is solve-bound" stops being one opaque histogram.
        self.solve_segment_time = Histogram(
            "scheduler_solve_segment_seconds",
            "Device solve wall clock by segment (setup / pass1 / "
            "gather / finish) within a round",
            ["pool", "segment"],
            buckets=(0.001, 0.01, 0.05, 0.2, 1, 5, 20, 60),
            registry=r,
        )
        self.solve_loops_by_kind = Gauge(
            "scheduler_solve_loops_by_kind",
            "Pass-1 while-loop iterations of the last solve by kind "
            "(gang = serial attempts, fill, merged_fill)",
            ["pool", "kind"],
            registry=r,
        )
        self.solve_rewindows = Gauge(
            "scheduler_solve_rewindows",
            "Hot-window re-gathers during the last solve's pass 1",
            ["pool"],
            registry=r,
        )
        self.solve_window_slots = Gauge(
            "scheduler_solve_window_slots",
            "Per-queue hot-window size of the last solve (0 = "
            "compaction disengaged)",
            ["pool"],
            registry=r,
        )
        # ---- flight recorder (trace/): capture volume from
        # the attached TraceRecorder, and the divergence counter the
        # replayer bumps when a re-solved round drifts from the
        # recorded decision stream (kinds: placement / loop_stream /
        # profile_regression).
        self.trace_rounds_recorded = Counter(
            "scheduler_trace_rounds_recorded",
            "Scheduling rounds appended to the flight-recorder bundle",
            ["pool"],
            registry=r,
        )
        self.trace_bytes_written = Counter(
            "scheduler_trace_bytes_written",
            "Bytes appended to the flight-recorder .atrace bundle",
            registry=r,
        )
        self.trace_replay_divergences = Counter(
            "scheduler_trace_replay_divergences",
            "Replayed-round divergences from the recorded decision "
            "stream, by classification",
            ["kind"],
            registry=r,
        )
        # ---- job-journey surface (services/job_timeline.py): how long
        # jobs wait and WHY — per-decision attribution instead of only
        # aggregate shares.
        self.job_rounds_to_schedule = Histogram(
            "scheduler_job_rounds_to_schedule",
            "Scheduling rounds from submission through lease, per leased "
            "job (1 = leased in its first round)",
            buckets=(1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233),
            registry=r,
        )
        self.job_queue_wait = Histogram(
            "scheduler_job_queue_wait_seconds",
            "Submission-to-lease wall clock per leased job, by queue",
            ["queue"],
            buckets=(0.1, 1, 5, 15, 60, 300, 1800, 7200, 86400),
            registry=r,
        )
        self.unschedulable_reason = Counter(
            "scheduler_unschedulable_reason_total",
            "Per-round per-job unschedulable verdicts, by reason",
            ["reason"],
            registry=r,
        )
        # ---- solver autopilot (autotune/, a later slice): the perf-only
        # parameter vector each pool currently runs with, and every
        # adopted online change — so an operator can see exactly when
        # and why the closed loop moved a knob.
        self.autotune_window_slots = Gauge(
            "scheduler_autotune_window_slots",
            "Hot-window size the autotune controller currently applies "
            "(per-queue slots; 0 = compaction disabled)",
            ["pool"],
            registry=r,
        )
        self.autotune_chunk_loops = Gauge(
            "scheduler_autotune_chunk_loops",
            "Budgeted pass-1 starting chunk stride the autotune "
            "controller currently applies",
            ["pool"],
            registry=r,
        )
        self.autotune_adjustments = Counter(
            "scheduler_autotune_adjustments_total",
            "Online parameter changes adopted by the autotune "
            "controller, by direction",
            ["pool", "direction"],
            registry=r,
        )
        self.autotune_store_entries = Gauge(
            "scheduler_autotune_store_entries",
            "Entries in the persisted tuning store (offline profiles + "
            "online adoptions)",
            registry=r,
        )
        # ---- what-if planner (whatif/, a later slice): plan volume/latency
        # on the bounded off-round-thread worker, the pending backlog
        # the backpressure cap guards, and drain progress through the
        # staged cordon -> voluntary completion -> preempt-requeue path.
        self.whatif_plans = Counter(
            "whatif_plans_total",
            "What-if plans completed, by kind (whatif / drain / parity)",
            ["kind"],
            registry=r,
        )
        self.whatif_plan_seconds = Histogram(
            "whatif_plan_seconds",
            "Wall clock of one what-if plan (fork + mutate + bounded "
            "rollout + diff), by kind",
            ["kind"],
            buckets=(0.01, 0.05, 0.2, 1, 5, 20, 60, 300),
            registry=r,
        )
        self.whatif_queue_depth = Gauge(
            "whatif_queue_depth",
            "What-if plans pending on the bounded planner worker",
            registry=r,
        )
        self.drain_jobs_preempted = Counter(
            "drain_jobs_preempted_total",
            "Jobs preempt-requeued by a drain's deadline (gang-aware)",
            ["executor"],
            registry=r,
        )
        self.drain_jobs_completed = Counter(
            "drain_jobs_completed_total",
            "Drained-executor jobs that completed voluntarily before "
            "the drain deadline",
            ["executor"],
            registry=r,
        )
        self.anti_entropy_resolutions = Counter(
            "scheduler_anti_entropy_resolutions_total",
            "Run resolutions produced by post-partition ExecutorSync "
            "(zombie / duplicate / orphaned / kept)",
            ["resolution"],
            registry=r,
        )
        # ---- front door (frontdoor/, a later slice): the sharded-ingest +
        # admission surface. Shard lag is the acked-but-undelivered
        # backlog per ingest shard (the soak's SLO input); admitted/shed
        # attribute intake decisions to TENANTS so an operator can find
        # the hot queue during an overload (docs/operations.md runbook).
        self.frontdoor_shard_lag = Gauge(
            "frontdoor_shard_lag_events",
            "Acked submissions not yet delivered into the main event "
            "log, per ingest shard",
            ["shard"],
            registry=r,
        )
        self.frontdoor_admitted = Counter(
            "frontdoor_admitted_total",
            "Jobs admitted through the front door, by tenant (queue)",
            ["tenant"],
            registry=r,
        )
        self.frontdoor_shed = Counter(
            "frontdoor_shed_total",
            "Jobs shed by admission control, by tenant and reason class "
            "(tenantRate / globalRate / overload)",
            ["tenant", "reason"],
            registry=r,
        )
        self.frontdoor_submit_time = Histogram(
            "frontdoor_submit_seconds",
            "Submit handler wall clock through admission + durable "
            "shard-WAL ack, by outcome (ok / shed / expired / error)",
            ["outcome"],
            buckets=(0.0005, 0.002, 0.01, 0.05, 0.2, 1, 5),
            registry=r,
        )
        self.frontdoor_deadline_drops = Counter(
            "frontdoor_deadline_drops_total",
            "Submissions dropped because the propagated client deadline "
            "expired, by stage (gate = before processing, enqueue = "
            "before the WAL append; acked work is never dropped)",
            ["stage"],
            registry=r,
        )
        self.frontdoor_delivered = Counter(
            "frontdoor_delivered_total",
            "Shard-ingester deliveries into the main log, by shard and "
            "outcome (published / duplicate = suppressed redelivery "
            "after a crash)",
            ["shard", "outcome"],
            registry=r,
        )
        # ---- round observatory (observe/): the host↔device
        # transfer ledger and compile telemetry. These are the numbers
        # the ROADMAP-1 device-resident-round refactor must move: bytes
        # uploaded per round (what residency would amortize away),
        # donated-buffer traffic (what the donation machinery already
        # avoids), and warm-cycle kernel builds (which must be zero).
        self.round_transfer_bytes = Gauge(
            "scheduler_round_transfer_bytes",
            "Bytes the last solved round moved across the host↔device "
            "boundary, by direction (up = host→device uploads, down = "
            "result materialization, donated = device buffers updated "
            "in place via donation — avoided traffic)",
            ["pool", "direction"],
            registry=r,
        )
        self.round_transfer_arrays = Gauge(
            "scheduler_round_transfer_arrays",
            "Array/buffer count behind scheduler_round_transfer_bytes "
            "for the last solved round",
            ["pool", "direction"],
            registry=r,
        )
        self.transfer_bytes_total = Counter(
            "scheduler_transfer_bytes_total",
            "Cumulative host↔device bytes booked by the round transfer "
            "ledger, by direction",
            ["direction"],
            registry=r,
        )
        self.xla_compiles = Counter(
            "scheduler_xla_compiles_total",
            "Kernel library builds (nvcc) observed during scheduling "
            "rounds (a warm steady state compiles nothing)",
            registry=r,
        )
        self.xla_retraces = Counter(
            "scheduler_xla_retraces_total",
            "Kernel library loads and symbol binds observed during "
            "scheduling rounds (a warm steady state loads nothing)",
            registry=r,
        )
        self.xla_compile_seconds = Counter(
            "scheduler_xla_compile_seconds",
            "Cumulative kernel-build (nvcc) wall clock spent inside "
            "scheduling rounds",
            registry=r,
        )
        self.xla_cache_events = Counter(
            "scheduler_xla_cache_events_total",
            "Kernel library cache lookups during scheduling rounds, by "
            "outcome (hit = found built / miss = built)",
            ["outcome"],
            registry=r,
        )
        # ---- SLO layer (services/slo.py): declared objectives over
        # round latency / queue wait / front-door submit latency, with
        # multi-window burn rates — what the soaks and tools/slo_gate.py
        # gate on, and what an operator pages on.
        self.slo_events = Counter(
            "scheduler_slo_events_total",
            "SLO-signal observations, by SLO name and verdict (good = "
            "within threshold, bad = breached it)",
            ["slo", "verdict"],
            registry=r,
        )
        self.slo_burn_rate = Gauge(
            "scheduler_slo_burn_rate",
            "Error-budget burn rate per SLO and window (1.0 = burning "
            "exactly the budget; the multiwindow alert fires when fast "
            "AND slow windows both exceed their thresholds)",
            ["slo", "window"],
            registry=r,
        )
        self.slo_compliance = Gauge(
            "scheduler_slo_compliance",
            "Good-event fraction per SLO over the tracker's full "
            "retention window (compare against the objective)",
            ["slo"],
            registry=r,
        )
        # ---- fairness observatory (observe/fairness.py):
        # the round OUTCOME surface. The full fair-share triple per
        # queue — demand-capped (scheduler_queue_fair_share above),
        # uncapped entitlement, and demand share — lets dashboards
        # distinguish "capped by demand" from "starved"; regret and the
        # starved-rounds streak are the starvation-alert inputs; the
        # attribution counter answers "who is preempting whom".
        self.fair_share_uncapped = Gauge(
            "scheduler_queue_fair_share_uncapped",
            "Uncapped adjusted fair share (the entitlement the queue "
            "would hold were its demand unbounded; drf.py water-filling "
            "triple)",
            ["pool", "queue"],
            registry=r,
        )
        self.queue_demand_share = Gauge(
            "scheduler_queue_demand_share",
            "Queue demand as DRF dominant-share cost of the round's "
            "full (running + queued) demand",
            ["pool", "queue"],
            registry=r,
        )
        self.fairness_regret = Gauge(
            "scheduler_fairness_regret",
            "Per-queue fairness error: entitlement (demand-capped "
            "adjusted fair share) minus delivered dominant share, "
            "floored at zero",
            ["pool", "queue"],
            registry=r,
        )
        self.fairness_jain = Gauge(
            "scheduler_fairness_jain",
            "Jain fairness index of the pool's delivered-per-weight "
            "shares over competing queues (1.0 = perfectly "
            "proportional)",
            ["pool"],
            registry=r,
        )
        self.fairness_starved_rounds = Gauge(
            "scheduler_fairness_starved_rounds",
            "Consecutive rounds the queue has been starved (below its "
            "entitlement with unsatisfied demand); 0 = healthy",
            ["pool", "queue"],
            registry=r,
        )
        self.fairness_starvation_alerts = Counter(
            "scheduler_fairness_starvation_alerts_total",
            "Multiwindow starvation alerts fired (K consecutive "
            "starved rounds AND starved in at least half of a 4xK "
            "trailing window)",
            ["pool", "queue"],
            registry=r,
        )
        self.fairness_policy_info = Gauge(
            "scheduler_fairness_policy_info",
            "Active fairness policy per pool (info-style gauge: the "
            "series labelled with the live policy reads 1, stale policy "
            "series read 0 after a flip)",
            ["pool", "policy"],
            registry=r,
        )
        self.solve_kernel_info = Gauge(
            "scheduler_solve_kernel_info",
            "Active solve kernel path per pool (info-style gauge: the "
            "series labelled with the path the last committed round "
            "actually ran — cuda/lax — reads 1; stale "
            "path series read 0 after a failover demotion or flip)",
            ["pool", "path"],
            registry=r,
        )
        self.preemption_attributed = Counter(
            "scheduler_preemption_attributed_total",
            "Round preemptions attributed to an aggressor queue, by "
            "mechanism (fairness = DRF rebalance, urgency = higher "
            "scheduled priority)",
            ["aggressor_queue", "mechanism"],
            registry=r,
        )

    def render(self) -> bytes:
        if not HAVE_PROMETHEUS:
            return b""
        return generate_latest(self.registry)


def serve_metrics(metrics: SchedulerMetrics, port: int):
    """Tiny HTTP endpoint serving /metrics (common.ServeMetrics).

    Returns (server, bound_port): port 0 binds an ephemeral port (tests
    stop hard-coding ports and racing each other for them), the same
    contract as health.serve_health."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = metrics.render()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]
