"""Port copy of the tests/test_metrics_liveness.py cases that need no
server: every labeled metric family of the port's
SchedulerMetrics (armada_tpu_torch/services/metrics.py) gets samples
from a short simulation (dead or never-set families fail loudly),
serve_metrics binds ephemeral ports, and the info-style gauges follow a
flip.

The sweep runs the port's simulator on the host oracle, as the JAX
package's does, and again on the port's kernel on the CPU, whose rounds
feed the round-observatory families themselves; an autotune controller
and a what-if plan against the simulator's scheduler feed the
`scheduler_autotune_*` and `whatif_*` families. The front door's
families are exempt by prefix and must stay sample-free here (their
liveness case runs in tests/test_torch_server.py); the metric family names are the JAX package's
(`test_metric_families_are_the_reference_families`).
"""

import urllib.request

import pytest
import torch_cpu  # noqa: F401

from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.services.metrics import (
    HAVE_PROMETHEUS,
    SchedulerMetrics,
    serve_metrics,
)

pytestmark = pytest.mark.skipif(
    not HAVE_PROMETHEUS, reason="prometheus_client unavailable"
)


def test_serve_metrics_port_zero_returns_bound_port():
    """Port 0 binds an ephemeral port and returns it, so tests stop
    hard-coding (and racing for) fixed ports; the text endpoint serves
    the exposition format."""
    m = SchedulerMetrics()
    server, port = serve_metrics(m, 0)
    try:
        assert port > 0
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics"
        ) as resp:
            body = resp.read()
            assert resp.headers["Content-Type"].startswith("text/plain")
        # Exposition text names every registered family, including the
        # job-journey additions.
        for family in (
            b"scheduler_job_rounds_to_schedule",
            b"scheduler_job_queue_wait_seconds",
            b"scheduler_unschedulable_reason_total",
            b"scheduler_cycle_seconds",
        ):
            assert family in body, family
    finally:
        server.shutdown()


# Labeled families legitimately silent in this test's sims — each needs a
# mode the short oracle run does not exercise. The test asserts these stay
# sample-FREE here, so an entry whose feature lands in the sim path must
# be removed (the list cannot rot into hiding dead metrics).
EXEMPT_LABELED = {
    # market mode only
    "scheduler_queue_idealised_value",
    "scheduler_queue_realised_value",
    "scheduler_indicative_gang_price",
    "scheduler_indicative_gang_schedulable",
    # sharded-solve (mesh) only
    "scheduler_solve_mesh_extent",
    "scheduler_solve_collective_sites",
    "scheduler_solve_collective_bytes",
    "scheduler_shard_solve_seconds",
    # partition / fencing chaos only (tests/test_netchaos.py covers)
    "scheduler_fence_rejections",
    "scheduler_executor_fence",
    "scheduler_executor_reconnects",
    "scheduler_anti_entropy_resolutions",
    # solver-fault chaos only (tests/test_chaos.py solver soak subset and
    # tests/test_solver_selfheal.py cover; scheduler_solver_rung_state is
    # NOT exempt — the ladder gauge refreshes every round, faults or not)
    "scheduler_round_rejected",
    "scheduler_solver_failover",
    # replay gate only (tests/test_trace_replay.py covers)
    "scheduler_trace_replay_divergences",
    # round-deadline truncation only (tests/test_round_deadline.py)
    "scheduler_rounds_truncated",
    # preemption rounds only (tests/test_fill.py etc. cover)
    "scheduler_jobs_preempted",
    "scheduler_jobs_preempted_by_type",
    # preemption rounds only (tests/test_fairness.py covers attribution)
    "scheduler_preemption_attributed",
    # device-resident buffer corruption only — never ticks in a healthy
    # run by design (tests/test_residency.py covers drift detection;
    # scheduler_snapshot_mode_total is NOT exempt — every round counts
    # the path that carried it)
    "scheduler_resident_drift",
}

# Front-door families are exempt from the sim sweep BY PREFIX (the sim
# publishes directly; the front door is off) — every one of them is
# liveness-asserted instead by test_frontdoor_families_live_after_short_soak,
# which auto-covers families added later (its port copy runs in
# tests/test_torch_server.py: it needs the ApiServer's submit handler).
FRONTDOOR_PREFIX = "frontdoor_"
# The front door's families are registered (the JAX package's names) and
# stay silent in this sweep.
WAITING_PREFIXES = (FRONTDOOR_PREFIX,)

# UNLABELED families legitimately untouched by this test's sims — each
# needs a mode the short oracle run does not exercise. Same anti-rot
# contract as EXEMPT_LABELED: the test asserts these stay UNTOUCHED
# here, so an entry whose feature lands in the sim path must be removed.
EXEMPT_UNLABELED = {
    # partition/heal chaos only (tests/test_netchaos.py covers)
    "scheduler_executor_reconnect_seconds",
    # sharded-solve (mesh) only
    "scheduler_solve_dcn_scalars_per_select",
}


def _instrument_unlabeled(m: SchedulerMetrics) -> dict:
    """Wrap every UNLABELED metric's mutators (inc/dec/set/observe) with
    counting shims, returning {family: call_count}. Unlabeled metrics
    always render a zero-valued sample, so rendered output cannot
    distinguish 'set to 0 every cycle' from 'registered and never
    wired' (exactly how scheduler_cycle_seconds sat dead in sims for
    four PRs while the ControlPlane loop observed it) — counting the
    mutator CALLS can."""
    touched: dict = {}
    for attr, metric in vars(m).items():
        if getattr(metric, "_labelnames", None):
            continue
        collect = getattr(metric, "collect", None)
        if collect is None:
            continue
        family = next(iter(collect())).name
        touched.setdefault(family, 0)
        for method_name in ("inc", "dec", "set", "observe"):
            orig = getattr(metric, method_name, None)
            if orig is None:
                continue

            def shim(*a, _orig=orig, _f=family, _t=touched, **k):
                _t[_f] += 1
                return _orig(*a, **k)

            setattr(metric, method_name, shim)
    return touched


def _labeled_sample_counts(m: SchedulerMetrics) -> dict:
    """family name -> sample count, for every LABELED metric attribute
    (unlabeled metrics always render a zero-valued sample, so presence
    tells nothing; labeled ones render samples only once .labels() was
    actually exercised — exactly the dead-wiring signal)."""
    counts = {}
    for attr, metric in vars(m).items():
        labelnames = getattr(metric, "_labelnames", None)
        if not labelnames:
            continue
        for family in metric.collect():
            counts[family.name] = counts.get(family.name, 0) + len(
                family.samples
            )
    return counts


@pytest.mark.parametrize("backend", ["oracle", "kernel"])
def test_every_labeled_family_live_after_short_sim(tmp_path, backend):
    """A short sim (fitting jobs + a can-never-fit job for the
    unschedulable path + an attached flight recorder and SLO tracker)
    must put samples in every labeled family except the explicitly
    exempted mode-gated ones and those of the seams that wait."""
    from armada_tpu_torch.sim.simulator import (
        ClusterSpec,
        JobTemplate,
        NodeTemplate,
        QueueSpecSim,
        ShiftedExponential,
        Simulator,
        WorkloadSpec,
    )

    sim = Simulator(
        [ClusterSpec(name="c", node_templates=(NodeTemplate(count=4, cpu="8"),))],
        WorkloadSpec(
            queues=(
                QueueSpecSim(
                    name="qa",
                    job_templates=(
                        JobTemplate(
                            id="fit", number=6, cpu="2",
                            # t>0: time-in-state observation treats a
                            # zero previous-state timestamp as unknown.
                            submit_time=5.0,
                            runtime=ShiftedExponential(minimum=20.0),
                        ),
                    ),
                ),
                QueueSpecSim(
                    name="qb",
                    job_templates=(
                        # Never fits: every round reports it unschedulable.
                        JobTemplate(id="huge", number=1, cpu="999"),
                    ),
                ),
            )
        ),
        backend=backend,
        device="cpu",
        cycle_interval=10.0,
        max_time=200.0,
        trace_path=str(tmp_path / "liveness.atrace"),
    )
    m = SchedulerMetrics()
    touched = _instrument_unlabeled(m)
    sim.scheduler.attach_metrics(m)
    from armada_tpu_torch.services.slo import SLOTracker

    sim.scheduler.attach_slo(SLOTracker(metrics=m))
    sim.run()
    if backend == "oracle":
        # The oracle sim runs no kernel round: drive the round
        # observatory's wiring itself with payloads of the shape the
        # kernel rounds emit, as the JAX package's test does.
        sim.scheduler._note_transfer(
            "default",
            {"bytes_up": 4096, "arrays_up": 61, "bytes_down": 512,
             "arrays_down": 9, "donated_bytes": 2048, "donated_buffers": 12},
            {"traces": 3, "compiles": 1, "compile_seconds": 0.5,
             "cache_hits": 1, "cache_misses": 1},
        )
        sim.scheduler._note_solve_kernel("default", "cuda")
    else:
        # The kernel rounds on the CPU build and load nothing: feed one
        # compile delta of a round that did.
        sim.scheduler._note_transfer(
            "default", {"bytes_up": 1, "arrays_up": 1},
            {"traces": 3, "compiles": 1, "compile_seconds": 0.5,
             "cache_hits": 1, "cache_misses": 1},
        )
    sim.scheduler._note_solve_profile(
        "default",
        {
            "setup_s": 0.01, "pass1_s": 0.1, "gather_s": 0.02,
            "finish_s": 0.01, "gang_loops": 1, "fill_loops": 2,
            "merged_fill_loops": 3, "rewindows": 1, "window_slots": 4096,
            "compacted": True,
        },
    )
    # The autotune surface (autotune/): drive the controller wiring with
    # a profile of the shape solve_round emits — an adoption fires the
    # adjustments counter, the params gauges update on every observation.
    from armada_tpu_torch.autotune import AutotuneController

    ctl = AutotuneController(
        SchedulingConfig(
            hot_window_slots=8, hot_window_min_slots=0,
            autotune_enabled=True, autotune_hysteresis_rounds=1,
            autotune_min_window_slots=4, autotune_max_window_slots=64,
        )
    )
    sim.scheduler.attach_autotune(ctl)
    adopted = ctl.observe_round(
        "default",
        {"compacted": True, "rewindows": 8, "gather_s": 0.01,
         "pass1_s": 0.2},
        metrics=m,
    )
    assert adopted is not None and adopted["direction"] == "grow"
    # The what-if planner surface (whatif/): one plan against the sim's
    # scheduler (its rollout on the scheduler's backend and device) puts
    # samples in whatif_plans_total / whatif_plan_seconds and
    # whatif_queue_depth.
    from armada_tpu_torch.whatif import WhatIfService, mutations_from_dicts

    wi = WhatIfService(sim.scheduler, metrics=m)
    plan = wi.plan(
        mutations_from_dicts(
            [{"kind": "inject_gang", "queue": "qa", "gang_cardinality": 2,
              "cpu": "2"}]
        ),
        rounds=2,
    )
    assert plan.injected
    # A tiny staged drain on a two-executor harness drives
    # drain_jobs_preempted_total / drain_jobs_completed_total through the
    # real event path.
    from armada_tpu_torch.core.config import PriorityClass
    from armada_tpu_torch.core.types import JobSpec, QueueSpec
    from armada_tpu_torch.events import InMemoryEventLog
    from armada_tpu_torch.services.fake_executor import FakeExecutor, make_nodes
    from armada_tpu_torch.services.scheduler import SchedulerService
    from armada_tpu_torch.services.submit import SubmitService

    drain_cfg = SchedulingConfig(
        priority_classes={"d": PriorityClass("d", 1000, preemptible=True)},
        default_priority_class="d",
    )
    dlog = InMemoryEventLog()
    dsched = SchedulerService(drain_cfg, dlog, backend="oracle")
    dsubmit = SubmitService(drain_cfg, dlog, scheduler=dsched)
    dsubmit.create_queue(QueueSpec("q"))
    runtimes = {"fast": 12.0}
    rt = lambda jid: runtimes.get(jid, 1e9)  # noqa: E731
    dex_a = FakeExecutor("dex-a", dlog, dsched, nodes=make_nodes("dex-a", count=1, cpu="8"),
                         runtime_for=rt)
    dex_b = FakeExecutor("dex-b", dlog, dsched, nodes=make_nodes("dex-b", count=1, cpu="8"),
                         runtime_for=rt)
    dsubmit.submit("q", "s", [
        JobSpec(id="fast", queue="q", requests={"cpu": "2", "memory": "1Gi"}, submitted_ts=0.0),
        JobSpec(id="slow", queue="q", requests={"cpu": "2", "memory": "1Gi"}, submitted_ts=1.0),
    ], now=0.0)

    def dcycle(t):
        for ex in (dex_a, dex_b):
            ex.tick(t)
        dsched.cycle(now=t)
        for ex in (dex_a, dex_b):
            ex.tick(t)

    dcycle(0.0)
    executor = dsched.jobdb.get("slow").latest_run.executor
    dsched.drains.start(executor, deadline_s=15.0, metrics=m)
    for k in range(1, 6):
        dcycle(10.0 * k)
    assert dsched.drains.status(executor)["preempted"]
    counts = _labeled_sample_counts(m)
    exempt = EXEMPT_LABELED
    if backend == "kernel":
        # Kernel rounds carry no per-job unschedulable reason (the JAX
        # package's kernel rounds neither); the oracle's do.
        exempt = exempt | {"scheduler_unschedulable_reason"}
    dead = sorted(
        name for name, n in counts.items()
        if n == 0 and name not in exempt and not name.startswith(WAITING_PREFIXES)
    )
    assert not dead, f"labeled metric families never set by the sim: {dead}"
    live_exempt = sorted(
        name for name, n in counts.items()
        if n > 0 and (name in exempt or name.startswith(WAITING_PREFIXES))
    )
    assert not live_exempt, (
        "exempted families now get samples in the sim — remove them from "
        f"EXEMPT_LABELED so they stay guarded: {live_exempt}"
    )
    dead_unlabeled = sorted(
        family for family, calls in touched.items()
        if calls == 0 and family not in EXEMPT_UNLABELED
        and not family.startswith(WAITING_PREFIXES)
    )
    assert not dead_unlabeled, (
        f"unlabeled metric families never mutated by the sim sweep: {dead_unlabeled}"
    )
    touched_exempt = sorted(
        family for family, calls in touched.items()
        if calls > 0 and (family in EXEMPT_UNLABELED or family.startswith(WAITING_PREFIXES))
    )
    assert not touched_exempt, (
        "exempted unlabeled families are now mutated in the sim — "
        f"remove them from EXEMPT_UNLABELED: {touched_exempt}"
    )
    rendered = m.render().decode()
    for attr, metric in vars(m).items():
        for family in getattr(metric, "collect", lambda: [])():
            assert family.name in rendered, family.name


def test_metric_families_are_the_reference_families():
    """The port registers the JAX package's metric families under the
    same names, labels and types."""
    import armada_tpu.services.metrics as ref_metrics

    def families(m):
        return sorted(
            (family.name, family.type, tuple(getattr(metric, "_labelnames", ())))
            for metric in vars(m).values()
            for family in getattr(metric, "collect", lambda: [])()
        )

    assert families(SchedulerMetrics()) == families(ref_metrics.SchedulerMetrics())


def test_fairness_policy_info_gauge_follows_flip():
    """scheduler_fairness_policy_info is an info-style gauge: the active
    policy's (pool, policy) series reads 1 and, on a flip, the previous
    policy's series drops to 0 instead of freezing — a dashboard keyed
    on ==1 must follow the flip."""
    from armada_tpu_torch.observe.fairness import FairnessTracker

    m = SchedulerMetrics()
    tracker = FairnessTracker()

    def value(policy):
        for fam in m.fairness_policy_info.collect():
            for s in fam.samples:
                if s.labels.get("pool") == "p" and (
                    s.labels.get("policy") == policy
                ):
                    return s.value
        return None

    tracker.observe_round("p", {"ledger": {"queues": [], "jain": 1.0}},
                          metrics=m)
    assert value("drf") == 1.0

    tracker.observe_round(
        "p",
        {"ledger": {"queues": [], "jain": 1.0, "policy": "proportional"}},
        metrics=m,
    )
    assert value("proportional") == 1.0
    assert value("drf") == 0.0


def test_solve_kernel_info_gauge_follows_flip():
    """scheduler_solve_kernel_info is an info-style gauge: the kernel
    path the pool's last committed round ran reads 1 and, on a flip
    (config change or a failover demotion off the "cuda" path on the
    CPU's ladder), the stale path's series drops to 0 instead of
    freezing — a dashboard keyed on ==1 must follow the demotion."""
    from armada_tpu_torch.services.scheduler import SchedulerService

    m = SchedulerMetrics()

    class Host:
        metrics = m

    host = Host()

    def value(path):
        for fam in m.solve_kernel_info.collect():
            for s in fam.samples:
                if s.labels.get("pool") == "p" and (
                    s.labels.get("path") == path
                ):
                    return s.value
        return None

    SchedulerService._note_solve_kernel(host, "p", "cuda")
    assert value("cuda") == 1.0

    # Failover demotion on the CPU's ladder: off the local:cuda rung onto
    # plain LOCAL, which runs the "lax" path.
    SchedulerService._note_solve_kernel(host, "p", "lax")
    assert value("lax") == 1.0
    assert value("cuda") == 0.0
