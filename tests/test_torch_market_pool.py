"""Port copy of tests/test_market.py: market-driven rounds (bid-price
ordering, market eviction, the spot price) and the idealised against
realised value (armada_tpu_torch/solver/idealised.py), run on the port.

Every case is the JAX package's, with the port's imports. `both` holds
the port's kernel on the CPU to the port's oracle, as the JAX package
holds its kernel to its oracle, and both to the JAX package's oracle on
the same inputs carried across, exactly. Each `calculate_idealised_value`
and `value_by_queue` call is twinned with the JAX package's on the same
inputs (`torch_control_plane.twinned`). The service case runs on the
host oracle, the JAX package's default backend.

(experimental in the reference, scheduling_algo.go:795-813;
MarketJobPriorityComparer / market_iterator.go)."""

import numpy as np
import pytest
import torch_cpu  # noqa: F401

import armada_tpu.solver.idealised as ref_idealised
from armada_tpu.snapshot.round import build_round_snapshot as ref_build_round_snapshot
from armada_tpu.solver.reference import ReferenceSolver as RefSolver
from armada_tpu_torch.core.config import PriorityClass, SchedulingConfig
from armada_tpu_torch.core.types import JobSpec, NodeSpec, QueueSpec, RunningJob
from armada_tpu_torch.snapshot.round import build_round_snapshot
from armada_tpu_torch.solver.kernel import solve_round
from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
from armada_tpu_torch.solver.reference import ReferenceSolver
from torch_control_plane import to_reference, twinned

@pytest.fixture(autouse=True)
def _twin_with_reference(monkeypatch):
    """Hold every idealised and realised value to the JAX package's."""
    import armada_tpu_torch.solver.idealised as idealised

    for name in ("calculate_idealised_value", "value_by_queue"):
        monkeypatch.setattr(idealised, name,
                            twinned(getattr(idealised, name), getattr(ref_idealised, name)))
    yield


MKT = SchedulingConfig(
    priority_classes={"m": PriorityClass("m", 1000, preemptible=True)},
    default_priority_class="m",
    market_driven=True,
    spot_price_cutoff=0.5,
)


def node(cpu="8"):
    return NodeSpec(id="n0", pool="default",
                    total_resources={"cpu": cpu, "memory": "32Gi"})


def bid_job(i, bid, queue="q", cpu="2", **kw):
    return JobSpec(id=f"j{i}", queue=queue, requests={"cpu": cpu, "memory": "1Gi"},
                   submitted_ts=float(i), bid_prices={"default": bid}, **kw)


def both(cfg, nodes, queues, running, queued):
    snap = build_round_snapshot(cfg, "default", nodes, queues, running, queued)
    oracle = ReferenceSolver(snap).solve()
    out = solve_round(pad_device_round(prep_device_round(snap)), device="cpu")
    ref = RefSolver(ref_build_round_snapshot(
        *to_reference((cfg, "default", nodes, queues, running, queued)))).solve()
    for key in ("assigned_node", "scheduled_mask", "preempted_mask",
                "scheduled_priority", "demand_capped_fair_share"):
        assert np.array_equal(getattr(oracle, key), getattr(ref, key)), key
    assert oracle.spot_price == ref.spot_price
    J = snap.num_jobs
    assert (oracle.assigned_node == out["assigned_node"][:J]).all()
    assert (oracle.scheduled_mask == out["scheduled_mask"][:J]).all()
    assert (oracle.preempted_mask == out["preempted_mask"][:J]).all()
    k_spot = float(out["spot_price"])
    if oracle.spot_price is None:
        assert np.isnan(k_spot)
    else:
        assert abs(k_spot - oracle.spot_price) < 1e-9
    return snap, oracle


def test_highest_bids_win():
    # 8 cpu; four 2-cpu jobs with bids 10,1,5,7 -> 10,7,5,1 all fit; add a
    # fifth low bid that doesn't
    queued = [bid_job(0, 10.0), bid_job(1, 1.0), bid_job(2, 5.0),
              bid_job(3, 7.0), bid_job(4, 0.5)]
    snap, res = both(MKT, [node()], [QueueSpec("q")], [], queued)
    scheduled = {snap.job_ids[j] for j in np.flatnonzero(res.scheduled_mask)}
    assert scheduled == {"j0", "j2", "j3", "j1"}  # top 4 bids
    assert not res.scheduled_mask[snap.job_ids.index("j4")]


def test_market_preempts_lower_bids():
    # node full of running low-bid jobs; higher-bid arrivals displace them
    running = [
        RunningJob(job=bid_job(i, 1.0), node_id="n0", scheduled_at_priority=1000)
        for i in range(4)
    ]
    queued = [bid_job(10 + i, 9.0) for i in range(2)]
    snap, res = both(MKT, [node()], [QueueSpec("q")], running, queued)
    assert res.scheduled_mask.sum() == 2  # both high bids on
    assert res.preempted_mask.sum() == 2  # two low bids pushed off


def test_spot_price_set_at_cutoff():
    # cutoff 0.5 of 8 cpu: bids descending 9,8,7,6 at 2 cpu each. Cost is
    # 0.25 after the first, exactly 0.5 after the second (not strictly
    # above), 0.75 after the third -> the third job (bid 7) sets the price.
    queued = [bid_job(i, 9.0 - i) for i in range(4)]
    snap, res = both(MKT, [node()], [QueueSpec("q")], [], queued)
    assert res.spot_price == 7.0


def test_non_preemptible_running_always_wins():
    # A running non-preemptible job carries an effectively infinite price:
    # market eviction still evicts it, but it always reschedules first.
    cfg = SchedulingConfig(
        priority_classes={
            "solid": PriorityClass("solid", 1000, preemptible=False),
            "m": PriorityClass("m", 1000, preemptible=True),
        },
        default_priority_class="m",
        market_driven=True,
    )
    running = [
        RunningJob(
            job=JobSpec(id="solid0", queue="q", priority_class="solid",
                        requests={"cpu": "6", "memory": "1Gi"},
                        bid_prices={"default": 0.1}),
            node_id="n0",
            scheduled_at_priority=1000,
        )
    ]
    queued = [bid_job(1, 999.0, cpu="6")]
    snap, res = both(cfg, [node()], [QueueSpec("q")], running, queued)
    assert res.preempted_mask.sum() == 0  # the non-preemptible job survived
    solid = snap.job_ids.index("solid0")
    assert res.assigned_node[solid] == 0


def test_equal_bid_prefers_running():
    # Anti-churn: at equal price a running job keeps its slot over a queued
    # job submitted earlier (market_iterator.go:218-222).
    running = [
        RunningJob(job=bid_job(0, 5.0, cpu="6"), node_id="n0",
                   scheduled_at_priority=1000)
    ]
    queued = [bid_job(1, 5.0, cpu="6").with_(submitted_ts=0.0)]
    snap, res = both(MKT, [node()], [QueueSpec("q")], running, queued)
    assert res.preempted_mask.sum() == 0
    assert res.assigned_node[snap.job_ids.index("j0")] == 0
    assert not res.scheduled_mask[snap.job_ids.index("j1")]


def test_two_queues_price_order_interleaves():
    queued = [bid_job(0, 3.0, queue="a"), bid_job(1, 9.0, queue="b"),
              bid_job(2, 6.0, queue="a"), bid_job(3, 1.0, queue="b")]
    snap, res = both(
        MKT, [node(cpu="6")], [QueueSpec("a"), QueueSpec("b")], [], queued
    )
    scheduled = {snap.job_ids[j] for j in np.flatnonzero(res.scheduled_mask)}
    # capacity 6 cpu = 3 jobs: bids 9, 6, 3 win across queues
    assert scheduled == {"j1", "j2", "j0"}


def test_idealised_vs_realised_value():
    """idealised_value.go:23: on a market pool, the idealised value prices
    the round as if the pool were one mega node with static requirements
    ignored. A high-bid job too big for any single node contributes to the
    idealised value but not the realised one (the expectation gap)."""
    from armada_tpu_torch.solver.idealised import (
        calculate_idealised_value,
        value_by_queue,
    )

    nodes = [
        NodeSpec(id=f"n{i}", pool="default",
                 total_resources={"cpu": "8", "memory": "32Gi"})
        for i in range(2)
    ]
    queues = [QueueSpec("q", 1.0)]
    # j0 needs 12 cpu: fits no node, fits the 16-cpu mega node. j1/j2 fit.
    queued = [
        bid_job(0, 10.0, cpu="12"),
        bid_job(1, 2.0, cpu="4"),
        bid_job(2, 1.0, cpu="4"),
    ]
    snap = build_round_snapshot(MKT, "default", nodes, queues, [], queued)
    result = ReferenceSolver(snap).solve()
    unit = {"cpu": "1"}

    def solve_fn(s):
        res = ReferenceSolver(s).solve()
        return {"scheduled_mask": res.scheduled_mask}

    realised = value_by_queue(snap, result.scheduled_mask, unit)
    idealised = calculate_idealised_value(
        MKT, "default", nodes, queues, [], queued, solve_fn, unit
    )
    # Realised: j1 (2.0 x 4) + j2 (1.0 x 4) = 12; j0 doesn't fit anywhere.
    assert realised["q"] == 12.0
    # Idealised: j0 (10 x 12) + j1 (2 x 4) = 128 on the 16-cpu mega node
    # (j2 no longer fits behind the higher-value j0).
    assert idealised["q"] == 128.0
    assert idealised["q"] > realised["q"]


def test_idealised_value_ignores_static_requirements():
    """Selectors that match no node are ignored on the mega node
    (StaticRequirementsIgnoringIterator)."""
    from armada_tpu_torch.solver.idealised import calculate_idealised_value

    nodes = [node()]
    queues = [QueueSpec("q", 1.0)]
    queued = [
        bid_job(0, 5.0, cpu="2",
                node_selector={"zone": "nowhere"}),
    ]

    def solve_fn(s):
        res = ReferenceSolver(s).solve()
        return {"scheduled_mask": res.scheduled_mask}

    idealised = calculate_idealised_value(
        MKT, "default", nodes, queues, [], queued, solve_fn, {"cpu": "1"}
    )
    assert idealised["q"] == 10.0  # 5.0 bid x 2 cpu units


def test_scheduler_service_reports_values():
    """The service wires idealised/realised value into reports + the
    report string on market pools."""
    from armada_tpu_torch.events import InMemoryEventLog
    from armada_tpu_torch.services.fake_executor import FakeExecutor, make_nodes
    from armada_tpu_torch.services.scheduler import SchedulerService
    from armada_tpu_torch.services.submit import SubmitService

    log = InMemoryEventLog()
    sched = SchedulerService(MKT, log, backend="oracle")
    submit = SubmitService(MKT, log, scheduler=sched)
    FakeExecutor("c", log, sched,
                 nodes=make_nodes("c", count=2, cpu="8", memory="32Gi"),
                 runtime_for=lambda j: 100.0).tick(0.0)
    submit.create_queue(QueueSpec("q"))
    submit.submit(
        "q", "s1",
        [JobSpec(id=f"j{i}", queue="", requests={"cpu": "4", "memory": "1Gi"},
                 bid_prices={"default": 2.0})
         for i in range(3)],
        now=0.0,
    )
    sched.cycle(now=1.0)
    rep = sched.reports.latest_reports()["default"]
    qr = rep.queues["q"]
    assert qr.realised_value == 3 * 2.0 * 4  # three 4-cpu jobs at bid 2.0
    assert qr.idealised_value >= qr.realised_value
    assert "idealisedValue" in rep.report_string()
