"""Port copy of tests/test_pricer.py: indicative gang pricing and the
bid-price provider (armada_tpu_torch/solver/pricer.py,
armada_tpu_torch/services/pricing.py), run on the port.

Every case is the JAX package's, with the port's imports. Each call of
`price_gangs` and `job_price_band` is twinned with the JAX package's on
the same inputs carried across (`torch_control_plane.twinned`): the two
results, and the result dict handed in, are equal exactly. The
scheduler case runs on the host oracle, the JAX package's default
backend.

Mirrors the scenario families of the reference's pricer tests
(internal/scheduler/scheduling/pricer/{node_scheduler,gang_pricer}_test.go,
internal/scheduler/pricing/bid_price_service_test.go).
"""

import pytest
import torch_cpu  # noqa: F401

import armada_tpu.services.pricing as ref_pricing
import armada_tpu.solver.pricer as ref_pricer

from armada_tpu_torch.core.config import GangDefinition, PriorityClass, SchedulingConfig
from armada_tpu_torch.core.types import JobSpec, NodeSpec, QueueSpec, RunningJob
from armada_tpu_torch.services.pricing import (
    Bid,
    BidPriceSnapshot,
    ExternalBidPriceService,
    LocalBidPriceService,
    PRICE_BANDS,
    job_price_band,
    refresh_job_bids,
)
from armada_tpu_torch.snapshot.round import build_round_snapshot
from armada_tpu_torch.solver.pricer import (
    REASON_CARDINALITY_ZERO,
    REASON_DOES_NOT_FIT,
    REASON_EXCEEDS_CAPACITY,
    REASON_GANG_DOES_NOT_FIT,
    REASON_NOT_INDEXED,
    price_gangs,
)

from torch_control_plane import twinned

@pytest.fixture(autouse=True)
def _twin_with_reference(monkeypatch):
    """Hold every pricing call to the JAX package's, exactly."""
    g = globals()
    monkeypatch.setitem(g, "price_gangs",
                        twinned(g["price_gangs"], ref_pricer.price_gangs))
    monkeypatch.setitem(g, "job_price_band",
                        twinned(g["job_price_band"], ref_pricing.job_price_band))
    yield


MKT = SchedulingConfig(
    priority_classes={"m": PriorityClass("m", 1000, preemptible=True)},
    default_priority_class="m",
    market_driven=True,
)


def node(i=0, cpu="8", labels=None):
    return NodeSpec(
        id=f"n{i}",
        pool="default",
        total_resources={"cpu": cpu, "memory": "32Gi"},
        labels=labels or {},
    )


def running(i, bid, node_id="n0", cpu="2"):
    return RunningJob(
        job=JobSpec(
            id=f"r{i:02d}",
            queue="q",
            requests={"cpu": cpu, "memory": "1Gi"},
            bid_prices={"default": bid},
        ),
        node_id=node_id,
        scheduled_at_priority=1000,
    )


def snap_of(nodes, running_jobs, queued=()):
    return build_round_snapshot(
        MKT, "default", nodes, [QueueSpec("q")], list(running_jobs), list(queued)
    )


def shape(cpu="2", size=1, **kw):
    return GangDefinition(size=size, resources={"cpu": cpu, "memory": "1Gi"}, **kw)


def one_price(snap, sh, **kw):
    res = price_gangs(snap, {"s": sh}, **kw)["s"]
    return res


# ---- node_scheduler_test.go family -----------------------------------------


def test_empty_node_prices_at_zero():
    res = one_price(snap_of([node()], []), shape())
    assert res.evaluated and res.schedulable and res.price == 0.0


def test_free_capacity_prices_at_zero_despite_running_jobs():
    # 8 cpu, 2 used -> a 2-cpu member still fits free.
    res = one_price(snap_of([node()], [running(0, 5.0)]), shape())
    assert res.schedulable and res.price == 0.0


def test_price_is_cheapest_eviction():
    # Full node: bids 1, 5, 9. A 2-cpu member needs one eviction -> 1.0.
    jobs = [running(i, b, cpu="2") for i, b in enumerate([5.0, 1.0, 9.0, 7.0])]
    res = one_price(snap_of([node()], jobs), shape())
    assert res.schedulable and res.price == 1.0


def test_price_is_last_evicted_bid_when_multiple_needed():
    # Full 8-cpu node, four 2-cpu jobs bidding 1,2,3,4; a 6-cpu member
    # evicts the three cheapest -> price 3.0 (the max of the evicted set).
    jobs = [running(i, float(i + 1), cpu="2") for i in range(4)]
    res = one_price(snap_of([node()], jobs), shape(cpu="6"))
    assert res.schedulable and res.price == 3.0


def test_cheaper_node_wins():
    # n0 full of bid-9 jobs, n1 full of bid-2 jobs -> price 2.0.
    jobs = [running(i, 9.0, "n0", cpu="4") for i in range(2)] + [
        running(10 + i, 2.0, "n1", cpu="4") for i in range(2)
    ]
    res = one_price(snap_of([node(0), node(1)], jobs), shape())
    assert res.schedulable and res.price == 2.0


def test_unschedulable_when_too_big_for_any_node():
    # Two 8-cpu nodes: a 10-cpu member exceeds every node's total but not
    # pool capacity -> does-not-fit, not exceeds-capacity.
    res = one_price(snap_of([node(0), node(1)], []), shape(cpu="10"))
    assert res.evaluated and not res.schedulable
    assert res.unschedulable_reason == REASON_DOES_NOT_FIT


def test_non_preemptible_running_jobs_price_at_sentinel():
    cfg_np = SchedulingConfig(
        priority_classes={
            "m": PriorityClass("m", 1000, preemptible=True),
            "hard": PriorityClass("hard", 2000, preemptible=False),
        },
        default_priority_class="m",
        market_driven=True,
    )
    full = [
        RunningJob(
            job=JobSpec(
                id="np0",
                queue="q",
                priority_class="hard",
                requests={"cpu": "8", "memory": "1Gi"},
                bid_prices={"default": 3.0},
            ),
            node_id="n0",
            scheduled_at_priority=2000,
        )
    ]
    snap = build_round_snapshot(
        cfg_np, "default", [node()], [QueueSpec("q")], full, []
    )
    res = price_gangs(snap, {"s": shape()})["s"]
    # pricing.NonPreemptibleRunningPrice: schedulable only at the sentinel.
    assert res.schedulable and res.price == 1_000_000.0


# ---- gang_pricer_test.go family --------------------------------------------


def test_gang_on_empty_nodes_prices_zero():
    res = one_price(snap_of([node(0), node(1)], []), shape(size=2, cpu="8"))
    assert res.schedulable and res.price == 0.0


def test_gang_price_is_max_over_members():
    # Two full nodes: n0 evictable at 1.0, n1 at 4.0. A 2-member 8-cpu gang
    # must take both -> price 4.0.
    jobs = [running(0, 1.0, "n0", cpu="8"), running(1, 4.0, "n1", cpu="8")]
    res = one_price(snap_of([node(0), node(1)], jobs), shape(size=2, cpu="8"))
    assert res.schedulable and res.price == 4.0


def test_gang_members_consume_state_sequentially():
    # n0 free, n1 half-full with a bid-3 job. A 2-member gang of 5-cpu
    # members: member one takes n0 at price 0 and leaves only 3 cpu there,
    # so member two must evict on n1 -> gang price 3.0. Without sequential
    # state updates both members would price 0 on n0.
    jobs = [running(0, 3.0, "n1", cpu="4")]
    res = one_price(snap_of([node(0), node(1)], jobs), shape(size=2, cpu="5"))
    assert res.schedulable and res.price == 3.0


def test_gang_unschedulable_within_capacity():
    # Pool capacity is fine (16 cpu for 12 requested) but no single node can
    # take the second 6-cpu member once memory on n1 is exhausted by an
    # unevictable... simpler: n1 is unschedulable, so only n0's 8 cpu are
    # actually placeable -> gang-does-not-fit, not exceeds-capacity
    # (capacity counts both nodes' totals).
    n1 = NodeSpec(
        id="n1", pool="default",
        total_resources={"cpu": "8", "memory": "32Gi"}, unschedulable=True,
    )
    res = one_price(snap_of([node(0), n1], []), shape(size=2, cpu="6"))
    assert not res.schedulable
    assert res.unschedulable_reason == REASON_GANG_DOES_NOT_FIT


def test_uniformity_groups_cheapest_zone_wins():
    cfg = SchedulingConfig(
        priority_classes={"m": PriorityClass("m", 1000, preemptible=True)},
        default_priority_class="m",
        market_driven=True,
        indexed_node_labels=("zone",),
    )
    nodes = [
        node(0, labels={"zone": "a"}),
        node(1, labels={"zone": "a"}),
        node(2, labels={"zone": "b"}),
        node(3, labels={"zone": "b"}),
    ]
    # Zone a full at bid 7; zone b full at bid 3.
    jobs = [running(i, 7.0, f"n{i}", cpu="8") for i in range(2)] + [
        running(2 + i, 3.0, f"n{2 + i}", cpu="8") for i in range(2)
    ]
    snap = build_round_snapshot(cfg, "default", nodes, [QueueSpec("q")], jobs, [])
    res = price_gangs(
        snap, {"s": shape(size=2, cpu="8", node_uniformity="zone")}
    )["s"]
    assert res.schedulable and res.price == 3.0


def test_uniformity_label_not_indexed():
    res = one_price(
        snap_of([node()], []), shape(node_uniformity="never-on-any-node")
    )
    assert not res.schedulable
    assert res.unschedulable_reason == REASON_NOT_INDEXED


def test_cardinality_zero_and_exceeds_capacity():
    snap = snap_of([node()], [])
    res = price_gangs(snap, {"z": shape(size=0), "big": shape(size=100, cpu="8")})
    assert res["z"].unschedulable_reason == REASON_CARDINALITY_ZERO
    assert res["big"].unschedulable_reason == REASON_EXCEEDS_CAPACITY


def test_round_headroom_check():
    # The round already scheduled up to the fraction cap -> exceeds capacity.
    snap = snap_of([node()], [])
    used = snap.factory.from_map({"cpu": "8", "memory": "32Gi"}, ceil=True)
    res = price_gangs(snap, {"s": shape()}, scheduled_this_round=used)["s"]
    assert not res.schedulable
    assert res.unschedulable_reason == REASON_EXCEEDS_CAPACITY


def test_selector_restricts_candidates():
    cfg = SchedulingConfig(
        priority_classes={"m": PriorityClass("m", 1000, preemptible=True)},
        default_priority_class="m",
        market_driven=True,
        indexed_node_labels=("tier",),
    )
    nodes = [node(0, labels={"tier": "gold"}), node(1)]
    jobs = [running(0, 2.0, "n0", cpu="8")]  # gold node full at bid 2
    snap = build_round_snapshot(
        cfg, "default", nodes, [QueueSpec("q")], jobs,
        # a queued job referencing the selector interns the (tier, gold) pair
        [JobSpec(id="sel", queue="q", requests={"cpu": "1", "memory": "1Gi"},
                 node_selector={"tier": "gold"})],
    )
    res = price_gangs(
        snap, {"s": GangDefinition(size=1,
                                   resources={"cpu": "2", "memory": "1Gi"},
                                   node_selector={"tier": "gold"})}
    )["s"]
    # n1 is free but unlabeled; the selector forces the gold node -> 2.0.
    assert res.schedulable and res.price == 2.0


def test_pricing_sees_post_round_state():
    # A round fills the node with a queued bid-6 job; the pricer must see
    # that capacity as consumed-but-evictable (the reference prices the
    # nodedb AFTER the round, preempting_queue_scheduler.go:637-646).
    from armada_tpu_torch.solver.reference import ReferenceSolver

    queued = [
        JobSpec(id="big", queue="q", requests={"cpu": "8", "memory": "1Gi"},
                bid_prices={"default": 6.0})
    ]
    snap = snap_of([node()], [], queued)
    res = ReferenceSolver(snap).solve()
    assert res.scheduled_mask[snap.job_ids.index("big")]
    result = {
        "assigned_node": res.assigned_node,
        "scheduled_mask": res.scheduled_mask,
        "preempted_mask": res.preempted_mask,
    }
    pre = price_gangs(snap, {"s": shape()})["s"]
    post = price_gangs(snap, {"s": shape()}, result=result)["s"]
    assert pre.price == 0.0  # pre-round view: node still free
    assert post.schedulable and post.price == 6.0  # post-round: must evict


def test_pricing_has_no_side_effects():
    jobs = [running(i, float(i + 1), cpu="2") for i in range(4)]
    snap = snap_of([node()], jobs)
    before = snap.allocatable.copy()
    first = price_gangs(snap, {"a": shape(cpu="6")})
    second = price_gangs(snap, {"a": shape(cpu="6")})
    assert (snap.allocatable == before).all()
    assert first["a"] == second["a"]


# ---- pricing provider (bid_price_service_test.go family) --------------------


def test_local_bid_service_band_prices():
    svc = LocalBidPriceService(["default"], lambda: ["q1", "q2"])
    snap = svc.get_bid_prices()
    a = snap.get_price("q1", PRICE_BANDS["A"])["default"]
    h = snap.get_price("q2", PRICE_BANDS["H"])["default"]
    assert a == Bid(2.0, 2.0) and h == Bid(9.0, 9.0)


def test_changed_price_keys_diff():
    b1 = BidPriceSnapshot(
        id="1", timestamp=0.0,
        bids={("q", 1): {"p": Bid(1, 1)}, ("q", 2): {"p": Bid(2, 2)}},
    )
    b2 = BidPriceSnapshot(
        id="2", timestamp=1.0,
        bids={("q", 1): {"p": Bid(1, 1)}, ("q", 3): {"p": Bid(3, 3)}},
    )
    assert b2.changed_price_keys(b1) == {("q", 2), ("q", 3)}
    assert b2.changed_price_keys(None) == {("q", 1), ("q", 3)}
    assert b1.changed_price_keys(b1) == set()


def test_external_bid_service_fallback_phases():
    class FakeClient:
        def retrieve_bids(self):
            return {
                "queue_bids": {
                    "q": {"default": {1: {"queued": 5.0}}},
                },
                "fallback": {"q": {"default": {"queued": 1.0, "running": 2.0}}},
                "pool_resource_units": {"default": {"cpu": "1"}},
            }

    snap = ExternalBidPriceService(FakeClient()).get_bid_prices()
    # Band 1: queued from the band bid, running from the fallback.
    assert snap.get_price("q", 1)["default"] == Bid(5.0, 2.0)
    # Band 2 has no band bid: both phases from the fallback.
    assert snap.get_price("q", 2)["default"] == Bid(1.0, 2.0)
    assert snap.resource_units == {"default": {"cpu": "1"}}


def test_refresh_job_bids_touches_only_changed_keys():
    from armada_tpu_torch.jobdb import JobDb
    from armada_tpu_torch.jobdb.jobdb import Job

    db = JobDb()
    txn = db.write_txn()
    j_a = JobSpec(
        id="a", queue="q",
        requests={"cpu": "1"},
        annotations={"armadaproject.io/priceBand": "A"},
    )
    j_b = JobSpec(
        id="b", queue="q",
        requests={"cpu": "1"},
        annotations={"armadaproject.io/priceBand": "B"},
    )
    txn.upsert(Job(spec=j_a), Job(spec=j_b))
    txn.commit()
    assert job_price_band(j_a) == PRICE_BANDS["A"]

    first = BidPriceSnapshot(
        id="1", timestamp=0.0,
        bids={
            ("q", PRICE_BANDS["A"]): {"default": Bid(2.0, 2.5)},
            ("q", PRICE_BANDS["B"]): {"default": Bid(3.0, 3.5)},
        },
    )
    assert refresh_job_bids(db, first, None) == 2
    spec_a = db.read_txn().get("a").spec
    assert spec_a.bid_prices == {"default": (2.0, 2.5)}
    # The original spec object is never mutated in place (it is shared
    # with API threads); re-pricing installs a fresh spec via the txn.
    assert j_a.bid_prices == {}
    # Phase selection at snapshot build: queued bid for queued jobs.
    assert spec_a.bid_price("default") == 2.0
    assert spec_a.bid_price("default", running=True) == 2.5

    second = BidPriceSnapshot(
        id="2", timestamp=1.0,
        bids={
            ("q", PRICE_BANDS["A"]): {"default": Bid(2.0, 2.5)},  # unchanged
            ("q", PRICE_BANDS["B"]): {"default": Bid(9.0, 9.5)},
        },
    )
    assert refresh_job_bids(db, second, first) == 1
    txn2 = db.read_txn()
    assert txn2.get("b").spec.bid_prices == {"default": (9.0, 9.5)}
    assert txn2.get("a").spec.bid_prices == {"default": (2.0, 2.5)}

    # A job submitted under STABLE prices (no changed keys) must still be
    # priced — callers pass it via new_job_ids.
    j_c = JobSpec(
        id="c", queue="q",
        requests={"cpu": "1"},
        annotations={"armadaproject.io/priceBand": "A"},
    )
    txn3 = db.write_txn()
    txn3.upsert(Job(spec=j_c))
    txn3.commit()
    third = BidPriceSnapshot(id="3", timestamp=2.0, bids=second.bids)
    assert refresh_job_bids(db, third, second) == 0  # not known as new
    assert refresh_job_bids(db, third, second, new_job_ids=["c"]) == 1
    assert db.read_txn().get("c").spec.bid_prices == {"default": (2.0, 2.5)}


# ---- scheduler integration --------------------------------------------------


def test_scheduler_records_indicative_prices():
    from armada_tpu_torch.events import EventSequence, InMemoryEventLog, SubmitJob
    from armada_tpu_torch.services.scheduler import ExecutorHeartbeat, SchedulerService

    cfg = SchedulingConfig(
        priority_classes={"m": PriorityClass("m", 1000, preemptible=True)},
        default_priority_class="m",
        market_driven=True,
        gangs_to_price={
            "small": GangDefinition(size=1, resources={"cpu": "2", "memory": "1Gi"}),
            "huge": GangDefinition(size=64, resources={"cpu": "8", "memory": "1Gi"}),
        },
    )
    svc = SchedulerService(
        cfg,
        InMemoryEventLog(),
        backend="oracle",
        queues=[QueueSpec("q")],
        bid_price_provider=LocalBidPriceService(["default"], lambda: ["q"]),
    )
    svc.report_executor(
        ExecutorHeartbeat("ex", "default", [node()], last_seen=1.0)
    )
    svc.log.publish(
        EventSequence.of(
            "q", "js",
            SubmitJob(created=1.0, job=JobSpec(
                id="j0", queue="q", jobset="js",
                requests={"cpu": "1", "memory": "1Gi"},
            )),
        )
    )
    svc.cycle(now=2.0)
    report = svc.reports.by_pool["default"]
    assert set(report.indicative_prices) == {"small", "huge"}
    assert report.indicative_prices["small"].schedulable
    assert report.indicative_prices["small"].price == 0.0
    assert not report.indicative_prices["huge"].schedulable
    assert "indicative gang small" in report.report_string()


def test_post_round_eviction_priced_at_running_phase_bid():
    # A job the round just scheduled must be priced for eviction at its
    # RUNNING-phase bid: the reference reads job.GetBidPrice on the
    # post-round jobdb, where a just-leased job resolves as running
    # (preempting_queue_scheduler.go:637-646 + jobdb getBidPrice).
    from armada_tpu_torch.solver.reference import ReferenceSolver

    queued = [
        JobSpec(
            id="j0",
            queue="q",
            requests={"cpu": "8", "memory": "1Gi"},
            bid_prices={"default": (1.0, 10.0)},  # (queued, running)
        )
    ]
    snap = build_round_snapshot(MKT, "default", [node()], [QueueSpec("q")], [], queued)
    res = ReferenceSolver(snap).solve()
    assert res.scheduled_mask[snap.job_ids.index("j0")]
    result = {
        "assigned_node": res.assigned_node,
        "scheduled_mask": res.scheduled_mask,
        "preempted_mask": res.preempted_mask,
    }
    post = price_gangs(
        snap, {"s": GangDefinition(size=1, resources={"cpu": "8", "memory": "1Gi"})},
        result=result,
    )["s"]
    assert post.schedulable and post.price == 10.0


def test_external_bid_service_json_stringified_band_keys():
    # A response that round-tripped through JSON stringifies int dict keys;
    # band bids keyed "1" must still resolve, not fall to the fallback.
    class FakeClient:
        def retrieve_bids(self):
            return {
                "queue_bids": {"q": {"default": {"1": {"queued": 5.0, "running": 6.0}}}},
                "fallback": {"q": {"default": {"queued": 1.0, "running": 2.0}}},
            }

    snap = ExternalBidPriceService(FakeClient()).get_bid_prices()
    assert snap.get_price("q", 1)["default"] == Bid(5.0, 6.0)


def test_just_leased_nonpreemptible_priced_at_sentinel():
    # A queued NON-preemptible job the round just scheduled resolves to
    # NonPreemptibleRunningPrice in the post-round view (jobdb getBidPrice
    # returns the sentinel for any non-queued non-preemptible job).
    from armada_tpu_torch.snapshot.round import NON_PREEMPTIBLE_RUNNING_PRICE
    from armada_tpu_torch.solver.reference import ReferenceSolver

    cfg = SchedulingConfig(
        priority_classes={
            "np": PriorityClass("np", 2000, preemptible=False),
        },
        default_priority_class="np",
        market_driven=True,
    )
    queued = [
        JobSpec(
            id="j0",
            queue="q",
            priority_class="np",
            requests={"cpu": "8", "memory": "1Gi"},
            bid_prices={"default": (1.0, 10.0)},
        )
    ]
    snap = build_round_snapshot(cfg, "default", [node()], [QueueSpec("q")], [], queued)
    res = ReferenceSolver(snap).solve()
    assert res.scheduled_mask[snap.job_ids.index("j0")]
    assert snap.job_bid_running[0] == NON_PREEMPTIBLE_RUNNING_PRICE
    result = {
        "assigned_node": res.assigned_node,
        "scheduled_mask": res.scheduled_mask,
        "preempted_mask": res.preempted_mask,
    }
    post = price_gangs(
        snap, {"s": GangDefinition(size=1, resources={"cpu": "8", "memory": "1Gi"})},
        result=result,
    )["s"]
    # Only eviction candidate is the sentinel-priced job.
    assert post.schedulable and post.price == NON_PREEMPTIBLE_RUNNING_PRICE


def test_providers_and_refresh_equal_reference():
    """The bid providers quote what the JAX package's quote (bids and
    resource units; ids and timestamps are drawn fresh), and the bid
    refresh re-prices the same jobs to the same bids on both packages'
    job databases."""
    import armada_tpu.jobdb as ref_jobdb
    from armada_tpu_torch.jobdb import JobDb
    from armada_tpu_torch.jobdb.jobdb import Job
    from torch_control_plane import plain, to_reference

    class FakeClient:
        def retrieve_bids(self):
            return {
                "queue_bids": {"q": {"default": {1: {"queued": 5.0}, "2": {"running": 7.0}}}},
                "fallback": {"q": {"default": {"queued": 1.0, "running": 2.0}}},
                "pool_resource_units": {"default": {"cpu": "1"}},
            }

    pairs = [
        (LocalBidPriceService(["default", "b"], lambda: ["q1", "q2"]),
         ref_pricing.LocalBidPriceService(["default", "b"], lambda: ["q1", "q2"])),
        (ExternalBidPriceService(FakeClient()), ref_pricing.ExternalBidPriceService(FakeClient())),
    ]
    for port_svc, ref_svc in pairs:
        got, want = port_svc.get_bid_prices(), ref_svc.get_bid_prices()
        assert plain((got.bids, got.resource_units)) == plain(
            (want.bids, want.resource_units))
    snaps = [
        BidPriceSnapshot(id=str(i), timestamp=float(i), bids={
            ("q", PRICE_BANDS["A"]): {"default": Bid(2.0, 2.5)},
            ("q", PRICE_BANDS["B"]): {"default": Bid(3.0 + i, 3.5 + i)},
        })
        for i in range(2)
    ]
    specs = [JobSpec(id=f"j{i}", queue="q", requests={"cpu": "1"},
                     annotations={"armadaproject.io/priceBand": "AB"[i % 2]})
             for i in range(6)]
    port_db, ref_db = JobDb(), ref_jobdb.JobDb()
    for db, job_cls, carry in ((port_db, Job, lambda v: v),
                               (ref_db, ref_jobdb.jobdb.Job, to_reference)):
        txn = db.write_txn()
        txn.upsert(*(job_cls(spec=carry(spec)) for spec in specs))
        txn.commit()
    prev = (None, None)
    for snap in snaps:
        n_port = refresh_job_bids(port_db, snap, prev[0])
        n_ref = ref_pricing.refresh_job_bids(ref_db, to_reference(snap), prev[1])
        assert n_port == n_ref > 0
        prev = (snap, to_reference(snap))
        assert {j.id: j.spec.bid_prices for j in port_db.read_txn().all_jobs()} == {
            j.id: j.spec.bid_prices for j in ref_db.read_txn().all_jobs()}
