"""Market-driven rounds (bid order, the spot price, market eviction): the
port's solve_round against the JAX package's, on the CPU.

Each padded round goes through the reference's `solve_round` and the
port's on both paths, as tests/test_torch_policy.py does: decisions,
num_loops and spot_price bit-exact, fair shares within 4/16 ULP. The
rounds:

- the port's copies of tests/test_market.py's directed cases (the highest
  bids win, lower bids are preempted, the spot price at the cutoff, a
  non-preemptible running job wins, equal bids prefer the running job,
  two queues interleave by price), each with that test's own assertions
  on the port's output;
- `market_round` of parallel/scenarios.py at two small sizes, the larger
  one setting a spot price and preempting;
- the port's `market_round` and `mixed_fleet_rounds` equal to the
  reference's after each package's prep.

A market round takes no fill (prep sets its window to 0), so on the card
it launches no kernel of the port on one device; on a mesh its selects
close through the winner kernel (tests/test_torch_multihost_rounds.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu.core.config import PriorityClass, SchedulingConfig
from armada_tpu.core.types import JobSpec, NodeSpec, QueueSpec, RunningJob
from armada_tpu.snapshot.round import build_round_snapshot
from armada_tpu.solver.kernel_prep import pad_device_round, prep_device_round
from test_market import MKT, bid_job, node
from test_torch_policy import check_round_paths


def solve_both(cfg, nodes, queues, running, queued):
    """The round through both packages on both paths; (snapshot, the
    port's "cuda" outputs)."""
    snap = build_round_snapshot(cfg, "default", nodes, queues, running, queued)
    dev = pad_device_round(prep_device_round(snap))
    assert dev.market_driven and dev.batch_window == 0
    got = check_round_paths("market", dev)
    for _, stats in got.values():
        assert stats["fill_loops"] == stats["merged_fill_loops"] == 0
    return snap, got["cuda"][0]


def _scheduled_ids(snap, out):
    return {snap.job_ids[j] for j in np.flatnonzero(out["scheduled_mask"][: snap.num_jobs])}


def test_highest_bids_win():
    queued = [bid_job(0, 10.0), bid_job(1, 1.0), bid_job(2, 5.0), bid_job(3, 7.0), bid_job(4, 0.5)]
    snap, out = solve_both(MKT, [node()], [QueueSpec("q")], [], queued)
    assert _scheduled_ids(snap, out) == {"j0", "j2", "j3", "j1"}


def test_market_preempts_lower_bids():
    running = [
        RunningJob(job=bid_job(i, 1.0), node_id="n0", scheduled_at_priority=1000)
        for i in range(4)
    ]
    queued = [bid_job(10 + i, 9.0) for i in range(2)]
    snap, out = solve_both(MKT, [node()], [QueueSpec("q")], running, queued)
    assert out["scheduled_mask"].sum() == 2
    assert out["preempted_mask"].sum() == 2


def test_spot_price_set_at_cutoff():
    # Cutoff 0.5 of 8 cpu, bids 9, 8, 7, 6 at 2 cpu: the cost is exactly
    # 0.5 after the second job (not above), 0.75 after the third (bid 7).
    queued = [bid_job(i, 9.0 - i) for i in range(4)]
    _, out = solve_both(MKT, [node()], [QueueSpec("q")], [], queued)
    assert float(out["spot_price"]) == 7.0


def test_non_preemptible_running_always_wins():
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
                        requests={"cpu": "6", "memory": "1Gi"}, bid_prices={"default": 0.1}),
            node_id="n0",
            scheduled_at_priority=1000,
        )
    ]
    snap, out = solve_both(cfg, [node()], [QueueSpec("q")], running, [bid_job(1, 999.0, cpu="6")])
    assert out["preempted_mask"].sum() == 0
    assert out["assigned_node"][snap.job_ids.index("solid0")] == 0


def test_equal_bid_prefers_running():
    running = [
        RunningJob(job=bid_job(0, 5.0, cpu="6"), node_id="n0", scheduled_at_priority=1000)
    ]
    queued = [bid_job(1, 5.0, cpu="6").with_(submitted_ts=0.0)]
    snap, out = solve_both(MKT, [node()], [QueueSpec("q")], running, queued)
    assert out["preempted_mask"].sum() == 0
    assert out["assigned_node"][snap.job_ids.index("j0")] == 0
    assert not out["scheduled_mask"][snap.job_ids.index("j1")]


def test_two_queues_price_order_interleaves():
    queued = [bid_job(0, 3.0, queue="a"), bid_job(1, 9.0, queue="b"),
              bid_job(2, 6.0, queue="a"), bid_job(3, 1.0, queue="b")]
    snap, out = solve_both(MKT, [node(cpu="6")], [QueueSpec("a"), QueueSpec("b")], [], queued)
    assert _scheduled_ids(snap, out) == {"j1", "j2", "j0"}


def market_dev(n_nodes, n_jobs):
    from armada_tpu.parallel.scenarios import market_round

    return pad_device_round(prep_device_round(market_round(n_nodes, n_jobs)))


@pytest.mark.parametrize("n_nodes,n_jobs,priced", [(16, 64, False), (16, 256, True)])
def test_market_round_matches_reference(n_nodes, n_jobs, priced):
    """market_round(16, 256) crosses the cutoff (spot price set) and
    preempts; market_round(16, 64) never reaches the cutoff."""
    got = check_round_paths(f"market_round({n_nodes}, {n_jobs})", market_dev(n_nodes, n_jobs))
    out, stats = got["cuda"]
    assert np.isfinite(float(out["spot_price"])) == priced
    assert (int(out["preempted_mask"].sum()) > 0) == priced
    assert stats["gang_loops"] == int(out["num_loops"]) > 0


def _same_prepped(got, want):
    for f in dataclasses.fields(got):
        if f.name == "kernel_path":
            # The port's prep defaults to its "cuda" path, the reference's
            # to its own "lax".
            continue
        g, w = getattr(got, f.name), want[f.name]
        if isinstance(g, np.ndarray):
            w = np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True), f.name
        else:
            assert g == w, f.name


def test_mixed_fleet_rounds_equal_reference():
    """The port's copies of `market_round` and `mixed_fleet_rounds` build
    the reference's rounds: after each package's prep and padding, every
    field equal."""
    from armada_tpu.parallel.scenarios import mixed_fleet_rounds as ref_mixed
    from armada_tpu_torch.parallel.scenarios import mixed_fleet_rounds
    from armada_tpu_torch.solver.kernel_prep import pad_device_round as port_pad
    from armada_tpu_torch.solver.kernel_prep import prep_device_round as port_prep

    want = ref_mixed(256, 1024)
    got = mixed_fleet_rounds(256, 1024)
    assert [n for n, _ in got] == [n for n, _ in want] == ["home_away", "market"]
    for (_, g), (_, w) in zip(got, want):
        _same_prepped(port_pad(port_prep(g)), dataclasses.asdict(pad_device_round(prep_device_round(w))))
    market = port_pad(port_prep(got[1][1]))
    assert market.market_driven and market.node_total.shape[0] >= 32
