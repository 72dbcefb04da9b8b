"""The mixed-fleet rounds on the port's types: the JAX package's
`parallel/scenarios.py`, copied so that the port's tools and
chip_smoke.py can build the rounds without the JAX package.

One deterministic workload with the regimes the sharded-solve parity runs
cover:
  - a HOME pool whose config borrows an AWAY pool's tainted nodes
    (PoolConfig.away_pools and per-priority-class away node types), with
    fast fill on and a real burst, the batched regime the bench ships
    with;
  - a MARKET pool (market_driven: bid-price order, the spot price, and
    market eviction of every bound job);
  - mixed gangs (singletons and gangs of 2, 4 and 8), and running jobs
    that over-pack queues, so that eviction and the fair-preemption walk
    run.
Everything is seeded: every process of a multi-process run builds the
same snapshots.
"""

from __future__ import annotations

import numpy as np

from ..core.config import PoolConfig, RateLimits, SchedulingConfig
from ..core.priorities import AwayNodeType, PriorityClass
from ..core.types import Gang, JobSpec, NodeSpec, QueueSpec, RunningJob, Taint, Toleration
from ..snapshot.round import build_round_snapshot

_GPU_TAINT = Taint("gpu", "true", "NoSchedule")


def away_config() -> SchedulingConfig:
    """Home/away config: cpu jobs may run away on the gpu pool's tainted
    nodes at reduced priority; gpu-native jobs tolerate the taint."""
    return SchedulingConfig(
        priority_classes={
            "gpu-native": PriorityClass("gpu-native", 30000, preemptible=False),
            "cpu": PriorityClass(
                "cpu",
                10000,
                preemptible=True,
                away_node_types=(AwayNodeType(priority=500, well_known_node_type="gpu-node"),),
            ),
        },
        default_priority_class="cpu",
        well_known_node_types={"gpu-node": (_GPU_TAINT,)},
        pools=(PoolConfig(name="default", away_pools=("gpu",)), PoolConfig(name="gpu")),
        protected_fraction_of_fair_share=0.5,
        # The bench's fill mode and a real burst: the batched fast fill,
        # not one gang per loop.
        enable_fast_fill=True,
        rate_limits=RateLimits(
            maximum_scheduling_rate=4000.0,
            maximum_scheduling_burst=4000,
            maximum_per_queue_scheduling_rate=2000.0,
            maximum_per_queue_scheduling_burst=2000,
        ),
    )


def market_config() -> SchedulingConfig:
    return SchedulingConfig(
        priority_classes={"market": PriorityClass("market", 1000, preemptible=True)},
        default_priority_class="market",
        market_driven=True,
        spot_price_cutoff=0.5,
        pools=(PoolConfig(name="market"),),
    )


def _gang_for(i: int, rng) -> Gang | None:
    """Mixed gangs: 1 in 8 queued jobs opens a gang of 2, 4 or 8 members."""
    if i % 8 != 0:
        return None
    card = int(rng.choice([2, 4, 8]))
    return Gang(id=f"gang-{i:06d}", cardinality=card)


def home_away_round(n_nodes: int, n_jobs: int, n_queues: int = 6, seed: int = 7):
    """The HOME pool's round snapshot: 3/4 of the nodes in pool "default",
    1/4 tainted gpu nodes in pool "gpu" (borrowed through away_pools).
    Queued jobs are mostly cpu (they may go away), every 16th gpu-native
    and tolerating the taint; running jobs over-pack two queues to drive
    eviction."""
    rng = np.random.default_rng(seed)
    cfg = away_config()
    n_gpu = n_nodes // 4
    n_cpu = n_nodes - n_gpu
    nodes = [
        NodeSpec(id=f"cpu-{i:05d}", pool="default", total_resources={"cpu": "32", "memory": "128Gi"})
        for i in range(n_cpu)
    ] + [
        NodeSpec(id=f"gpu-{i:05d}", pool="gpu", taints=(_GPU_TAINT,),
                 total_resources={"cpu": "16", "memory": "64Gi"})
        for i in range(n_gpu)
    ]
    queues = [QueueSpec(f"q{i}", 1.0 + (i % 3)) for i in range(n_queues)]
    running = [
        RunningJob(
            job=JobSpec(
                id=f"run-{i:06d}",
                queue=f"q{i % 2}",  # two hog queues: balance eviction
                priority_class="cpu",
                requests={"cpu": "2", "memory": "4Gi"},
                submitted_ts=float(i),
            ),
            node_id=f"cpu-{i % n_cpu:05d}",
            scheduled_at_priority=10000,
        )
        for i in range(min(2 * n_cpu, n_jobs // 4))
    ]
    cpus = rng.choice([1, 2, 4], size=n_jobs)
    qidx = rng.integers(0, n_queues, size=n_jobs)
    gang = None
    gang_left = 0
    queued = []
    for i in range(n_jobs):
        if gang_left == 0:
            gang = _gang_for(i, rng)
            gang_left = gang.cardinality if gang is not None else 0
        native = i % 16 == 5
        queued.append(
            JobSpec(
                id=f"job-{i:06d}",
                queue=f"q{qidx[i]}",
                priority_class="gpu-native" if native else "cpu",
                requests={"cpu": str(int(cpus[i])), "memory": f"{int(cpus[i]) * 2}Gi"},
                submitted_ts=float(1000 + i),
                tolerations=((Toleration(key="gpu", value="true"),) if native else ()),
                gang=gang if gang_left > 0 else None,
            )
        )
        if gang_left > 0:
            gang_left -= 1
    return build_round_snapshot(cfg, "default", nodes, queues, running, queued)


def market_round(n_nodes: int, n_jobs: int, n_queues: int = 4, seed: int = 11):
    """The MARKET pool's round snapshot: bid-priced jobs, gangs bidding as
    one unit, running low-bid incumbents facing higher-bid arrivals."""
    rng = np.random.default_rng(seed)
    cfg = market_config()
    nodes = [
        NodeSpec(id=f"mkt-{i:05d}", pool="market", total_resources={"cpu": "16", "memory": "64Gi"})
        for i in range(n_nodes)
    ]
    queues = [QueueSpec(f"m{i}", 1.0) for i in range(n_queues)]
    running = [
        RunningJob(
            job=JobSpec(
                id=f"mrun-{i:06d}",
                queue=f"m{i % n_queues}",
                priority_class="market",
                requests={"cpu": "2", "memory": "4Gi"},
                submitted_ts=float(i),
                bid_prices={"market": 1.0 + (i % 3) * 0.25},
            ),
            node_id=f"mkt-{i % n_nodes:05d}",
            scheduled_at_priority=1000,
        )
        for i in range(min(n_nodes, n_jobs // 4))
    ]
    bids = rng.uniform(0.5, 10.0, size=n_jobs)
    gang = None
    gang_left = 0
    queued = []
    for i in range(n_jobs):
        if gang_left == 0:
            gang = _gang_for(i, rng)
            gang_left = gang.cardinality if gang is not None else 0
        queued.append(
            JobSpec(
                id=f"mjob-{i:06d}",
                queue=f"m{i % n_queues}",
                priority_class="market",
                requests={"cpu": str(1 + i % 3), "memory": f"{1 + i % 3}Gi"},
                submitted_ts=float(1000 + i),
                bid_prices={"market": round(float(bids[i]), 3)},
                gang=gang if gang_left > 0 else None,
            )
        )
        if gang_left > 0:
            gang_left -= 1
    return build_round_snapshot(cfg, "market", nodes, queues, running, queued)


def mixed_fleet_rounds(n_nodes: int, n_jobs: int, market_scale: float = 0.125):
    """The dryrun's rounds: the home/away round at the requested extent
    and a market round at `market_scale` of it."""
    mkt_nodes = max(16, int(n_nodes * market_scale))
    mkt_jobs = max(64, int(n_jobs * market_scale))
    return [
        ("home_away", home_away_round(n_nodes, n_jobs)),
        ("market", market_round(mkt_nodes, mkt_jobs)),
    ]
