"""The bench's scheduling round on the port's types.

`build_inputs` is bench.py's `build_inputs` (the 1M x 50k flagship and
the 100k x 5k tracking round): N nodes of 32 cpu / 256Gi, 10 equal-weight
queues, queued jobs of 1/2/4/8 cpu drawn from a seed, plus running
preemptible jobs of 2 cpu in one hog queue so that eviction and fair
preemption run. By default it uses the scheduler's default fill
configuration (batch fill window 512, fast fill off); `fast_fill=True,
fill_window=2048` is bench.py's own configuration (its flagship and
burst rounds).

With `gang_every=k`, every k-th queued job opens a gang of 2, 4 or 8
identical members (same queue and request), as the JAX package's
mixed-fleet scenarios draw them (`parallel/scenarios.py`, `_gang_for`).
Gangs are placed member by member through the node selection chain, so a
round with gangs selects nodes where the bench's round only fills and
returns evicted jobs to their own nodes.
"""

from __future__ import annotations

import numpy as np

from .core.config import PriorityClass, SchedulingConfig
from .core.types import Gang, JobSpec, NodeSpec, QueueSpec, RunningJob

N_QUEUES = 10
N_RUNNING = 5000


def scheduling_config(n_running=N_RUNNING, fast_fill=False, fill_window=512):
    """The round's SchedulingConfig; `fast_fill` and `fill_window` set the
    fill configuration (`enableFastFill`, `batchFillWindow`)."""
    return SchedulingConfig(
        priority_classes={
            "high": PriorityClass("high", 30000, preemptible=False),
            "low": PriorityClass("low", 1000, preemptible=True),
        },
        default_priority_class="low",
        protected_fraction_of_fair_share=0.5 if n_running else 1.0,
        enable_fast_fill=fast_fill,
        batch_fill_window=fill_window,
    )


def build_inputs(n_jobs, n_nodes, n_running=N_RUNNING, n_queues=N_QUEUES, gang_every=0,
                 fast_fill=False, fill_window=512):
    """(config, pool, nodes, queues, running, queued) for
    `build_round_snapshot`; the config is `scheduling_config`'s."""
    cfg = scheduling_config(n_running, fast_fill, fill_window)
    rng = np.random.default_rng(0)
    nodes = [
        NodeSpec(
            id=f"node-{i:05d}",
            pool="default",
            total_resources={"cpu": "32", "memory": "256Gi"},
        )
        for i in range(n_nodes)
    ]
    queues = [QueueSpec(f"queue-{i:02d}", 1.0) for i in range(n_queues)]
    cpus = rng.choice([1, 2, 4, 8], size=n_jobs)
    qidx = rng.integers(0, n_queues, size=n_jobs)
    gang, left, lead = None, 0, 0
    queued = []
    for i in range(n_jobs):
        if left == 0 and gang_every and i % gang_every == 0:
            card = int(rng.choice([2, 4, 8]))
            gang, left, lead = Gang(id=f"gang-{i:07d}", cardinality=card), card, i
        g = lead if left else i
        queued.append(JobSpec(
            id=f"job-{i:07d}",
            queue=f"queue-{qidx[g]:02d}",
            priority_class="low",
            requests={"cpu": str(int(cpus[g])), "memory": f"{int(cpus[g]) * 2}Gi"},
            submitted_ts=float(i),
            gang=gang if left else None,
        ))
        if left:
            left -= 1
    # Running jobs all in one hog queue: over its fair share, so evicted
    # and mostly rescheduled, driving eviction and fair preemption.
    running = [
        RunningJob(
            job=JobSpec(
                id=f"run-{i:07d}",
                queue="queue-00",
                priority_class="low",
                requests={"cpu": "2", "memory": "4Gi"},
                submitted_ts=float(-n_running + i),
            ),
            node_id=f"node-{i % n_nodes:05d}",
            scheduled_at_priority=1000,
        )
        for i in range(n_running)
    ]
    return cfg, "default", nodes, queues, running, queued


def refill(dev, cfg):
    """A prepared (padded) round of `build_inputs` under the fill options
    of `cfg` (`scheduling_config(..., fast_fill=..., fill_window=...)`), as
    a fresh prep would build it. While the window stays above 0 and the
    round stays off the market, the fill options set only the fields of
    `kernel_prep.fill_fields`; every slot array is the same."""
    import dataclasses

    from .solver.kernel_prep import fill_fields

    if dev.batch_window <= 0 or cfg.batch_fill_window <= 0:
        raise ValueError("refill: the window must stay above 0 (it shapes the slot arrays)")
    if dev.market_driven or cfg.market_driven:
        raise ValueError("refill: a market round has no fill window")
    return dataclasses.replace(dev, **fill_fields(cfg))


# The policy variants of a round (`policy_inputs`, `repolicy`): queue
# weights 1, 2, ..., Q in name order, so that the priority policy's
# leading key decides something, and for the deadline policy queue q's
# deadline at DEADLINE_T0_S + DEADLINE_STEP_S * q, every third queue
# with none (+inf).
POLICY_KINDS = ("proportional", "priority", "deadline")
DEADLINE_T0_S = 1_700_000_000.0
DEADLINE_STEP_S = 3600.0


def _policy_deadline(rank: int) -> float:
    return float("inf") if rank % 3 == 2 else DEADLINE_T0_S + DEADLINE_STEP_S * rank


def policy_inputs(inputs, kind):
    """`build_inputs`' tuple under fairness policy `kind`: the config's
    default policy set, queue q (in name order) at priority factor
    1/(q + 1), and under the deadline policy each of its queued jobs
    carrying its queue's deadline annotation."""
    import dataclasses

    from .solver.policy import DEADLINE_ANNOTATION

    cfg, pool, nodes, queues, running, queued = inputs
    rank = {name: r for r, name in enumerate(sorted(q.name for q in queues))}
    queues = [dataclasses.replace(q, priority_factor=1.0 / (rank[q.name] + 1)) for q in queues]
    if kind == "deadline":
        queued = [
            dataclasses.replace(j, annotations={
                **j.annotations, DEADLINE_ANNOTATION: repr(_policy_deadline(rank[j.queue]))})
            if rank[j.queue] % 3 != 2 else j
            for j in queued
        ]
    cfg = dataclasses.replace(cfg, fairness_policy_default=kind)
    return cfg, pool, nodes, queues, running, queued


def repolicy(dev, kind):
    """A prepared (padded) round under fairness policy `kind`, its queue
    weights and deadlines set as `policy_inputs` sets them. For a round
    of `build_inputs` this is what a fresh prep of `policy_inputs(inputs,
    kind)` builds (only the policy spec, the weights and the deadlines
    differ), without a second host prep of a 1M-job round."""
    import dataclasses

    from .solver.policy import spec_from_config

    real = dev.queue_weight > 0
    rank = dev.queue_name_rank
    weight = np.where(real, rank + 1.0, 0.0).astype(dev.queue_weight.dtype)
    deadline = np.full(rank.shape, np.inf)
    if kind == "deadline":
        deadline = np.where(real, [_policy_deadline(int(r)) for r in rank], np.inf)
    return dataclasses.replace(
        dev,
        fairness_policy=spec_from_config(SchedulingConfig(fairness_policy_default=kind), "default"),
        queue_weight=weight,
        queue_deadline=deadline.astype(np.float64),
    )
