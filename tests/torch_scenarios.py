"""Rounds shared by the port's parity tests (tests/test_torch_*.py).

Each scenario is (config, nodes, queues, running, queued) built from the
JAX package's types: the random sweeps of tests/test_kernel_parity.py and
its directed cases (rate limits, round fraction, lookback, eviction
rebalance, urgency preemption, gang uniformity, gang atomicity), and a
round that evicts with a gang among the arrivals.
`to_port` rebuilds any of those spec objects as the port's own types, so
the port's host prep can run from specs equal to the reference's, and
`to_reference` rebuilds the port's as the reference's.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

from armada_tpu.core.config import RateLimits, SchedulingConfig
from armada_tpu.core.types import Gang, JobSpec, NodeSpec, QueueSpec, RunningJob
from test_kernel_parity import PREEMPT_CFG, rand_scenario


def _convert(x, src, dst):
    """The same spec value with every dataclass of package `src` rebuilt
    from the same-named type of package `dst`."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        mod = type(x).__module__
        assert mod.startswith(src + "."), mod
        cls = getattr(importlib.import_module(dst + mod[len(src):]), type(x).__name__)
        return cls(**{
            f.name: _convert(getattr(x, f.name), src, dst)
            for f in dataclasses.fields(x)
            if f.init
        })
    if isinstance(x, tuple):
        return tuple(_convert(v, src, dst) for v in x)
    if isinstance(x, list):
        return [_convert(v, src, dst) for v in x]
    if isinstance(x, dict):
        return {_convert(k, src, dst): _convert(v, src, dst) for k, v in x.items()}
    return x


def to_port(x):
    """The same spec value built from armada_tpu_torch's types."""
    return _convert(x, "armada_tpu", "armada_tpu_torch")


def to_reference(x):
    """The same spec value built from the JAX package's types."""
    return _convert(x, "armada_tpu_torch", "armada_tpu")


def _one_node(cpu="32", mem="128Gi"):
    return [NodeSpec(id="n0", pool="default", total_resources={"cpu": cpu, "memory": mem})]


def _small_jobs(n):
    return [
        JobSpec(id=f"j{i}", queue="q", requests={"cpu": "1", "memory": "1Gi"}, submitted_ts=i)
        for i in range(n)
    ]


def _random(seed, **kw):
    nodes, queues, running, queued = rand_scenario(np.random.default_rng(seed), **kw)
    return PREEMPT_CFG, nodes, queues, running, queued


def _rate_limited():
    cfg = SchedulingConfig(rate_limits=RateLimits(maximum_scheduling_burst=3))
    return cfg, _one_node(), [QueueSpec("q")], [], _small_jobs(10)


def _round_fraction():
    cfg = SchedulingConfig(maximum_resource_fraction_to_schedule={"cpu": 0.25})
    return cfg, _one_node(), [QueueSpec("q")], [], _small_jobs(20)


def _lookback():
    return SchedulingConfig(max_queue_lookback=4), _one_node(), [QueueSpec("q")], [], _small_jobs(10)


def _running(queue, n, cpu, mem):
    return [
        RunningJob(
            job=JobSpec(id=f"r{i}", queue=queue, priority_class="low",
                        requests={"cpu": cpu, "memory": mem}, submitted_ts=i),
            node_id="n0",
            scheduled_at_priority=1000,
        )
        for i in range(n)
    ]


def _eviction_rebalance():
    queued = [
        JobSpec(id=f"j{i}", queue="newbie", priority_class="low",
                requests={"cpu": "4", "memory": "4Gi"}, submitted_ts=100 + i)
        for i in range(8)
    ]
    return (PREEMPT_CFG, _one_node(), [QueueSpec("hog"), QueueSpec("newbie")],
            _running("hog", 8, "4", "4Gi"), queued)


def _urgency_preemption():
    queued = [JobSpec(id="high0", queue="a", priority_class="high",
                      requests={"cpu": "8", "memory": "8Gi"}, submitted_ts=100)]
    return (PREEMPT_CFG, _one_node(), [QueueSpec("a"), QueueSpec("b")],
            _running("b", 4, "8", "8Gi"), queued)


def _gang_uniformity():
    nodes = [
        NodeSpec(id="a0", pool="default", labels={"zone": "a"},
                 total_resources={"cpu": "16", "memory": "64Gi"}),
        NodeSpec(id="b0", pool="default", labels={"zone": "b"},
                 total_resources={"cpu": "32", "memory": "128Gi"}),
        NodeSpec(id="b1", pool="default", labels={"zone": "b"},
                 total_resources={"cpu": "32", "memory": "128Gi"}),
    ]
    gang = Gang(id="g", cardinality=3, node_uniformity_label="zone")
    queued = [
        JobSpec(id=f"g{i}", queue="q", requests={"cpu": "16", "memory": "16Gi"},
                submitted_ts=i, gang=gang)
        for i in range(3)
    ]
    return SchedulingConfig(), nodes, [QueueSpec("q")], [], queued


def _gang_uniformity_impossible():
    nodes = [
        NodeSpec(id=f"{z}0", pool="default", labels={"zone": z},
                 total_resources={"cpu": "16", "memory": "64Gi"})
        for z in ("a", "b")
    ]
    gang = Gang(id="g", cardinality=3, node_uniformity_label="zone")
    queued = [
        JobSpec(id=f"g{i}", queue="q", requests={"cpu": "8", "memory": "8Gi"},
                submitted_ts=i, gang=gang)
        for i in range(3)
    ] + [JobSpec(id="solo", queue="q", requests={"cpu": "2", "memory": "2Gi"},
                 submitted_ts=10)]
    return SchedulingConfig(), nodes, [QueueSpec("q")], [], queued


def _gang_uniformity_unknown_label():
    nodes = [
        NodeSpec(id=f"n{i}", pool="default", total_resources={"cpu": "32", "memory": "128Gi"})
        for i in range(2)
    ]
    gang = Gang(id="g", cardinality=2, node_uniformity_label="rack")
    queued = [
        JobSpec(id=f"g{i}", queue="q", requests={"cpu": "1", "memory": "1Gi"},
                submitted_ts=i, gang=gang)
        for i in range(2)
    ]
    return SchedulingConfig(), nodes, [QueueSpec("q")], [], queued


def _gang_atomicity():
    nodes = [
        NodeSpec(id=f"n{i}", pool="default", total_resources={"cpu": "32", "memory": "128Gi"})
        for i in range(2)
    ]
    gang = Gang(id="g", cardinality=3)
    queued = [
        JobSpec(id=f"g{i}", queue="q", requests={"cpu": "20", "memory": "20Gi"},
                submitted_ts=i, gang=gang)
        for i in range(3)
    ] + [JobSpec(id="s0", queue="q", requests={"cpu": "4", "memory": "4Gi"}, submitted_ts=10)]
    return SchedulingConfig(), nodes, [QueueSpec("q")], [], queued


def _eviction_gang():
    """Balance eviction with a gang among the arrivals: a hog queue's
    running jobs on two nodes, then singletons and a gang of 2 from a new
    queue, so that evicted jobs return home while queued jobs fill and
    the gang selects nodes."""
    nodes = [
        NodeSpec(id=f"n{i}", pool="default", total_resources={"cpu": "32", "memory": "128Gi"})
        for i in range(2)
    ]
    running = [
        RunningJob(
            job=JobSpec(id=f"r{i}", queue="hog", priority_class="low",
                        requests={"cpu": "4", "memory": "4Gi"}, submitted_ts=i),
            node_id=f"n{i % 2}",
            scheduled_at_priority=1000,
        )
        for i in range(12)
    ]
    gang = Gang(id="g", cardinality=2)
    queued = [
        JobSpec(id=f"j{i}", queue="newbie", priority_class="low",
                requests={"cpu": "4", "memory": "4Gi"}, submitted_ts=100 + i,
                gang=gang if i in (6, 7) else None)
        for i in range(12)
    ]
    return PREEMPT_CFG, nodes, [QueueSpec("hog"), QueueSpec("newbie")], running, queued


SCENARIOS = {
    "random_queued": lambda: _random(0, with_running=False),
    "random_running": lambda: _random(13, with_running=True),
    "random_affinity": lambda: _random(24, with_running=True, with_affinity=True),
    "rate_limited": _rate_limited,
    "round_fraction": _round_fraction,
    "lookback": _lookback,
    "eviction_rebalance": _eviction_rebalance,
    "urgency_preemption": _urgency_preemption,
    "gang_uniformity": _gang_uniformity,
    "gang_uniformity_impossible": _gang_uniformity_impossible,
    "gang_uniformity_unknown_label": _gang_uniformity_unknown_label,
    "gang_atomicity": _gang_atomicity,
    "eviction_gang": _eviction_gang,
}
