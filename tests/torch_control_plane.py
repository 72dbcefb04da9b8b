"""Helpers of the port's control-plane tests: the same stack built from
the JAX package and from the port, and the plain form their records are
compared in.

`plain` turns dataclasses and enums of either package into dicts,
tuples and values, so a reference record and a port record compare with
`==`. `jobdb_view` is a job database in that form, keyed by job id; with
`run_ids=False` it drops the run ids, which the scheduler draws at random
(`events.model.new_id`), so two services fed the same events compare
equal. `Package` gathers one package's control-plane classes under the
same names, so a test case is written once and run against both.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import importlib
import types


def plain(value):
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,) + tuple(
            (f.name, plain(getattr(value, f.name))) for f in dataclasses.fields(value)
        )
    if isinstance(value, dict):
        return {plain(k): plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return tuple(plain(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return frozenset(plain(v) for v in value)
    return value


def job_view(job, run_ids=True):
    row = dict(
        spec=plain(job.spec),
        state=job.state.value,
        priority=job.priority,
        submitted=job.submitted,
        failed_nodes=tuple(job.failed_nodes),
        error=job.error,
        error_category=job.error_category,
        runs=tuple(
            dict(plain(run)[1:], **({} if run_ids else {"id": None}))
            for run in job.runs
        ),
    )
    return row


def jobdb_view(jobdb, run_ids=True):
    return {j.id: job_view(j, run_ids) for j in jobdb.read_txn().all_jobs()}


def leases_view(jobdb):
    """job id -> (state, executor, node, pool, priority) of its latest
    run: what the scheduler leased, without the random run ids."""
    out = {}
    for j in jobdb.read_txn().all_jobs():
        run = j.latest_run
        out[j.id] = (
            j.state.value,
            j.num_attempts,
            None if run is None else (
                run.executor, run.node_id, run.pool, run.scheduled_at_priority, run.state.value,
            ),
        )
    return out


class Package(types.SimpleNamespace):
    """One package's control-plane classes under common names. The
    port's SchedulerService and Simulator solve on the CPU."""

    def __init__(self, name):
        m = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
        port = name == "armada_tpu_torch"
        sched = m("services.scheduler").SchedulerService
        sim = m("sim.simulator")
        super().__init__(
            name=name,
            PriorityClass=m("core.config").PriorityClass,
            SchedulingConfig=m("core.config").SchedulingConfig,
            Gang=m("core.types").Gang,
            JobSpec=m("core.types").JobSpec,
            QueueSpec=m("core.types").QueueSpec,
            NodeSpec=m("core.types").NodeSpec,
            events=m("events"),
            InMemoryEventLog=m("events").InMemoryEventLog,
            JobState=m("jobdb").JobState,
            FakeExecutor=m("services.fake_executor").FakeExecutor,
            make_nodes=m("services.fake_executor").make_nodes,
            FaultPlan=m("services.chaos").FaultPlan,
            FaultSpec=m("services.chaos").FaultSpec,
            SchedulerService=functools.partial(sched, device="cpu") if port else sched,
            SubmitService=m("services.submit").SubmitService,
            SubmissionError=m("services.submit").SubmissionError,
            sim=sim,
            Simulator=functools.partial(sim.Simulator, device="cpu") if port else sim.Simulator,
        )


REF = Package("armada_tpu")
PORT = Package("armada_tpu_torch")
