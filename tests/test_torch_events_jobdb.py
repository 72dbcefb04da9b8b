"""The port's event log, ingester and job database against the JAX
package's: one event sequence, written with the JAX package's events,
goes into the reference's log as it is and into the port's through
`events.log.from_reference_events`; both ingesters materialise it and
the two job databases must be equal job by job and run by run.

The sequence covers submit, lease, pending, running, succeeded, failed
with the error categories (oom, lost executor, image pull, fatal and
retryable), cancel of a job and of a job set, reprioritise, preempt with
and without requeue, requeue after a failed run, a re-lease, and the
control-plane events the ingester hands to its settings hook.
"""

import pytest
import torch_cpu  # noqa: F401

from armada_tpu.core.config import SchedulingConfig
from armada_tpu.core.types import Gang, JobSpec
from armada_tpu.events import model as rev
from armada_tpu.events.log import InMemoryEventLog as RefLog
from armada_tpu.jobdb import JobDb as RefJobDb
from armada_tpu.jobdb.ingest import SchedulerIngester as RefIngester
from armada_tpu.jobdb.ingest import categorize_error as ref_categorize
from armada_tpu_torch.core.config import SchedulingConfig as PortConfig
from armada_tpu_torch.events import model as pev
from armada_tpu_torch.events.log import InMemoryEventLog as PortLog
from armada_tpu_torch.events.log import LogEntry, from_reference_events
from armada_tpu_torch.jobdb import JobDb as PortJobDb
from armada_tpu_torch.jobdb.ingest import SchedulerIngester as PortIngester
from armada_tpu_torch.jobdb.ingest import categorize_error as port_categorize
from armada_tpu_torch.utils.carry import to_port
from torch_control_plane import jobdb_view, plain


def _job(i, jobset="set1", **kw):
    return JobSpec(
        id=f"j{i}", queue="team", jobset=jobset,
        requests={"cpu": "2", "memory": "4Gi"}, submitted_ts=float(i), **kw,
    )


def _sequence():
    """(queue, jobset, events) in log order."""
    seq = []

    def put(jobset, *events, queue="team"):
        seq.append(rev.EventSequence.of(queue, jobset, *events, traceparent=f"tp-{len(seq)}"))

    put(rev.CONTROL_PLANE_JOBSET, rev.QueueUpsert(created=0.0, name="team", priority_factor=2.0),
        queue="")
    gang = Gang(id="g1", cardinality=2)
    put("set1", *[rev.SubmitJob(created=1.0, job=_job(i)) for i in range(6)],
        rev.SubmitJob(created=1.0, job=_job(6, gang=gang)),
        rev.SubmitJob(created=1.0, job=_job(7, gang=gang)))
    put("set2", *[rev.SubmitJob(created=2.0, job=_job(i, jobset="set2")) for i in (8, 9)],
        rev.SubmitJob(created=2.0, job=_job(10, jobset="set2"), deduplication_id="d10"))
    # Replayed submit: idempotent.
    put("set1", rev.SubmitJob(created=3.0, job=_job(0)))
    put("set1", *[
        rev.JobRunLeased(created=4.0, job_id=f"j{i}", run_id=f"r{i}a", executor="ex-a",
                         node_id=f"n{i % 3}", pool="default", scheduled_at_priority=1000)
        for i in (0, 1, 2, 3, 4, 5, 6, 7)
    ])
    put("set1", *[rev.JobRunPending(created=5.0, job_id=f"j{i}", run_id=f"r{i}a") for i in range(8)])
    put("set1", *[rev.JobRunRunning(created=6.0, job_id=f"j{i}", run_id=f"r{i}a") for i in range(8)])
    # Succeeded.
    put("set1", rev.JobRunSucceeded(created=7.0, job_id="j0", run_id="r0a"),
        rev.JobSucceeded(created=7.0, job_id="j0"))
    # Failed, fatal, categorised oom.
    put("set1", rev.JobRunErrors(created=8.0, job_id="j1", run_id="r1a",
                                 error="container OOMKilled: out of memory", retryable=False),
        rev.JobErrors(created=8.0, job_id="j1", error="out of memory"))
    # Failed, retryable (lost executor), requeued, leased again elsewhere,
    # then failed for good with an image-pull error.
    put("set1", rev.JobRunErrors(created=9.0, job_id="j2", run_id="r2a",
                                 error="executor ex-a timed out", retryable=True),
        rev.JobRequeued(created=9.0, job_id="j2"))
    put("set1", rev.JobRunLeased(created=10.0, job_id="j2", run_id="r2b", executor="ex-b",
                                 node_id="n9", pool="default", scheduled_at_priority=1000))
    put("set1", rev.JobRunErrors(created=11.0, job_id="j2", run_id="r2b",
                                 error="failed to pull image foo:latest", retryable=True),
        rev.JobErrors(created=11.0, job_id="j2", error="failed to pull image foo:latest"))
    # Reprioritised while running, then preempted and requeued.
    put("set1", rev.ReprioritiseJob(created=12.0, job_id="j3", priority=7))
    put("set1", rev.JobRunPreempted(created=13.0, job_id="j3", run_id="r3a",
                                    reason="preempted by queue other", requeue=True))
    # Preempted without requeue (terminal), a gang's both members.
    put("set1", rev.JobRunPreempted(created=14.0, job_id="j6", run_id="r6a", reason="gang"),
        rev.JobRunPreempted(created=14.0, job_id="j7", run_id="r7a", reason="gang"))
    # Cancel a running job and a queued job set.
    put("set1", rev.CancelJob(created=15.0, job_id="j4", reason="user"))
    put("set2", rev.CancelJobSet(created=16.0, reason="user"))
    # Events on terminal jobs are ignored.
    put("set1", rev.JobRunRunning(created=17.0, job_id="j0", run_id="r0a"))
    # Control-plane settings events.
    put(rev.CONTROL_PLANE_JOBSET, rev.ExecutorCordon(created=18.0, name="ex-a", cordoned=True),
        rev.ExecutorFenced(created=18.0, name="ex-b", fence=2),
        rev.PriorityOverride(created=18.0, queue="team", priority_factor=3.0),
        rev.FairnessPolicyChange(created=18.0, pool="default", policy="proportional"),
        queue="")
    return seq


def _ingest(log, jobdb, ingester_cls, rules, settings):
    ingester = ingester_cls(log, jobdb, error_rules=rules, settings_handler=settings.append)
    ingester.sync(limit=3)  # several batches
    return ingester


def test_one_event_sequence_gives_equal_job_databases():
    ref_log, port_log = RefLog(), PortLog()
    for seq in _sequence():
        ref_log.publish(seq)
    carried = from_reference_events(ref_log.read(0, 10_000))
    assert all(type(e) is LogEntry for e in carried)
    assert [e.offset for e in carried] == list(range(ref_log.end_offset))
    port_log.publish_many(e.sequence for e in carried)
    assert plain([e.sequence for e in port_log.read(0, 10_000)]) == plain(
        [e.sequence for e in ref_log.read(0, 10_000)])
    assert type(port_log.read(1, 1)[0].sequence.events[0]) is pev.SubmitJob

    rules = SchedulingConfig().error_categories
    assert PortConfig().error_categories == rules
    ref_db, port_db = RefJobDb(), PortJobDb()
    ref_settings, port_settings = [], []
    ref_ing = _ingest(ref_log, ref_db, RefIngester, rules, ref_settings)
    port_ing = _ingest(port_log, port_db, PortIngester, rules, port_settings)
    assert port_ing.cursor == ref_ing.cursor == ref_log.end_offset
    assert plain(port_settings) == plain(ref_settings)

    want = jobdb_view(ref_db)
    assert jobdb_view(port_db) == want
    assert port_db.serial == ref_db.serial
    assert sorted(port_db.changed_since(0)) == sorted(ref_db.changed_since(0))
    # The sequence reached every state and every error category it names.
    states = {row["state"] for row in want.values()}
    assert states == {"queued", "running", "succeeded", "failed", "cancelled", "preempted"}
    cats = {row["error_category"] for row in want.values()} - {""}
    assert cats == {"oom", "image-pull"}
    assert want["j2"]["runs"][0]["state"] == "failed" and len(want["j2"]["runs"]) == 2
    assert want["j2"]["failed_nodes"] == ("n2", "n9")
    assert want["j3"]["priority"] == 7 and want["j3"]["state"] == "queued"
    assert len(want) == 11
    # The indexes agree too.
    for q in ("queued_jobs", "leased_jobs", "failed_run_jobs"):
        r = sorted(j.id for j in getattr(ref_db.read_txn(), q)())
        p = sorted(j.id for j in getattr(port_db.read_txn(), q)())
        assert p == r, q


@pytest.mark.parametrize("error", [
    "executor ex-a timed out", "OOMKilled", "deadline exceeded", "ErrImagePull: pull image",
    "pod evicted", "segfault", "",
])
def test_error_categories_match_reference(error):
    rules = SchedulingConfig().error_categories
    assert port_categorize(error, rules) == ref_categorize(error, rules)


def test_dump_load_carried_equal():
    """A reference job database's dump, carried by `to_port`, loads into
    the port's database equal job by job."""
    ref_log = RefLog()
    for seq in _sequence():
        ref_log.publish(seq)
    ref_db = RefJobDb()
    RefIngester(ref_log, ref_db, error_rules=SchedulingConfig().error_categories).sync()
    port_db = PortJobDb()
    port_db.load(to_port(ref_db.dump()))
    assert jobdb_view(port_db) == jobdb_view(ref_db)
    assert port_db.serial == ref_db.serial
