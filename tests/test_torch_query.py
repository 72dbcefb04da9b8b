"""Direct twins of the query side: the same stack built on both packages,
fed the same submissions, cycles, run errors, preemptions and UI
mutations, on the host oracle and on the kernel (the port's on the CPU).

Each stack is a scheduler service, a submit service and two fake
executors over one event log, followed by an in-memory Lookout store
(armada_tpu_torch/services/lookout_ingester.py), a SQLite one
(services/lookout_sqlite.py) and the event-stream index
(services/event_index.py), all synced to the log's end after each cycle;
a query API over each store and over the job database
(services/queryapi.py); and the Lookout HTTP server
(services/lookout_http.py) with binoculars (services/binoculars.py).

After every cycle, across the packages (exact equality throughout, in
the plain form of `torch_control_plane`, the scheduler's random run ids
dropped or replaced): the leases, the Lookout rows, every query of
`queries` (filters of every match type, annotation filters, orders and
pages, group-by with every aggregate, the error and run drilldowns, job
details and journeys) on each store and on the job database, every HTTP
body of `http_gets`, and the index's streams. Within each package: the
SQLite rows equal the in-memory rows and answer every query alike, the
per-queue counts by state equal the job database's, and the index's
streams equal a scan of the log. Lookout records carry across with
`utils.carry.to_port` and `to_reference`.
"""

import importlib
import json
import re
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import (
    PORT,
    REF,
    leases_view,
    lookout_view,
    plain,
    run_ids_of,
    scrub_run_ids,
    to_reference,
)

NOW = 1_000_000.0  # the wall clock the submit service stamps mutations with


def _runtime(job_id):
    return 25.0 + 10.0 * (int(job_id.rsplit("-", 1)[1]) % 3)


class Stack:
    def __init__(self, pkg, backend, tmp_path):
        m = lambda path: importlib.import_module(f"{pkg.name}.{path}")  # noqa: E731
        self.pkg, self.m = pkg, m
        cfg = pkg.SchedulingConfig(
            priority_classes={"low": pkg.PriorityClass("low", 1000, preemptible=True),
                              "high": pkg.PriorityClass("high", 30000, preemptible=False)},
            default_priority_class="low")
        self.log = pkg.InMemoryEventLog()
        self.sched = pkg.SchedulerService(cfg, self.log, backend=backend)
        self.submit = pkg.SubmitService(cfg, self.log, scheduler=self.sched)
        self.executors = [
            pkg.FakeExecutor(f"ex{k}", self.log, self.sched,
                             nodes=pkg.make_nodes(f"ex{k}", count=2, cpu="8", memory="32Gi"),
                             runtime_for=_runtime)
            for k in range(2)]
        rules = cfg.error_categories
        self.store = m("services.lookout_ingester").LookoutStore(self.log, error_rules=rules)
        self.sqlite = m("services.lookout_sqlite").SqliteLookoutStore(
            self.log, str(tmp_path / f"{pkg.name}-{backend}.db"), error_rules=rules)
        self.index = m("services.event_index").EventStreamIndex(self.log)
        qa = m("services.queryapi")
        self.qa = qa
        self.queries = {
            "memory": qa.QueryApi(lookout=self.store, timeline=self.sched.timeline),
            "sqlite": qa.QueryApi(lookout=self.sqlite, timeline=self.sched.timeline),
            "jobdb": qa.QueryApi(self.sched.jobdb, timeline=self.sched.timeline),
        }
        self.binoculars = m("services.binoculars").BinocularsService(self.sched, self.executors)
        self.http = m("services.lookout_http").LookoutHttpServer(
            self.queries["memory"], self.sched, self.submit, port=0, binoculars=self.binoculars)
        self.now = 0.0

    def close(self):
        self.http.stop()
        self.sqlite.close()

    def sync(self):
        self.store.sync()
        self.sqlite.sync()
        self.index.sync()
        assert self.store.lag_events == self.sqlite.lag_events == self.index.lag_events == 0

    def cycle(self):
        for ex in self.executors:
            ex.tick(self.now)
        self.sched.cycle(now=self.now)
        self.now += 10.0
        self.sync()

    def jobs(self, jobset, n, cpu, start, **kw):
        spec = self.pkg.JobSpec
        return [spec(id=f"{jobset}-{i}", queue="", requests={"cpu": cpu, "memory": "1Gi"},
                     priority=i % 4, annotations={"team": f"t{i % 3}"} if i % 4 else {}, **kw)
                for i in range(start, start + n)]

    def leased(self, jobset):
        """(job id, run id) of the jobset's first job, by id, with a run."""
        for j in sorted(self.sched.jobdb.read_txn().all_jobs(), key=lambda j: j.id):
            if j.jobset == jobset and j.latest_run is not None:
                return j.id, j.latest_run.id
        raise AssertionError(f"nothing of {jobset} leased")

    def publish(self, queue, jobset, *events):
        self.log.publish(self.pkg.events.EventSequence.of(queue, jobset, *events))

    def get(self, path):
        """The JSON body of GET `path`; an error status's with its code."""
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.http.port}{path}",
                                        timeout=30) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            return {"status": e.code, **json.loads(e.read())}

    def post(self, path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.http.port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", "X-Requested-With": "armada-lookout"},
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())


def _filters(qa):
    F = qa.JobFilter
    return {
        "queue": [F("queue", "qa")],
        "any_state": [F("state", ["running", "leased", "pending"], match="anyOf")],
        "starts": [F("job_id", "sb-", match="startsWith")],
        "contains": [F("jobset", "urg", match="contains")],
        "gt": [F("priority", 1, match="greaterThan")],
        "lt": [F("priority", 2, match="lessThan")],
        "gte": [F("submitted", 20.0, match="greaterThanOrEqualTo")],
        "lte": [F("last_transition", 30.0, match="lessThanOrEqualTo")],
        "exists": [F("error", match="exists")],
        "ann_exists": [F("team", match="exists", is_annotation=True)],
        "ann_exact": [F("team", "t1", is_annotation=True), F("queue", "qa")],
        "runtime": [F("runtime_s", 0.0, match="greaterThan")],
    }


ORDERS = (("submitted", "asc"), ("job_id", "desc"), ("last_transition", "desc"),
          ("priority", "asc"), ("runtime_s", "desc"), ("node", "asc"))
AGGREGATES = ["state_counts", "submitted_min", "submitted_max", "error_category_counts",
              "last_transition_max", "runtime_avg",
              {"field": "priority", "type": "max"}, {"field": "priority", "type": "min"},
              {"field": "submitted", "type": "average"}]


def queries(s, q):
    """Every query of the battery on `q`, in the plain form."""
    fs = _filters(s.qa)
    out = {}
    for name, flt in fs.items():
        for field, direction in ORDERS:
            for skip, take in ((0, 100), (2, 3)):
                rows, total = q.get_jobs(flt, s.qa.Order(field, direction), skip, take)
                out["jobs", name, field, direction, skip] = (rows, total)
    for by in ("queue", "state", "jobset", "node", "priority_class"):
        out["groups", by] = q.group_jobs(by, aggregates=AGGREGATES)
        out["groups", by, "filtered"] = q.group_jobs(
            by, fs["queue"], aggregates=["state_counts"], order_by="name", direction="asc",
            skip=1, take=2)
    out["groups", "team"] = q.group_jobs("team", group_by_annotation=True, aggregates=AGGREGATES,
                                         order_by="runtime_avg")
    out["errors"] = q.get_job_errors()
    out["errors", "qb"] = q.get_job_errors([s.qa.JobFilter("queue", "qb")], take=2)
    out["active"] = q.active_job_sets()
    for jid in ("sa-0", "sa-1", "sb-2", "sb-3", "su-8", "sc-1", "missing"):
        out["details", jid] = q.job_details(jid)
        out["trace", jid] = q.job_trace(jid)
    out["runs"] = sorted(
        (q.get_job_run_error(r), q.get_job_run_debug_message(r),
         q.get_job_run_termination_reason(r))
        for r in run_ids_of(s.sched.jobdb) | {"missing"})
    return out


def http_gets(s):
    """The HTTP bodies across the routes, with the query strings the UI
    sends."""
    q = urllib.parse.quote
    paths = [
        "/api/jobs?queue=qa&order=submitted&direction=asc&skip=1&take=4",
        "/api/jobs?filters=" + q(json.dumps([{"field": "team", "value": "t2",
                                              "match": "exact", "isAnnotation": True}])),
        "/api/jobs?filters=" + q(json.dumps([{"field": "priority", "value": 1,
                                              "match": "greaterThan"}])) + "&order=job_id",
        "/api/groups?by=queue&aggregates=" + q(json.dumps(["state_counts", "runtime_avg"])),
        "/api/groups?by=team&byAnnotation=1&aggregates=" + q(json.dumps(
            [{"field": "submitted", "type": "min"}, "state_counts"])),
        "/api/groups?by=state&orderBy=name&direction=asc&take=3",
        "/api/queues", "/api/fairshare", "/api/errors", "/api/prices",
        "/api/details/sa-1", "/api/details/sb-2", "/api/jobtrace/sa-1", "/api/jobtrace/su-8",
        "/api/jobtrace/sc-0",
        "/api/job/sa-1", "/api/logs/sa-1?tail=1", "/api/logs/sb-3",
    ]
    ids = sorted(run_ids_of(s.sched.jobdb))
    paths += [f"/api/runs/{rid}/{kind}" for rid in ids for kind in ("error", "debug",
                                                                      "termination")]
    out = {p.replace(rid, "<run>") if (rid := next((r for r in ids if r in p), None)) else p:
           s.get(p) for p in paths}
    out = sorted(out.items())
    report = s.get("/api/report")["report"]
    return out, re.sub(r"duration: [0-9.]+s", "duration: <s>", report)


def within(s):
    """The package's own checks: the SQLite store equals the in-memory
    one, answers every query alike, counts states per queue as the job
    database does; the index equals a scan of the log; the HTTP server's
    bodies equal direct calls."""
    assert lookout_view(s.sqlite) == lookout_view(s.store)
    mem = queries(s, s.queries["memory"])
    assert queries(s, s.queries["sqlite"]) == mem
    counts = {}
    for j in s.sched.jobdb.read_txn().all_jobs():
        key = (j.queue, j.state.value)
        counts[key] = counts.get(key, 0) + 1
    for store in (s.store, s.sqlite):
        got = {}
        for row in store.all_rows():
            got[row.queue, row.state] = got.get((row.queue, row.state), 0) + 1
        assert got == counts
    scan = {}
    for e in s.log.read(0, s.log.end_offset):
        scan.setdefault((e.sequence.queue, e.sequence.jobset), []).append(e.offset)
    for key, offsets in scan.items():
        assert s.index.offsets_from(*key, 0, limit=10**9) == offsets
    assert s.get("/api/fairness") == json.loads(json.dumps(s.sched.fairness.snapshot(),
                                                           default=str))
    assert s.get("/api/doctor") == json.loads(json.dumps(s.sched.doctor_report(), default=str))
    logs = s.binoculars.get_logs("sa-1", 100)
    assert s.get("/api/logs/sa-1")["lines"] == logs
    return mem


def observe(s):
    ids = run_ids_of(s.sched.jobdb)
    mem = within(s)
    return {
        "leases": leases_view(s.sched.jobdb),
        "rows": lookout_view(s.store, run_ids=False),
        "memory": scrub_run_ids(mem, ids),
        "jobdb": scrub_run_ids(queries(s, s.queries["jobdb"]), ids),
        "http": scrub_run_ids(http_gets(s), ids),
        "streams": {k: s.index.offsets_from(*k, 0, limit=10**9)
                    for k in sorted({(e.sequence.queue, e.sequence.jobset)
                                     for e in s.log.read(0, s.log.end_offset)})},
    }


def script(s):
    """The scenario, one step a cycle: (what to do before the cycle)."""
    high = dict(priority_class="high")

    def step0():
        s.submit.create_queue(s.pkg.QueueSpec("qa"))
        s.submit.create_queue(s.pkg.QueueSpec("qb", priority_factor=2.0))
        s.submit.submit("qa", "sa", s.jobs("sa", 8, "2", 0), now=s.now)
        s.submit.submit("qb", "sb", s.jobs("sb", 6, "4", 0), now=s.now)

    def step1():
        s.submit.submit("qa", "sa", s.jobs("sa", 4, "2", 8), now=s.now)

    def step2():
        ev = s.pkg.events
        (a, ra), (b, rb) = s.leased("sa"), s.leased("sb")
        s.failed = a
        s.publish("qa", "sa", ev.JobRunErrors(
            created=s.now, job_id=a, run_id=ra, error="oom killed: container",
            retryable=False, debug='{"phase": "running", "exit_code": 137}'),
            ev.JobErrors(created=s.now, job_id=a, error="oom killed: container"))
        s.publish("qb", "sb", ev.JobRunErrors(
            created=s.now, job_id=b, run_id=rb, error="Failed to pull image x",
            retryable=True, debug='{"phase": "pending"}'))

    def step3():
        s.submit.submit("qb", "surgent", s.jobs("su", 2, "8", 8, **high), now=s.now)
        s.submit.submit("qb", "sc", s.jobs("sc", 3, "16", 0), now=s.now)  # fits no node

    def step4():
        assert s.post("/api/reprioritize", {"queue": "qa", "jobset": "sa",
                                            "job_ids": ["sa-10"], "priority": 9}) == {
            "reprioritized": 1}
        assert s.post("/api/cancel", {"queue": "qa", "jobset": "sa",
                                      "job_ids": ["sa-11"]}) == {"cancelled": 1}

    def step5():
        # A queued jobset: a run that ends after its job is cancelled is
        # "cancelled" in the job database and "succeeded" in the Lookout
        # view, in both packages.
        assert s.post("/api/cancel", {"queue": "qb", "jobset": "sc"}) == {"cancelled": "jobset"}

    return [step0, step1, step2, step3, step4, step5, lambda: None, lambda: None]


@pytest.mark.parametrize("backend", ["oracle", "kernel"])
def test_stacks_match_reference(backend, monkeypatch, tmp_path):
    import armada_tpu.services.submit as ref_submit
    import armada_tpu_torch.device as port_device
    import armada_tpu_torch.services.submit as port_submit

    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    clock = types.SimpleNamespace(time=lambda: NOW, perf_counter=time.perf_counter)
    for mod in (ref_submit, port_submit):
        monkeypatch.setattr(mod, "_time", clock)
    stacks = [Stack(REF, backend, tmp_path), Stack(PORT, backend, tmp_path)]
    try:
        steps = [script(s) for s in stacks]
        for k in range(len(steps[0])):
            views = []
            for s, st in zip(stacks, steps):
                st[k]()
                s.sync()
                s.cycle()
                views.append(observe(s))
            for key in views[0]:
                assert views[1][key] == views[0][key], f"cycle {k}: {key}"
        s = stacks[1]
        rows = s.store.all_rows()
        states = {r.job_id: r.state for r in rows}
        assert states[s.failed] == "failed" and states["sa-11"] == "cancelled"
        assert {states[f"sc-{i}"] for i in range(3)} == {"cancelled"}
        assert s.store.get("sa-10").priority == 9 and s.sched.jobdb.get("sa-10").priority == 9
        assert any(r.termination_reason for row in rows for r in row.runs), "nothing preempted"
        assert s.queries["memory"].get_job_errors()
    finally:
        for s in stacks:
            s.close()


def test_sqlite_store_matches_in_memory_store_through_prune_and_restart(monkeypatch, tmp_path):
    """The port's SQLite view against its in-memory view over the same
    log: equal rows, queries and pruning; a reopened SQLite store
    resumes from its cursor and catches up with the suffix alone."""
    import armada_tpu_torch.device as port_device
    from armada_tpu_torch.services.lookout_sqlite import SqliteLookoutStore

    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    s = Stack(PORT, "kernel", tmp_path)
    try:
        steps = script(s)
        for step in steps[:4]:
            step()
            s.cycle()
            within(s)
        path = str(tmp_path / f"{PORT.name}-kernel.db")
        s.sqlite.close()
        reopened = SqliteLookoutStore(s.log, path, error_rules=s.store.error_rules)
        assert reopened.cursor == s.log.end_offset and reopened.sync() == 0
        s.sqlite = reopened
        s.queries["sqlite"] = s.qa.QueryApi(lookout=reopened, timeline=s.sched.timeline)
        for step in steps[4:]:
            step()
            s.cycle()
            within(s)
        cut = s.now - 25.0
        assert s.store.prune(cut) == s.sqlite.prune(cut) > 0
        assert lookout_view(s.sqlite) == lookout_view(s.store)
        assert queries(s, s.queries["sqlite"]) == queries(s, s.queries["memory"])
    finally:
        s.close()


def test_lookout_records_carry_across():
    """A Lookout row, its runs, a query row, a filter and an order of one
    package are the other's after `to_port` / `to_reference`, and compare
    with `==`."""
    import armada_tpu.services.lookout_ingester as ref_li
    import armada_tpu.services.queryapi as ref_qa
    import armada_tpu_torch.services.lookout_ingester as li
    import armada_tpu_torch.services.queryapi as qa
    from armada_tpu_torch.utils.carry import to_port

    run = li.LookoutRun("r1", executor="e", node="n", pool="p", leased=1.0, state="failed",
                        error="oom", debug="{}", termination_reason="")
    row = li.LookoutRow("j1", "q", "s", state="failed", priority=3, priority_class="low",
                        requests={"cpu": "1"}, annotations={"team": "t"}, submitted=1.0,
                        last_transition=2.0, error="oom", error_category="oom", runs=[run])
    jrow = qa.JobRow.from_lookout(row)
    records = [run, row, jrow, qa.JobFilter("team", "t", "exact", True), qa.Order("job_id", "desc")]
    ref = to_reference(records)
    assert [type(r) for r in ref] == [ref_li.LookoutRun, ref_li.LookoutRow, ref_qa.JobRow,
                                      ref_qa.JobFilter, ref_qa.Order]
    assert to_port(ref) == records and plain(ref) == plain(records)
    assert ref_qa.JobRow.from_lookout(ref[1]) == ref[2]
