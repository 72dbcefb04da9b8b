"""The port's what-if planner (armada_tpu_torch/whatif: forks, mutations,
the planner and its rollouts; services/submit_check.py) against the JAX
package's, on the CPU.

Every case of tests/test_whatif.py runs side by side on both packages
(`torch_control_plane.run_side_by_side`): each case's own assertions
hold on both, the leases after every cycle of every live scheduler
service are equal, and so are every rollout's leases and preemptions
(job by job: the cycle, node and executor of each lease, the cycle and
reason of each preemption), the reference's read off its ForkRollout,
the port's as its rollout process sends them back with the plan
(whatif/worker.py). A plan's `runtime_for` crosses to that process as
data, so the drain parity case passes its mapping of remaining seconds
where the reference's passes a closure over it. The planner-isolation
burst sheds requests by timing and forks whichever round is latest, so
there the live service's leases are compared alone. The reference's
`slow` marks stay on their cases (the "2x4" mesh parity and the
hotwindow and mesh fixture forks).

Direct twins, each exact (all of these are decisions):
- every mutation kind applied to the same ForkState gives equal states;
- a drain plan and an inject-gang plan on twinned live services (the
  port's kernel on the CPU against the reference's kernel) give equal
  `Plan.to_dict()` but for the plan's seconds, and equal rollout leases
  and preemptions, both rollouts in the port's one rollout process.

Rollouts in a process of their own (ROADMAP C3): a service with a round
budget takes a planner and leases as its twin without one while plans
run beside it, its plan the reference's; a plan that raises in the
rollout process raises in the caller with that process's traceback; a
rollout process killed mid-plan fails that plan loudly and the next plan
runs in a fresh one; a closure as `runtime_for` is refused in the caller;
a second plan on the same rollout process sends only the specs that
process does not hold yet, and plans as the first.
"""

import collections
import functools
import importlib
import itertools
import os
import signal
import threading
import time

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import PORT, REF, case_marks, leases_view, plain, run_side_by_side


def _cases():
    ref = importlib.import_module("test_whatif")
    return [("test_whatif", t) for t in sorted(vars(ref)) if t.startswith("test_")]


CASES = _cases()
# Plans on worker threads beside the live cycles (see the module docstring).
THREADED = ("test_planner_isolation_burst",)
# The port's mesh solves take their shards' device explicitly (one card
# each by default): the port's copy puts the "2x4" cases' shards on the
# CPU, in the live service (and so in its rollouts) and in parity_check.
# A plan's runtime_for crosses to the port's rollout process as data:
# the drain parity case's closure over `remaining` (1e9 for the jobs it
# does not name, the rollout's own horizon) becomes the mapping itself.
PORT_SUBS = (
    (r"SchedulerService\(CONFIG, log, backend=backend, mesh=mesh\)",
     'SchedulerService(CONFIG, log, backend=backend, mesh=mesh, device="cpu")'),
    (r'parity_check\(fork, "2x4"\)', 'parity_check(fork, "2x4", device="cpu")'),
    (r"runtime_for=lambda jid: remaining\.get\(jid, 1e9\)", "runtime_for=remaining"),
)


def test_every_whatif_case_is_collected():
    assert len(CASES) == 14


@pytest.mark.parametrize(
    "name, test",
    [pytest.param(n, t, marks=case_marks(n, t), id=f"{n}::{t}") for n, t in CASES],
)
def test_whatif_case_matches_reference(name, test, monkeypatch, tmp_path):
    monkeypatch.setattr(importlib.import_module("armada_tpu.whatif.mutations"),
                        "_inject_counter", itertools.count())
    rollouts = _record_rollouts(monkeypatch)
    run_side_by_side(name, test, monkeypatch, tmp_path, port_subs=PORT_SUBS,
                     first_only=test in THREADED)
    if test not in THREADED:
        assert rollouts["port"] == rollouts["ref"]


def _rollout(leases, preempts):
    return plain({"leases": dict(leases), "preempts": dict(preempts)})


def _record_rollouts(monkeypatch):
    """Every rollout's leases and preemptions, in the order the plans
    end: the reference's off its ForkRollout, the port's as its rollout
    process sends them back."""
    got = {"ref": [], "port": []}
    ref_planner = importlib.import_module("armada_tpu.whatif.planner")
    run = ref_planner.ForkRollout.run

    def recorded_run(self, *a, **k):
        out = run(self, *a, **k)
        got["ref"].append(_rollout(self.leases, self.preempts))
        return out

    monkeypatch.setattr(ref_planner.ForkRollout, "run", recorded_run)
    worker = importlib.import_module("armada_tpu_torch.whatif.worker")
    call = worker.Worker.call

    def recorded_call(self, payload):
        out = call(self, payload)
        got["port"].append(_rollout(out["leases"], out["preempts"]))
        return out

    monkeypatch.setattr(worker.Worker, "call", recorded_call)
    return got


# ---------------------------------------------------------------------------
# mutations on one ForkState
# ---------------------------------------------------------------------------


def _fork_state(P):
    """A ForkState of the package `P`: two executors of two nodes, three
    running jobs (one a gang member), two queued, a cordoned queue."""
    fork = importlib.import_module(f"{P.name}.whatif.fork")
    types_ = importlib.import_module(f"{P.name}.core.types")
    nodes = P.make_nodes("ex-a", count=2, cpu="8") + P.make_nodes("ex-b", count=2, cpu="8")
    gang = P.Gang(id="g", cardinality=2)
    jobs = [P.JobSpec(id=f"j{i}", queue="team", jobset="s",
                      requests={"cpu": "2", "memory": "1Gi"}, submitted_ts=float(i),
                      gang=gang if i < 2 else None)
            for i in range(5)]
    running = [types_.RunningJob(job=jobs[i], node_id=nodes[i].id,
                                 scheduled_at_priority=1000, leased_ts=1.0)
               for i in range(3)]
    return fork.ForkState(
        pool="default",
        config=P.SchedulingConfig(),
        nodes=list(nodes),
        queues=[P.QueueSpec("team"), P.QueueSpec("other", 2.0)],
        running=running,
        queued=jobs[3:],
        node_executor={n.id: n.executor for n in nodes},
        cordoned_queues={"other"},
    )


MUTATIONS = [
    {"kind": "cordon_node", "name": "ex-a-node-00000"},
    {"kind": "uncordon_node", "name": "ex-a-node-00001"},
    {"kind": "remove_node", "name": "ex-a-node-00001"},
    {"kind": "add_nodes", "count": 3, "cpu": "16", "memory": "64Gi", "executor": "ex-c"},
    {"kind": "cordon_executor", "name": "ex-b"},
    {"kind": "uncordon_executor", "name": "ex-b"},
    {"kind": "drain_executor", "name": "ex-a", "deadline_s": 30.0},
    {"kind": "inject_gang", "queue": "team", "gang_cardinality": 4, "cpu": "2"},
    {"kind": "inject_jobs", "queue": "new", "count": 3, "cpu": "1", "memory": "2Gi"},
    {"kind": "scale_queue", "name": "team", "weight": 4.0},
    {"kind": "scale_queue", "name": "fresh", "priority_factor": 3.0},
    {"kind": "policy", "policy": "proportional"},
]


def _state_view(state):
    """The state in plain form; of the config (whose defaults differ
    between the packages where their devices do: the port's kernel path
    is "cuda") the part a mutation edits, the per-pool policies."""
    import dataclasses

    view = dataclasses.replace(state, config=None)
    return plain(view), dict(state.config.fairness_policy_pools)


@pytest.mark.parametrize("mutation", MUTATIONS, ids=[
    f"{m['kind']}-{i}" for i, m in enumerate(MUTATIONS)])
def test_mutation_gives_the_reference_state(mutation):
    """One mutation applied to the same ForkState leaves equal states on
    both packages, and so does the whole vocabulary applied in a row
    after it; the injection counter starts at 0 on both."""
    states = {}
    for P in (REF, PORT):
        mutations = importlib.import_module(f"{P.name}.whatif.mutations")
        mutations._inject_counter = itertools.count()
        state = _fork_state(P)
        mutations.mutation_from_dict(mutation).apply(state)
        one = _state_view(state)
        state = _fork_state(P)
        for m in mutations.mutations_from_dicts(MUTATIONS):
            m.apply(state)
        states[P.name] = (one, _state_view(state),
                          mutations.mutation_from_dict(mutation).to_dict())
    assert states["armada_tpu_torch"] == states["armada_tpu"]


# ---------------------------------------------------------------------------
# plans on twinned live services
# ---------------------------------------------------------------------------


def _live(P, planner=True, **cfg_kw):
    """A live kernel service with two executors of two 8-cpu nodes and
    six 4-cpu jobs, one a gang of two, after two cycles; its planner has
    captured the second (rebuild) round. Returns the service, its
    planner (None without one), the package's whatif module, the
    executors and the submit service."""
    cfg = P.SchedulingConfig(
        priority_classes={"d": P.PriorityClass("d", 1000, preemptible=True)},
        default_priority_class="d",
        **cfg_kw,
    )
    log = P.InMemoryEventLog()
    sched = P.SchedulerService(cfg, log, backend="kernel", snapshot_mode="rebuild")
    submit = P.SubmitService(cfg, log, scheduler=sched)
    submit.create_queue(P.QueueSpec("team"))
    runtimes = {"j1": 25.0}
    ex = [P.FakeExecutor(name, log, sched, nodes=P.make_nodes(name, count=2, cpu="8"),
                         runtime_for=lambda jid: runtimes.get(jid, 1e9))
          for name in ("ex-a", "ex-b")]
    gang = P.Gang(id="g", cardinality=2)
    submit.submit("team", "s", [
        P.JobSpec(id=f"j{i}", queue="team", jobset="s",
                  requests={"cpu": "4", "memory": "1Gi"}, submitted_ts=float(i),
                  gang=gang if i >= 4 else None)
        for i in range(6)], now=0.0)
    whatif = importlib.import_module(f"{P.name}.whatif")
    wi = None
    if planner:
        wi = whatif.WhatIfService(sched)
        sched.attach_whatif(wi)
    for t in (0.0, 10.0):
        _cycle(sched, ex, t)
    return sched, wi, whatif, ex, submit


def _cycle(sched, executors, t):
    for e in executors:
        e.tick(t)
    sched.cycle(now=t)
    for e in executors:
        e.tick(t)


def _plan_dict(plan):
    out = plan.to_dict()
    out.pop("plan_seconds")
    return out


def test_plans_on_twinned_services_match_reference(monkeypatch):
    """A drain plan of ex-a and an inject-gang plan (cardinality 2, 4
    cpu, 3 rounds) on the live service of each package, the port's on its
    kernel on the CPU and the reference's on its kernel: equal plans (the
    drain's outcome, displaced jobs and landings, the injected gang's
    ETA and nodes, headroom, the fairness delta), but for the seconds.
    Each plan's rollouts boot services of their own on the live
    service's device."""
    import armada_tpu_torch.device as port_device

    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    rollouts = _record_rollouts(monkeypatch)
    plans = {}
    for P in (REF, PORT):
        importlib.import_module(f"{P.name}.whatif.mutations")._inject_counter = itertools.count()
        sched, wi, whatif, _, _ = _live(P)
        assert wi.capture.latest("default") is not None
        # The port's rollout process takes the runtimes as data.
        runtime_for = ({"j1": 15.0} if P is PORT
                       else (lambda jid: 15.0 if jid == "j1" else 1e9))
        drain = wi.plan_drain("ex-a", deadline_s=20.0, rounds=4, runtime_for=runtime_for)
        gang = wi.plan(whatif.mutations_from_dicts([
            {"kind": "inject_gang", "queue": "team", "gang_cardinality": 2,
             "cpu": "4", "memory": "1Gi"}]), rounds=3)
        plans[P.name] = [_plan_dict(drain), _plan_dict(gang)]
        if P is PORT:
            # Both rollouts ran in the planner's one rollout process.
            assert len(wi.rollouts.pids()) == 1 and os.getpid() not in wi.rollouts.pids()
            assert [x["kind"] for x in wi.plan_stats] == ["drain", "whatif"]
            assert [_rollout(x["leases"], x["preempts"]) for x in wi.plan_stats] == rollouts["port"]
            wi.close()
    assert plans["armada_tpu_torch"] == plans["armada_tpu"]
    assert len(rollouts["ref"]) == 2 and rollouts["port"] == rollouts["ref"]
    assert rollouts["port"][0]["preempts"] and rollouts["port"][1]["leases"]
    drain, gang = plans["armada_tpu_torch"]
    assert drain["drain"]["completed"] == ["j1"] and drain["drain"]["landings"]
    assert drain["displaced"]
    assert gang["injected"][0]["feasible"]


# ---------------------------------------------------------------------------
# rollouts in a process of their own (ROADMAP C3)
# ---------------------------------------------------------------------------

BUDGET_S = 5.0  # a round budget, Armada's maxSchedulingDuration
GANG = [{"kind": "inject_gang", "queue": "team", "gang_cardinality": 2, "cpu": "4",
         "memory": "1Gi"}]


@pytest.fixture
def on_cpu(monkeypatch):
    import armada_tpu_torch.device as port_device

    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")


def test_budgeted_service_takes_a_planner_and_leases_as_its_twin(on_cpu):
    """A service with a round budget takes a planner: three plans fired
    on threads run their rollouts in the planner's rollout process while
    the service cycles, and it leases what its twin without a planner
    leases after every cycle, fed the same jobs. The plan equals the
    reference's on the reference's budgeted service. (The port refused
    such a service while its rollouts ran on threads of the live process
    and slowed its rounds.)"""
    importlib.import_module("armada_tpu.whatif.mutations")._inject_counter = itertools.count()
    ref_sched, ref_wi, ref_whatif, _, _ = _live(REF, max_scheduling_duration_s=BUDGET_S)
    want = _plan_dict(ref_wi.plan(ref_whatif.mutations_from_dicts(GANG), rounds=3))

    a, wi, whatif, ex_a, submit_a = _live(PORT, max_scheduling_duration_s=BUDGET_S)
    b, none, _, ex_b, submit_b = _live(PORT, planner=False, max_scheduling_duration_s=BUDGET_S)
    assert none is None and leases_view(a.jobdb) == leases_view(b.jobdb)
    plans, errors = [], []

    def fire():
        try:
            plans.append(wi.plan(whatif.mutations_from_dicts(GANG), rounds=3))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=fire) for _ in range(3)]
    for th in threads:
        th.start()
    for k in range(2, 8):
        for submit in (submit_a, submit_b):
            submit.submit("team", "s", [PORT.JobSpec(
                id=f"k{k}-{i}", queue="team", jobset="s",
                requests={"cpu": "2", "memory": "1Gi"}, submitted_ts=10.0 * k)
                for i in range(2)], now=10.0 * k)
        _cycle(a, ex_a, 10.0 * k)
        _cycle(b, ex_b, 10.0 * k)
        assert leases_view(a.jobdb) == leases_view(b.jobdb), f"cycle {k}"
    for th in threads:
        th.join(timeout=300)
    assert not errors and len(plans) == 3
    assert len(wi.rollouts.pids()) == 1 and os.getpid() not in wi.rollouts.pids()
    assert len(wi.plan_stats) == 3 and wi._pending == 0
    wi.close()
    # Serial 0 on both sides: the reference's counter was reset, and the
    # port's plans ran in a fresh process, which counts from 0.
    assert _plan_dict(plans[0]) == want


def test_a_plan_that_raises_in_the_rollout_process_raises_in_the_caller(on_cpu):
    """A drain of an executor the fork does not hold raises the
    reference's KeyError in the caller, with the rollout process's
    traceback as its cause; the planner then plans on."""
    sched, wi, whatif, _, _ = _live(PORT)
    with pytest.raises(KeyError, match="not in the fork") as err:
        wi.plan_drain("nope", rounds=1)
    assert "Traceback" in str(err.value.__cause__) and "mutations.py" in str(err.value.__cause__)
    assert wi._pending == 0 and wi.rollouts.restarts == 0
    assert wi.plan(whatif.mutations_from_dicts(GANG), rounds=1).injected
    wi.close()


def test_a_rollout_process_that_dies_fails_its_plan_and_is_restarted(on_cpu):
    """The rollout process killed while it holds a plan: that plan fails
    with RolloutWorkerDied, never silently, and the next plan runs in a
    fresh process."""
    sched, wi, whatif, _, _ = _live(PORT)
    out = {}

    def first():
        try:
            out["plan"] = wi.plan(whatif.mutations_from_dicts(GANG), rounds=1)
        except Exception as e:  # noqa: BLE001 - asserted below
            out["error"] = e

    th = threading.Thread(target=first)
    th.start()
    deadline = time.monotonic() + 120
    while not wi.rollouts.pids():
        assert time.monotonic() < deadline, "no rollout process started"
        time.sleep(0.005)
    (pid,) = wi.rollouts.pids()
    os.kill(pid, signal.SIGKILL)
    th.join(timeout=120)
    assert isinstance(out.get("error"), whatif.RolloutWorkerDied), out
    assert wi.rollouts.restarts == 1 and wi._pending == 0
    plan = wi.plan(whatif.mutations_from_dicts(GANG), rounds=1)
    assert plan.injected and wi.rollouts.pids() and pid not in wi.rollouts.pids()
    wi.close()


def test_unpicklable_runtime_for_is_refused(on_cpu):
    """A plan's runtime_for crosses to the rollout process: a closure is
    refused in the caller with a clear error, before the plan takes a
    backlog slot or starts a process; the same runtimes as a mapping or
    as a picklable callable plan alike."""
    sched, wi, whatif, _, _ = _live(PORT)
    with pytest.raises(TypeError, match="runtime_for cannot cross to the what-if rollout process"):
        wi.plan_drain("ex-a", deadline_s=20.0, rounds=4,
                      runtime_for=lambda jid: 15.0 if jid == "j1" else 1e9)
    assert wi._pending == 0 and not wi.rollouts.pids()
    by_mapping = wi.plan_drain("ex-a", deadline_s=20.0, rounds=4, runtime_for={"j1": 15.0})
    runtimes = collections.defaultdict(functools.partial(float, 1e9), {"j1": 15.0})
    by_data = wi.plan_drain("ex-a", deadline_s=20.0, rounds=4,
                            runtime_for=runtimes.__getitem__)
    assert _plan_dict(by_mapping) == _plan_dict(by_data)
    assert by_mapping.drain["completed"] == ["j1"]
    wi.close()


def test_a_second_plan_sends_only_the_specs_the_process_lacks(on_cpu):
    """Two plans on one rollout process: the first sends every spec of
    the fork, the second (a drain, after a cycle that submitted two jobs)
    only those two, naming the rest by key, and equals the same drain
    plan of a fresh planner, whose process is sent every spec."""
    sched, wi, whatif, ex, submit = _live(PORT)
    first = wi.plan(whatif.mutations_from_dicts(GANG), rounds=2)
    submit.submit("team", "s", [PORT.JobSpec(
        id=f"late-{i}", queue="team", jobset="s", requests={"cpu": "2", "memory": "1Gi"},
        submitted_ts=20.0) for i in range(2)], now=20.0)
    _cycle(sched, ex, 20.0)
    fork = wi.ensure_fork()
    drain = [{"kind": "drain_executor", "name": "ex-a", "deadline_s": 20.0}]
    second = wi._plan_on_fork(fork, drain, rounds=4, runtime_for={"j1": 15.0})
    a, b = wi.plan_stats
    assert a["pid"] == b["pid"] and a["sent"] == a["jobs"] + 4
    assert b["sent"] == 2 and b["jobs"] == a["jobs"] + 2
    fresh = whatif.WhatIfService(sched)
    want = fresh._plan_on_fork(fork, drain, rounds=4, runtime_for={"j1": 15.0})
    assert fresh.plan_stats[0]["sent"] == b["jobs"] + 4
    assert _plan_dict(second) == _plan_dict(want)
    assert (b["leases"], b["preempts"]) == (fresh.plan_stats[0]["leases"],
                                            fresh.plan_stats[0]["preempts"])
    assert first.injected and second.drain["completed"] == ["j1"] and b["preempts"]
    fresh.close()
    wi.close()


def test_shared_specs_cross_field_by_field():
    """Specs a plan sends cross as columns: varied job specs (gangs,
    selectors, tolerations, a field that is 0 in some and None in none)
    and node specs load equal, without the rows the snapshot code caches
    on them, each with dicts of its own; held specs cross as keys."""
    import pickle

    import numpy as np

    from armada_tpu_torch.core.types import Gang, JobSpec, Toleration
    from armada_tpu_torch.services.fake_executor import make_nodes
    from armada_tpu_torch.whatif import worker

    gang = Gang(id="g", cardinality=2)
    jobs = [JobSpec(id=f"j{i}", queue="q", priority=i % 2, requests={"cpu": str(i + 1)},
                    node_selector={"zone": "a"} if i % 3 else {}, gang=gang if i < 2 else None,
                    tolerations=(Toleration(key="k", value="v"),) if i == 4 else (),
                    submitted_ts=float(i)) for i in range(6)]
    nodes = make_nodes("ex", count=3, cpu="8")
    object.__setattr__(jobs[0], "_enc_row", ((1, True, "job"), np.arange(2)))
    table = worker._Table()
    payload = pickle.dumps((table.share(jobs), table.share(nodes)))
    worker._HELD, worker._LOADING = {}, {}
    got_jobs, got_nodes = pickle.loads(payload)
    assert got_jobs == jobs and got_nodes == nodes
    assert "_enc_row" not in vars(got_jobs[0])
    assert got_jobs[0].annotations is not got_jobs[1].annotations
    table.commit()
    worker._HELD, worker._LOADING = worker._LOADING, {}
    again = table.share(jobs[::-1])
    assert again.objects == [] and pickle.loads(pickle.dumps(again)) == jobs[::-1]
