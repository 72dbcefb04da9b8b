"""The port's what-if planner (armada_tpu_torch/whatif: forks, mutations,
the planner and its rollouts; services/submit_check.py) against the JAX
package's, on the CPU.

Every case of tests/test_whatif.py runs side by side on both packages
(`torch_control_plane.run_side_by_side`): each case's own assertions
hold on both, and the leases after every cycle of every scheduler
service are equal — the live services' and each rollout's, in the order
they run. The planner-isolation burst runs its plans on worker threads
beside the live cycles, and which requests are shed depends on timing,
so there the live service's leases are compared alone. The reference's
`slow` marks stay on their cases (the "2x4" mesh parity and the
hotwindow and mesh fixture forks).

Direct twins, each exact (all of these are decisions):
- every mutation kind applied to the same ForkState gives equal states;
- a drain plan and an inject-gang plan on twinned live services (the
  port's kernel on the CPU against the reference's kernel) give equal
  `Plan.to_dict()` but for the plan's seconds.
"""

import importlib
import itertools

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import PORT, REF, case_marks, plain, run_side_by_side


def _cases():
    ref = importlib.import_module("test_whatif")
    return [("test_whatif", t) for t in sorted(vars(ref)) if t.startswith("test_")]


CASES = _cases()
# Plans on worker threads beside the live cycles (see the module docstring).
THREADED = ("test_planner_isolation_burst",)
# The port's mesh solves take their shards' device explicitly (one card
# each by default): the port's copy puts the "2x4" cases' shards on the
# CPU, in the live service (and so in its rollouts) and in parity_check.
PORT_SUBS = (
    (r"SchedulerService\(CONFIG, log, backend=backend, mesh=mesh\)",
     'SchedulerService(CONFIG, log, backend=backend, mesh=mesh, device="cpu")'),
    (r'parity_check\(fork, "2x4"\)', 'parity_check(fork, "2x4", device="cpu")'),
)


def test_every_whatif_case_is_collected():
    assert len(CASES) == 14


@pytest.mark.parametrize(
    "name, test",
    [pytest.param(n, t, marks=case_marks(n, t), id=f"{n}::{t}") for n, t in CASES],
)
def test_whatif_case_matches_reference(name, test, monkeypatch, tmp_path):
    run_side_by_side(name, test, monkeypatch, tmp_path, port_subs=PORT_SUBS,
                     first_only=test in THREADED)


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


def _live(P):
    """A live kernel service with two executors of two 8-cpu nodes and
    six 4-cpu jobs, one a gang of two, after two cycles; its planner has
    captured the second (rebuild) round."""
    cfg = P.SchedulingConfig(
        priority_classes={"d": P.PriorityClass("d", 1000, preemptible=True)},
        default_priority_class="d",
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
    wi = whatif.WhatIfService(sched)
    sched.attach_whatif(wi)
    for t in (0.0, 10.0):
        for e in ex:
            e.tick(t)
        sched.cycle(now=t)
        for e in ex:
            e.tick(t)
    return sched, wi, whatif


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
    plans = {}
    for P in (REF, PORT):
        importlib.import_module(f"{P.name}.whatif.mutations")._inject_counter = itertools.count()
        sched, wi, whatif = _live(P)
        assert wi.capture.latest("default") is not None
        drain = wi.plan_drain("ex-a", deadline_s=20.0, rounds=4,
                              runtime_for=lambda jid: 15.0 if jid == "j1" else 1e9)
        gang = wi.plan(whatif.mutations_from_dicts([
            {"kind": "inject_gang", "queue": "team", "gang_cardinality": 2,
             "cpu": "4", "memory": "1Gi"}]), rounds=3)
        plans[P.name] = [_plan_dict(drain), _plan_dict(gang)]
    assert plans["armada_tpu_torch"] == plans["armada_tpu"]
    drain, gang = plans["armada_tpu_torch"]
    assert drain["drain"]["completed"] == ["j1"] and drain["drain"]["landings"]
    assert drain["displaced"]
    assert gang["injected"][0]["feasible"]
