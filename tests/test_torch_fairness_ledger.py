"""The port's fairness observatory (armada_tpu_torch/observe/fairness.py)
against the JAX package's, on the CPU.

Each round goes through both packages: the same delta sequence on each
package's IncrementalRound, each round solved by its own package, and
`ledger_from_device_round` run on each package's padded round and
decisions (the port's on the ResidentRound's host mirror, as the warm
cycle reads it). The blocks, the FairnessTracker documents fed with them
and `aggregate_scorecard` over them agree:

- exactly: counts, flags, queue and job indices, the preemption
  attribution (victim, aggressor, mechanism), delivered resources,
  demand and delivered shares and the Jain index, which the ledger
  derives from the decisions and the round's inputs alone;
- within 4 ULP for the shares the solver computes (`fair_share`,
  `entitlement`), 16 for the uncapped accumulator (`uncapped`), the
  bounds PERF.md section 2 holds the solve to; a regret (an entitlement
  less an exact delivered share) within the entitlement's bound, and a
  sum or mean of them within the bound times the rounds summed.
"""

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu.observe import fairness as ref_fairness
from armada_tpu.snapshot.incremental import IncrementalRound as RefIncrementalRound
from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver.kernel_prep import pad_device_round as ref_pad
from armada_tpu_torch.observe import fairness
from armada_tpu_torch.snapshot.incremental import IncrementalRound
from armada_tpu_torch.snapshot.residency import ResidentRound
from armada_tpu_torch.solver.kernel import solve_round
from armada_tpu_torch.solver.kernel_prep import pad_device_round
from test_torch_incremental import PORT, REF, make_config, make_nodes, queues

ULP = {"fair_share": 4, "entitlement": 4, "uncapped": 16, "mean_entitlement": 4}
# Differences and sums of entitlements: held to the entitlement's bound
# (times the rounds summed, for the scorecard's totals).
DERIVED = {"regret": 4, "max_regret": 4, "regret_total": 4}


def _ulps(a, b):
    def ordered(x):
        i = np.asarray(x, dtype=np.float64).view(np.int64)
        return np.where(i < 0, np.int64(-(2**63)) - i, i)

    return int(np.abs(ordered(a) - ordered(b)))


def assert_close(got, want, path="", rounds=1):
    """Structural equality with the float bounds of the module docstring."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}", rounds)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]", rounds)
    elif isinstance(want, float) and not isinstance(want, bool):
        key = path.rsplit(".", 1)[-1]
        if key in ULP:
            assert _ulps(got, want) <= ULP[key], (path, got, want)
        elif key in DERIVED:
            assert abs(got - want) <= DERIVED[key] * rounds * np.spacing(1.0), (path, got, want)
        else:
            assert got == want or (got != got and want != want), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _job(pkg, i, queue, cpu, prio=0, pc="low"):
    return pkg.types.JobSpec(
        id=f"job-{i:04d}", queue=queue, priority=prio, priority_class=pc,
        requests={"cpu": str(cpu), "memory": f"{cpu * 2}Gi"}, submitted_ts=float(i),
    )


def _inputs(pkg, policy):
    """A contended pool: q-a over-allocated with preemptible running jobs,
    q-b and q-c (weight 0.25) queued, so rounds preempt and attribute."""
    cfg = make_config(pkg, solve_kernel_path="lax", fairness_policy_default=policy,
                      protected_fraction_of_fair_share=0.5)
    qs = queues(pkg) + [pkg.types.QueueSpec("q-c", 4.0)]
    nodes = make_nodes(6, pkg)
    running = [
        pkg.types.RunningJob(job=_job(pkg, 900 + i, "q-a", 4), node_id=f"node-{i % 6:03d}",
                             scheduled_at_priority=1000, leased_ts=float(i))
        for i in range(18)
    ]
    queued = [_job(pkg, i, ("q-b", "q-c", "q-a")[i % 3], 1 + i % 4,
                   pc="high" if i % 11 == 0 else "low") for i in range(60)]
    return cfg, "default", nodes, qs, running, queued


def _rounds(policy, n_cycles=4):
    """Yields (port block with names, reference block with names, port
    block, reference block) per cycle; each cycle leases half of the last
    decisions and submits five jobs."""
    port = IncrementalRound(*_inputs(PORT, policy))
    ref = RefIncrementalRound(*_inputs(REF, policy))
    resident = ResidentRound(device="cpu")
    for cycle in range(n_cycles):
        dev = resident.device_round(port)
        host = resident.host_round()
        out = solve_round(dev, host=host, device="cpu")
        ref_dev = ref_pad(ref.device_round())
        ref_out = {k: np.asarray(v) for k, v in ref_kernel.solve_round(ref_dev).items()}
        snap, ref_snap = port.snapshot(), ref.snapshot()
        block = fairness.ledger_from_device_round(host, out, snap.num_jobs, snap.num_queues)
        ref_block = ref_fairness.ledger_from_device_round(
            ref_dev, ref_out, ref_snap.num_jobs, ref_snap.num_queues)
        yield (fairness.resolve_names(block, snap.queue_names, list(snap.job_ids)),
               ref_fairness.resolve_names(ref_block, ref_snap.queue_names, list(ref_snap.job_ids)),
               block, ref_block)
        J = snap.num_jobs
        sched = np.flatnonzero(out["scheduled_mask"][:J])[::2]
        for inc, pkg in ((port, PORT), (ref, REF)):
            s = inc.snapshot()
            inc.bind([(str(s.job_ids[j]), s.node_ids[int(out["assigned_node"][j])],
                       int(out["scheduled_priority"][j]), 10.0 + cycle) for j in sched])
            inc.add_jobs([_job(pkg, 1000 + 10 * cycle + i, ("q-c", "q-b")[i % 2], 2)
                          for i in range(5)])


@pytest.mark.parametrize("policy", ["drf", "proportional", "priority"])
def test_ledger_and_tracker_match_reference(policy):
    tracker, ref_tracker = fairness.FairnessTracker(k_rounds=2), ref_fairness.FairnessTracker(k_rounds=2)
    blocks, ref_blocks = [], []
    preempted = 0
    for cycle, (named, ref_named, block, ref_block) in enumerate(_rounds(policy)):
        assert_close(block, ref_block, f"{policy}/cycle {cycle}")
        assert_close(named, ref_named, f"{policy}/cycle {cycle} named")
        doc = tracker.observe_round("default", named, now=float(cycle))
        ref_doc = ref_tracker.observe_round("default", ref_named, now=float(cycle))
        assert_close(doc, ref_doc, f"{policy}/cycle {cycle} tracker")
        preempted += len(block["preemptions"])
        blocks.append(named)
        ref_blocks.append(ref_named)
    assert preempted > 0, "the rounds must preempt, so attribution is compared"
    assert_close(tracker.snapshot(), ref_tracker.snapshot(), f"{policy}/snapshot")
    assert_close(fairness.aggregate_scorecard(blocks), ref_fairness.aggregate_scorecard(ref_blocks),
                 f"{policy}/scorecard", rounds=len(blocks))
    assert ("policy" in blocks[0]["ledger"]) == (policy != "drf")


def test_jain_index_and_ledger_from_snapshot_match_reference():
    """The array-level entry points on inputs made from a seed."""
    rng = np.random.default_rng(5)
    for n in (0, 1, 7):
        x = rng.random(n)
        assert fairness.jain_index(x) == ref_fairness.jain_index(x)
    assert fairness.jain_index(np.zeros(3)) == 1.0
    port = IncrementalRound(*_inputs(PORT, "drf"))
    ref = RefIncrementalRound(*_inputs(REF, "drf"))
    resident = ResidentRound(device="cpu")
    dev = resident.device_round(port)
    out = solve_round(dev, host=resident.host_round(), device="cpu")
    snap, ref_snap = port.snapshot(), ref.snapshot()
    J, Q = snap.num_jobs, snap.num_queues
    sliced = {k: np.asarray(v)[:J] if np.ndim(v) and len(v) >= J else np.asarray(v)
              for k, v in out.items()}
    sliced.update({k: np.asarray(out[k])[:Q] for k in
                   ("fair_share", "demand_capped_fair_share", "uncapped_fair_share")})
    got = fairness.ledger_from_snapshot(snap, sliced)
    want = ref_fairness.ledger_from_snapshot(ref_snap, sliced)
    assert_close(got, want, "ledger_from_snapshot")
    # The mirror and a fresh host round give the same block.
    fresh = pad_device_round(port.device_round())
    assert_close(fairness.ledger_from_device_round(resident.host_round(), out, J, Q),
                 fairness.ledger_from_device_round(fresh, out, J, Q), "mirror")
