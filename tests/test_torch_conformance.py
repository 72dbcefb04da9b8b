"""The host oracle, the snapshot and the resource encoding, BASELINE.md's
five configurations and the churn soak, held side by side with the JAX
package (ROADMAP C1).

Each case of tests/test_reference_solver.py (21), test_snapshot.py (6),
test_resources.py (6), test_baseline_configs.py (5) and test_soak.py (1)
runs as it is on the JAX package, then compiled from its source with its
`armada_tpu` imports pointed at the port and the port's default device
set to the CPU (`run_side_by_side`); both pass their own assertions.
Beyond that:

- the oracle's, snapshot's and resource cases record what the package
  under test returns (every `ReferenceSolver.solve`, every
  `build_round_snapshot`, every quantity parse, factory and encoding), and
  the port's records equal the reference's, array for array
  (`torch_conformance.canon`);
- the simulations and the soak record the leases after every scheduling
  cycle, and the histories are equal cycle by cycle: the port's kernel on
  the CPU against the reference's own backend (its oracle where a case
  names none, its kernel where it names "kernel").

tests/test_torch_conformance_tables.py holds the Go table cases and the
scale sweep, tests/test_torch_conformance_multichip.py the cases of
tests/test_multichip.py that no port test mirrored.
"""

import importlib

import pytest
import torch_cpu  # noqa: F401

from torch_conformance import case_names, record_calls
from torch_control_plane import case_marks, port_copy, run_side_by_side


def _targets_oracle(module, package):
    solver = importlib.import_module(f"{package}.solver.reference").ReferenceSolver
    return [(module, "build_round_snapshot"), (solver, "solve")]


def _targets_snapshot(module, package):
    return [(module, "build_round_snapshot")]


def _targets_resources(module, package):
    factory = importlib.import_module(f"{package}.core.resources").ResourceListFactory
    return [(module, "parse_quantity"), (factory, "create"), (factory, "from_map"),
            (factory, "to_device"), (factory, "to_map")]


RECORDED = {
    "test_reference_solver": _targets_oracle,
    "test_snapshot": _targets_snapshot,
    "test_resources": _targets_resources,
}
HISTORIES = ("test_baseline_configs", "test_soak")


def _cases(names):
    return [(name, t) for name in names for t in case_names(importlib.import_module(name))]


RECORDED_CASES = _cases(RECORDED)
HISTORY_CASES = _cases(HISTORIES)


def test_every_case_is_collected():
    """21 oracle, 6 snapshot and 6 resource cases; 5 configurations and
    the soak."""
    assert len(RECORDED_CASES) == 21 + 6 + 6
    assert len(HISTORY_CASES) == 5 + 1


@pytest.mark.parametrize("name, test", RECORDED_CASES,
                         ids=[f"{n}::{t}" for n, t in RECORDED_CASES])
def test_recorded_case_matches_reference(name, test, monkeypatch, tmp_path):
    targets = RECORDED[name]
    ref = record_calls(monkeypatch, targets(importlib.import_module(name), "armada_tpu"))
    port = record_calls(monkeypatch, targets(port_copy(name), "armada_tpu_torch"))
    run_side_by_side(name, test, monkeypatch, tmp_path)
    assert ref, f"{name}::{test} recorded nothing"
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p == r, f"{name}::{test}: call {i} ({r[0]}) differs from the reference's"


@pytest.mark.parametrize(
    "name, test",
    [pytest.param(n, t, marks=case_marks(n, t)) for n, t in HISTORY_CASES],
    ids=[f"{n}::{t}" for n, t in HISTORY_CASES],
)
def test_history_case_matches_reference(name, test, monkeypatch, tmp_path):
    run_side_by_side(name, test, monkeypatch, tmp_path)


def _multi_queue_round(package):
    """The first round of test_config2_multi_queue_drf (BASELINE's 10
    weighted queues of 100 mixed cpu and memory jobs on 20 nodes of 16
    cpu and 64Gi), built by `package` as its simulator submits it."""
    sim_mod = importlib.import_module(f"{package}.sim.simulator")
    sim = importlib.import_module(f"{package}.sim")
    queues = tuple(
        sim.QueueSpecSim(f"q{i}", priority_factor=1.0 if i < 5 else 2.0, job_templates=(
            sim.JobTemplate(id="mixed", number=100, cpu=str(1 + i % 3),
                            memory=f"{4 * (1 + i % 2)}Gi",
                            runtime=sim_mod.ShiftedExponential(minimum=120.0)),))
        for i in range(10))
    kw = {"device": "cpu"} if package == "armada_tpu_torch" else {}
    s = sim.Simulator(
        [sim.ClusterSpec("c", node_templates=(sim_mod.NodeTemplate(count=20, cpu="16",
                                                                  memory="64Gi"),))],
        sim.WorkloadSpec(queues=queues), backend="kernel", max_time=100_000.0, **kw)
    for ex in s.executors:
        ex.tick(0.0)
    for _, q, js, jobs in s._pending_submissions:
        s.submit.submit(q, js, jobs, now=0.0)
    s._pending_submissions = []
    return s


def test_drf_round_over_two_resources_is_admitted():
    """BASELINE's multi-queue configuration's first round: its queues
    dominate on different resources (cpu or memory), so their delivered
    DRF shares sum to 1.109 though the round fits its nodes and equals
    the oracle's. The port's round firewall admits it on the first rung
    (the card's only rung): each resource's delivered total fits the
    pool's, and the shares sum to less than those totals' fractions. The
    JAX package's ceiling of 1 (armada_tpu/solver/validate.py:262-264)
    rejects the same ledger, so its kernel rungs fail over to its oracle
    here every cycle; the rejection is the only difference: the leases are
    the same."""
    import numpy as np

    from armada_tpu.solver.validate import validate_round as ref_validate
    from armada_tpu_torch.observe.fairness import ledger_from_device_round
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.solver.validate import validate_round
    from torch_control_plane import leases_view

    port, ref = _multi_queue_round("armada_tpu_torch"), _multi_queue_round("armada_tpu")
    port.scheduler.cycle(now=0.0)
    ref.scheduler.cycle(now=0.0)
    stats = port.scheduler.last_cycle_stats
    assert stats["rung"] == "local:cuda" and not stats["failover"], stats
    assert not port.scheduler.recent_rejections and not port.scheduler.recent_failovers
    assert [r["invariant"] for r in ref.scheduler.recent_rejections] == ["fairness_ledger"] * 2
    assert leases_view(port.scheduler.jobdb) == leases_view(ref.scheduler.jobdb)

    txn = port.scheduler.jobdb.read_txn()
    snap = build_round_snapshot(
        port.scheduler.config, "default", [n for ex in port.executors for n in ex.nodes],
        list(port.scheduler.queues.values()), [], [j.spec for j in txn.all_jobs()])
    dev = pad_device_round(prep_device_round(snap))
    out = solve_round(dev, device="cpu")
    fairness = ledger_from_device_round(dev, out, snap.num_jobs, snap.num_queues)
    ledger = fairness["ledger"]
    total = float(np.sum([r["delivered_share"] for r in ledger["queues"]]))
    assert 1.0 < total < _fraction_sum(dev, ledger)
    assert validate_round(out, dev=dev, fairness=fairness) is None
    violation = ref_validate(out, dev=dev, fairness=fairness)
    assert violation is not None and violation.invariant == "fairness_ledger", violation
    assert validate_round(out, dev=dev) is None and ref_validate(out, dev=dev) is None


def _fraction_sum(dev, ledger):
    """sum_r m_r * delivered_total[r] / total[r]: the firewall's ceiling of
    the delivered shares' sum on a DeviceRound."""
    import numpy as np

    total = np.asarray(dev.total_resources, dtype=np.float64)
    mult = np.asarray(dev.drf_multipliers, dtype=np.float64)
    safe = np.where(total > 0, total, 1.0)
    fractions = np.where(total > 0, np.asarray(ledger["delivered_total"]) / safe, 0.0)
    return float(np.sum(fractions * mult))


def test_over_delivering_ledger_is_rejected():
    """The same round's ledger, over-delivered below the resource count,
    which a ceiling of the resource count would admit: a resource's
    delivered total past the pool's, or the delivered shares past the
    ceiling their totals give. The firewall rejects both; the ledger as
    the round made it is admitted."""
    import copy

    import numpy as np

    from armada_tpu_torch.observe.fairness import ledger_from_device_round
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.solver.validate import validate_round

    port = _multi_queue_round("armada_tpu_torch")
    txn = port.scheduler.jobdb.read_txn()
    snap = build_round_snapshot(
        port.scheduler.config, "default", [n for ex in port.executors for n in ex.nodes],
        list(port.scheduler.queues.values()), [], [j.spec for j in txn.all_jobs()])
    dev = pad_device_round(prep_device_round(snap))
    out = solve_round(dev, device="cpu")
    fairness = ledger_from_device_round(dev, out, snap.num_jobs, snap.num_queues)
    R = len(fairness["ledger"]["delivered_total"])
    assert validate_round(out, dev=dev, fairness=fairness) is None

    over_resource = copy.deepcopy(fairness)
    over_resource["ledger"]["delivered_total"][1] = 1.5 * float(dev.total_resources[1])
    violation = validate_round(out, dev=dev, fairness=over_resource)
    assert violation is not None and violation.invariant == "fairness_ledger", violation
    assert "resource 1" in violation.detail

    over_share = copy.deepcopy(fairness)
    rows = over_share["ledger"]["queues"]
    ceiling = _fraction_sum(dev, over_share["ledger"])
    rows[0]["delivered_share"] += ceiling - sum(r["delivered_share"] for r in rows) + 0.1
    total = float(np.sum([r["delivered_share"] for r in rows]))
    assert ceiling < total < R
    violation = validate_round(out, dev=dev, fairness=over_share)
    assert violation is not None and violation.invariant == "fairness_ledger", violation
    assert "sum to" in violation.detail
