"""The reference's control-plane test files that the port runs but no
port test held to the reference until now (ROADMAP C1): reconciliation,
the simulator, the job database's change log, the pod checks, report
retention, the short-job penalty, the async runner, and the chaos
simulation's executor-crash recovery; and the four paths of the device
round probed by hand before (`PINNED`): floating resources, the
cross-pool rounds and service, the service's round-budget path (on the
host oracle, as the reference's cases run it, and on the kernel), and
the chaos simulation's history (`_chaos_sim` of tests/test_residency.py
in each snapshot mode, its returned history equal too).

Each case runs side by side: the JAX package's test function as it is,
and the same function compiled from its source with every `armada_tpu`
import pointed at the port (`port_copy`) and the port's default device
set to the CPU. Each case's own assertions hold on both packages, and
after every scheduling cycle either package runs the leases are
recorded; the two histories are equal cycle by cycle (job state,
attempts, and the latest run's executor, node, pool, priority and state;
run ids are random).

The JAX package's services default to the host oracle and the port's to
its kernel, so a case that names no backend holds the port's kernel on
the CPU to the JAX package's oracle.
"""

import importlib

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import run_side_by_side

FILES = (
    "test_reconciliation",
    "test_simulator",
    "test_jobdb_changelog",
    "test_podchecks",
    "test_reports_retention",
    "test_short_job_penalty",
    "test_runner",
)
EXTRA = (("test_chaos", "test_sim_executor_crash_recovers_all_jobs"),)


def _cases():
    out = []
    for name in FILES:
        ref = importlib.import_module(name)
        out += [(name, t) for t in sorted(vars(ref)) if t.startswith("test_")]
    return out + list(EXTRA)


CASES = _cases()


FLOATING = ("test_floating_resources",)
CROSS_POOL = (
    "test_cross_pool_borrowing",
    "test_cross_pool_away_bucket_and_eviction",
    "test_cross_pool_unbound_away_pressure_only",
    "test_cross_pool_service_end_to_end",
    "test_cross_pool_no_same_cycle_double_booking",
)
BUDGET = (
    "test_scheduler_truncated_rounds_resume_and_trip_backpressure",
    "test_scheduler_no_budget_reports_untruncated",
)
ON_KERNEL = ((r'backend="oracle"', 'backend="kernel"'),)


def _pinned():
    ref = importlib.import_module(FLOATING[0])
    out = [(FLOATING[0], t, ()) for t in sorted(vars(ref)) if t.startswith("test_")]
    out += [("test_away", t, ()) for t in CROSS_POOL]
    out += [("test_round_deadline", t, subs) for t in BUDGET for subs in ((), ON_KERNEL)]
    return out


PINNED = _pinned()


def test_every_probed_case_is_collected():
    """The 30 cases of the seven files and the chaos simulation's."""
    assert len(CASES) == 31


@pytest.mark.parametrize("name, test", CASES, ids=[f"{n}::{t}" for n, t in CASES])
def test_probed_case_matches_reference(name, test, monkeypatch, tmp_path):
    run_side_by_side(name, test, monkeypatch, tmp_path)


def test_every_pinned_case_is_collected():
    """The four floating-resource cases, the five cross-pool cases and
    the two budget cases on the oracle and on the kernel."""
    assert len(PINNED) == 4 + 5 + 2 * 2


@pytest.mark.parametrize(
    "name, test, subs", PINNED,
    ids=[f"{n}::{t}{'[kernel]' if s else ''}" for n, t, s in PINNED],
)
def test_pinned_case_matches_reference(name, test, subs, monkeypatch, tmp_path):
    run_side_by_side(name, test, monkeypatch, tmp_path, subs=subs)


@pytest.mark.parametrize("mode", ["rebuild", "incremental", "resident"])
def test_chaos_history_matches_reference(mode, monkeypatch, tmp_path):
    """The chaos simulation (an executor crash, a network partition, a
    lease timeout, a cordon window, a staged drain) on the kernel: its
    history (states, placements, preemptions, finished jobs, cycles) and
    the leases after every cycle equal the reference's."""
    ref, port = run_side_by_side(
        "test_residency", "_chaos_sim", monkeypatch, tmp_path, args=(mode, None),
        port_subs=((r"from armada_tpu_torch\.observe import round_ledger",
                    "from armada_tpu_torch.observe.ledger import round_ledger"),),
    )
    assert port == ref
    assert ref["finished"] >= 40
