"""The port's chaos soak (armada_tpu_torch/tools/chaos_soak.py) against
the JAX package's tools/chaos_soak.py, on the CPU.

The soak subsets of tests/test_chaos.py run side by side on both
packages (`torch_control_plane.run_side_by_side`), the port's copy
calling the port's tool: `test_soak_subset_deterministic` (seeded fault
plans of crashes, hangs, lease faults, leader flaps, partitions and torn
tails on a real file-backed log, oracle backend) and
`test_solver_fault_soak_subset` (solver raise, hang, NaN and
wrong-placement windows on the kernel backend, the port's on the CPU,
whose ladder runs local:cuda, LOCAL, hotwindow:64 and the oracle). Each
case's own assertions hold on both, the leases after every cycle of
every simulation are equal, and every soak iteration's outcome is the
reference's: its digest, finished and total counts, cycles, faults
fired and log crashes, and for the solver soak the faults injected, the
bundles replayed, the causes of its failovers and the cycle and
invariant of its rejections. (The port's CPU ladder has a rung more than
the reference's, local:cuda above LOCAL, so a fault that fires on every
rung, nine times, spreads over other rounds' rungs: the failovers
themselves differ in number and labels, not in cause.)

A direct twin runs one soak plan on the kernel backend, torn tails on
the file-backed log included, as phase 15 of chip_smoke.py runs it on
the card.
"""

import functools

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import case_marks, plain, run_side_by_side

# The port's soak solves on the kernel backend on the card unless asked
# otherwise; its copy of each case names the CPU.
PORT_SUBS = (
    (r"from tools\.chaos_soak import", "from armada_tpu_torch.tools.chaos_soak import"),
    (r'(\brun_(?:solver_)?plan\(\w+, (?:"oracle", )?24)', r'\1, device="cpu"'),
)
SOAKS = ("test_soak_subset_deterministic", "test_solver_fault_soak_subset")
# Outcome keys that are the same on both packages (see the module
# docstring for the solver soak's failovers).
PLAN_KEYS = ("seed", "digest", "finished", "total", "preemptions", "cycles", "makespan",
             "faults_fired", "log_crashes", "anti_entropy", "fences")
SOLVER_KEYS = ("seed", "mode", "digest", "finished", "total", "cycles", "makespan",
               "injected", "bundles_replayed")


def _outcome(doc):
    if doc.get("mode") == "solver-faults":
        out = {k: doc[k] for k in SOLVER_KEYS}
        out["rejections"] = sorted({(r["cycle"], r["invariant"]) for r in doc["rejections"]})
        out["failover_causes"] = sorted({f["cause"] for f in doc["failovers"]})
        return plain(out)
    return plain({k: doc[k] for k in PLAN_KEYS})


def _record(monkeypatch, module, into):
    for name in ("run_plan", "run_solver_plan"):
        fn = getattr(module, name)

        @functools.wraps(fn)
        def recorded(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            into.append(_outcome(out))
            return out

        monkeypatch.setattr(module, name, recorded)


@pytest.mark.parametrize(
    "test", [pytest.param(t, marks=case_marks("test_chaos", t), id=t) for t in SOAKS])
def test_soak_case_matches_reference(test, monkeypatch, tmp_path):
    import armada_tpu_torch.tools.chaos_soak as port_soak
    import tools.chaos_soak as ref_soak

    got = {"ref": [], "port": []}
    _record(monkeypatch, ref_soak, got["ref"])
    _record(monkeypatch, port_soak, got["port"])
    run_side_by_side("test_chaos", test, monkeypatch, tmp_path, port_subs=PORT_SUBS)
    assert got["ref"] and got["port"] == got["ref"]


@pytest.mark.chaos
def test_kernel_soak_plan_on_file_log_equals_reference():
    """run_plan(0, "kernel", 24) on both packages, the port's on the
    CPU: the same faults fire, the file-backed log crashes and recovers
    as often, and the final jobdb digest and counts are equal."""
    import armada_tpu_torch.tools.chaos_soak as port_soak
    import tools.chaos_soak as ref_soak

    want = ref_soak.run_plan(0, "kernel", 24)
    got = port_soak.run_plan(0, "kernel", 24, device="cpu")
    assert _outcome(got) == _outcome(want)
    assert got["finished"] == got["total"] and got["log_crashes"] > 0
