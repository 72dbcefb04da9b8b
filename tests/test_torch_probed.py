"""The reference's control-plane test files that the port runs but no
port test held to the reference until now (ROADMAP C1): reconciliation,
the simulator, the job database's change log, the pod checks, report
retention, the short-job penalty, the async runner, and the chaos
simulation's executor-crash recovery.

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
import re
import types

import pytest
import torch_cpu  # noqa: F401

import armada_tpu.services.scheduler as ref_scheduler
import armada_tpu_torch.device as port_device
import armada_tpu_torch.services.scheduler as port_scheduler
from torch_control_plane import leases_view

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

_PORTED: dict = {}


def port_copy(name):
    """The reference test module `name`, compiled again from its source
    with `armada_tpu` imports pointed at `armada_tpu_torch`."""
    if name not in _PORTED:
        ref = importlib.import_module(name)
        with open(ref.__file__) as f:
            src = re.sub(r"\barmada_tpu(?=[. ])", "armada_tpu_torch", f.read())
        module = types.ModuleType(f"torch_port_{name}")
        module.__file__ = ref.__file__
        exec(compile(src, ref.__file__, "exec"), module.__dict__)
        _PORTED[name] = module
    return _PORTED[name]


def _cases():
    out = []
    for name in FILES:
        ref = importlib.import_module(name)
        out += [(name, t) for t in sorted(vars(ref)) if t.startswith("test_")]
    return out + list(EXTRA)


CASES = _cases()


def _recorded(monkeypatch, module):
    """Record the leases after every cycle of every scheduler service."""
    history = []
    cycle = module.SchedulerService.cycle

    def recorded(self, *a, **k):
        out = cycle(self, *a, **k)
        history.append(leases_view(self.jobdb))
        return out

    monkeypatch.setattr(module.SchedulerService, "cycle", recorded)
    return history


def test_every_probed_case_is_collected():
    """The 30 cases of the seven files and the chaos simulation's."""
    assert len(CASES) == 31


@pytest.mark.parametrize("name, test", CASES, ids=[f"{n}::{t}" for n, t in CASES])
def test_probed_case_matches_reference(name, test, monkeypatch):
    ref_history = _recorded(monkeypatch, ref_scheduler)
    getattr(importlib.import_module(name), test)()
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    port_history = _recorded(monkeypatch, port_scheduler)
    getattr(port_copy(name), test)()
    assert len(port_history) == len(ref_history)
    for i, (p, r) in enumerate(zip(port_history, ref_history)):
        assert p == r, f"cycle {i}"
