"""The port's front door (armada_tpu_torch/frontdoor: admission, the
jobset-keyed ingest shards and their WALs; SubmitService(frontdoor=),
Simulator(frontdoor=); tools/frontdoor_soak.py) against the JAX
package's, on the CPU.

Every case of tests/test_frontdoor.py that needs no gRPC server runs
side by side on both packages (`torch_control_plane.run_side_by_side`),
the port's copy calling the port's soak tool: routing, ordered delivery,
a shard ingester crashing mid-batch (exactly once), torn WAL writes,
partitions, compaction that idle shards do not pin, the tenant and
global rate limits, quota-weighted overload shedding, deadline drops,
the simulation through a sharded front door against direct publish, and
the soak subsets. Each case's own assertions hold on both, the leases
after every cycle of every scheduler service are equal, and each soak's
outcome on the virtual clock (acked, shed, expired, faults fired,
restarts, suppressed duplicates, WAL crashes, lag, makespan) is the
reference's. The cases that drive the gRPC server (`overloaded_plane`)
wait for the server's port.

The simulation case runs again on the kernel backend of both packages
(the port's on the CPU): the front door in front of the port's own
solve.
"""

import functools
import importlib

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import case_marks, plain, run_side_by_side

# The port's soak solves on the kernel backend on the card unless asked
# otherwise; its copy of each case asks for the reference's host oracle
# on the CPU.
PORT_SUBS = (
    (r"from tools\.frontdoor_soak import", "from armada_tpu_torch.tools.frontdoor_soak import"),
    (r"(\brun_soak\(\w+, (?:_small_cfg\([^()]*\)|cfg))", r'\1, backend="oracle", device="cpu"'),
    (r'main\(\["--jobs"', 'main(["--backend", "oracle", "--device", "cpu", "--jobs"'),
)
SERVER_FIXTURE = "overloaded_plane"
SOAK_KEYS = ("seed", "acked", "shed", "expired", "flood_tenant", "flood_shed", "max_shard_lag",
             "duplicates", "lost", "faults_fired", "shard_restarts", "dups_suppressed",
             "wal_crashes", "makespan")


def _cases():
    import inspect

    ref = importlib.import_module("test_frontdoor")
    return [t for t in sorted(vars(ref)) if t.startswith("test_")
            and SERVER_FIXTURE not in inspect.signature(getattr(ref, t)).parameters]


CASES = _cases()


def _params():
    ref = importlib.import_module("test_frontdoor")
    out = []
    for t in CASES:
        marks = [m for m in case_marks("test_frontdoor", t) if m.name != "parametrize"]
        seeds = [m for m in getattr(getattr(ref, t), "pytestmark", []) if m.name == "parametrize"]
        for args in (seeds[0].args[1] if seeds else [None]):
            out.append(pytest.param(t, args, marks=marks,
                                    id=t if args is None else f"{t}[{args}]"))
    return out


def test_every_frontdoor_case_is_collected():
    """The 14 functions (15 cases) that need no gRPC server; the slow
    full-scale soak keeps the reference's mark."""
    assert len(CASES) == 15 and len(_params()) == 16
    assert "test_frontdoor_soak_full_scale" in CASES


def _record(monkeypatch, module, into):
    fn = module.run_soak

    @functools.wraps(fn)
    def recorded(*a, **k):
        out = fn(*a, **k)
        into.append(plain({key: out[key] for key in SOAK_KEYS}))
        return out

    monkeypatch.setattr(module, "run_soak", recorded)


@pytest.mark.parametrize("test, seed", _params())
def test_frontdoor_case_matches_reference(test, seed, monkeypatch, tmp_path):
    import armada_tpu_torch.tools.frontdoor_soak as port_soak
    import tools.frontdoor_soak as ref_soak

    got = {"ref": [], "port": []}
    _record(monkeypatch, ref_soak, got["ref"])
    _record(monkeypatch, port_soak, got["port"])
    run_side_by_side("test_frontdoor", test, monkeypatch, tmp_path, port_subs=PORT_SUBS,
                     args=() if seed is None else (seed,))
    assert got["port"] == got["ref"]


def test_sim_through_front_door_on_kernel_matches_reference(monkeypatch, tmp_path):
    """The simulation case on the kernel backend of both packages:
    the sharded front door's outcome equals direct publish on each, and
    the leases after every cycle are the reference's."""
    run_side_by_side(
        "test_frontdoor", "test_sim_differential_frontdoor_matches_direct", monkeypatch,
        tmp_path, subs=((r'backend="oracle"', 'backend="kernel"'),))
