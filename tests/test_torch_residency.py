"""The port's device-resident round (armada_tpu_torch/snapshot/residency.py)
and the solve of a resident tree (`solve_round(tree, host=mirror)`), on
the CPU, where the resident buffers are CPU tensors that share no memory
with the mirror.

Port copies of tests/test_residency.py's unit tests: a delta sync is
bit-exact against a fresh upload and solves identically (a lease-driven
slot-table reshuffle included), a small delta uploads far less than a
reset, a burst past the padded capacity resets into regrown buffers,
check_drift names a corrupted field and reset() recovers, and a resident
tree books zero upload through the fused and the host-driven solve, on
repeat solves too, while a numpy tree books its full size.

Against the JAX package: the port's `last_sync` equals the reference
ResidentRound's on one delta sequence (mode, fields, permuted and
bytes_up: the port's buckets are the reference's and the device holds the
same bytes, uint32 bitsets as their int32 words).

And the solve never writes into the resident buffers: after fused,
budgeted, compacted, market and priority solves, check_drift() is empty,
a second solve of the same tree equals the first, both equal a fresh
upload's solve and the reference's (`test_torch_round._assert_same`:
decisions, num_loops and spot_price bit-exact, fair shares within 4/16
ULP), and the next delta sync leaves the last cycle's outputs untouched.
"""

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401
import torch

from armada_tpu.snapshot.incremental import IncrementalRound as RefIncrementalRound
from armada_tpu.snapshot.residency import ResidentRound as RefResidentRound
from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver import kernel_prep as ref_prep
from armada_tpu_torch.observe import ledger
from armada_tpu_torch.ops.bitset import as_words
from armada_tpu_torch.snapshot.incremental import IncrementalRound
from armada_tpu_torch.snapshot.residency import ResidentRound
from armada_tpu_torch.solver.kernel import solve_round
from armada_tpu_torch.solver.kernel_prep import pad_device_round
from armada_tpu_torch.workload import build_inputs, policy_inputs
from test_torch_incremental import PORT, REF, _bid_jobs, make_config, make_nodes, queues
from test_torch_round import _assert_same

QUEUES = queues()
CPU = torch.device("cpu")

DECISION_KEYS = (
    "assigned_node",
    "scheduled_priority",
    "scheduled_mask",
    "preempted_mask",
    "fair_share",
    "demand_capped_fair_share",
    "uncapped_fair_share",
    "num_loops",
    "spot_price",
)


def job(i, queue="q-a", cpu=2, pc="low", pkg=PORT):
    return pkg.types.JobSpec(
        id=f"job-{i:04d}",
        queue=queue,
        priority_class=pc,
        requests={"cpu": str(cpu), "memory": f"{cpu * 2}Gi"},
        submitted_ts=float(i),
    )


def resident_solve(resident, dev, **kw):
    return solve_round(dev, host=resident.host_round(), device="cpu", **kw)


def assert_same_bits(resident, inc):
    """Every resident device leaf equals the fresh padded round bit for
    bit (uint32 bitsets through their int32 words), and the drift check
    agrees."""
    fresh = pad_device_round(inc.device_round())
    dev = resident._dev
    for f in dataclasses.fields(fresh):
        want = getattr(fresh, f.name)
        got = getattr(dev, f.name)
        if isinstance(want, np.ndarray) and want.ndim >= 1:
            assert isinstance(got, torch.Tensor) and got.device == CPU, f.name
            got = got.numpy()
            if want.dtype == np.uint32:
                want = as_words(want)
            assert want.dtype == got.dtype and want.shape == got.shape, f.name
            assert want.tobytes() == got.tobytes(), f.name
    assert resident.check_drift() == []


def lease_some(inc, out, n):
    """Bind the first n of last round's scheduled decisions."""
    snap = inc.snapshot()
    J = snap.num_jobs
    sched = np.flatnonzero(np.asarray(out["scheduled_mask"])[:J])[:n]
    assigned = np.asarray(out["assigned_node"])[:J]
    prio = np.asarray(out["scheduled_priority"])[:J]
    inc.bind([(str(snap.job_ids[j]), snap.node_ids[int(assigned[j])], int(prio[j]), 1.0)
              for j in sched])


def _same_decisions(got, want, label):
    for k in DECISION_KEYS:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k]), equal_nan=True), (label, k)


def test_delta_sync_bit_exact_and_solve_identical():
    """Warm-cycle delta syncs (a lease-driven slot-table reshuffle
    included) keep device == fresh upload bit for bit, and the solve of
    the resident tree reproduces the fresh upload's decisions exactly."""
    inc = IncrementalRound(
        make_config(), "default", make_nodes(8), QUEUES, [],
        [job(i, queue="q-a" if i % 2 else "q-b", cpu=1 + i % 3) for i in range(40)],
    )
    resident = ResidentRound(device="cpu")
    with ledger.round_ledger() as led:
        dev = resident.device_round(inc)
    assert resident.last_sync["mode"] == "reset"
    assert led.as_dict()["bytes_up"] == resident.last_sync["bytes_up"] > 0
    assert_same_bits(resident, inc)

    out = resident_solve(resident, dev)
    # Cycle: lease a handful (reshuffles the slot table between the
    # running and queued segments) and submit fresh work.
    lease_some(inc, out, 6)
    inc.add_jobs([job(100 + i) for i in range(4)])
    inc.set_round_params(global_rate_tokens=1e9)
    with ledger.round_ledger() as led:
        dev = resident.device_round(inc)
    sync = resident.last_sync
    assert sync["mode"] == "delta"
    assert sync["permuted"], "leases must reshuffle the slot table"
    assert led.as_dict()["bytes_up"] == sync["bytes_up"] > 0
    assert_same_bits(resident, inc)

    out_res = resident_solve(resident, dev)
    out_fresh = solve_round(pad_device_round(inc.device_round()), device="cpu")
    _same_decisions(out_res, out_fresh, "resident against fresh")

    # Same-generation re-entry returns the committed tree and books nothing.
    with ledger.round_ledger() as led:
        again = resident.device_round(inc)
    assert again is dev
    assert led.as_dict()["bytes_up"] == 0


def test_delta_cheaper_than_reset():
    """A small-delta warm cycle uploads far less than the full round
    (here < 1/4 of the reset bytes)."""
    inc = IncrementalRound(
        make_config(), "default", make_nodes(16), QUEUES, [],
        [job(i, queue="q-a" if i % 2 else "q-b") for i in range(400)],
    )
    resident = ResidentRound(device="cpu")
    resident.device_round(inc)
    reset_bytes = resident.last_sync["bytes_up"]
    inc.add_jobs([job(9000)])
    inc.set_round_params(global_rate_tokens=1e9)
    with ledger.round_ledger() as led:
        resident.device_round(inc)
    assert resident.last_sync["mode"] == "delta"
    assert resident.last_sync["bytes_up"] < reset_bytes / 4
    # One changed row, written as a batch padded to its bucket of 64 by
    # repeating that row: duplicate indices with equal values.
    assert led.sites.get("residency.delta", 0) > 0
    assert_same_bits(resident, inc)


def test_slot_overflow_regrows_and_resets():
    """A burst past the padded pow2 capacity changes the padded shapes:
    the residency resets (a full upload into regrown buffers) and stays
    bit-exact, then resumes delta cycles on the new shapes."""
    inc = IncrementalRound(make_config(), "default", make_nodes(8), QUEUES, [],
                           [job(i) for i in range(40)])
    resident = ResidentRound(device="cpu")
    dev0 = resident.device_round(inc)
    J0 = int(dev0.job_req.shape[0])

    inc.add_jobs([job(1000 + i) for i in range(J0)])
    inc.set_round_params(global_rate_tokens=1e9)
    with ledger.round_ledger() as led:
        dev1 = resident.device_round(inc)
    assert int(dev1.job_req.shape[0]) > J0
    assert resident.last_sync["mode"] == "reset"
    assert led.as_dict()["bytes_up"] == resident.last_sync["bytes_up"]
    assert_same_bits(resident, inc)
    _same_decisions(resident_solve(resident, dev1),
                    solve_round(pad_device_round(inc.device_round()), device="cpu"), "regrown")

    inc.add_jobs([job(5000)])
    inc.set_round_params(global_rate_tokens=1e9)
    resident.device_round(inc)
    assert resident.last_sync["mode"] == "delta"
    assert_same_bits(resident, inc)


def test_drift_detection_and_reset():
    """A corrupted device buffer is caught by check_drift; reset() drops
    the resident state so the next sync is a fresh upload."""
    inc = IncrementalRound(make_config(), "default", make_nodes(4), QUEUES, [],
                           [job(i) for i in range(8)])
    resident = ResidentRound(device="cpu")
    resident.device_round(inc)
    assert resident.check_drift() == []
    resident._dev.job_prio[0] += 1
    assert resident.check_drift() == ["job_prio"]
    # A bitset field drifts through its int32 words too.
    resident._dev.node_labels[0, 0] ^= 1
    assert resident.check_drift() == ["node_labels", "job_prio"]
    resident.reset()
    resident.device_round(inc)
    assert resident.last_sync["mode"] == "reset"
    assert resident.check_drift() == []


def test_ledger_books_zero_upload_for_resident_tree():
    """solve_round books only true uploads: a tree already on the solve's
    device books ZERO bytes_up through both the fused and the host-driven
    (budgeted) paths, on repeat solves too; a numpy tree books its full
    size; results book either way."""
    inc = IncrementalRound(make_config(), "default", make_nodes(4), QUEUES, [],
                           [job(i) for i in range(8)])
    dev_host = pad_device_round(inc.device_round())
    full, _ = ledger.tree_transfer_size(dev_host, host_only=True)
    dev_t = dataclasses.replace(dev_host, **{
        f.name: torch.from_numpy(as_words(v) if v.dtype == np.uint32 else v.copy())
        for f in dataclasses.fields(dev_host)
        if isinstance(v := getattr(dev_host, f.name), np.ndarray) and v.ndim > 0
    })

    with ledger.round_ledger() as led:
        solve_round(dev_host, device="cpu")
    assert led.as_dict()["bytes_up"] == full > 0
    with ledger.round_ledger() as led:
        solve_round(dev_host, device="cpu", budget_s=60.0)
    assert led.as_dict()["bytes_up"] == full

    for _ in range(2):  # fused path, repeat solves
        with ledger.round_ledger() as led:
            solve_round(dev_t, host=dev_host, device="cpu")
        books = led.as_dict()
        assert books["bytes_up"] == 0, books
        assert books["bytes_down"] > 0
    with ledger.round_ledger() as led:  # host-driven (budgeted) path
        out = solve_round(dev_t, host=dev_host, device="cpu", budget_s=60.0)
    assert led.as_dict()["bytes_up"] == 0
    assert out["profile"]["transfer"]["bytes_up"] == 0

    resident = ResidentRound(device="cpu")
    dev = resident.device_round(inc)
    with ledger.round_ledger() as led:
        out = resident_solve(resident, dev)
    assert led.as_dict()["bytes_up"] == 0
    _same_decisions(out, solve_round(dev_host, device="cpu"), "resident tree")


def test_solve_refuses_a_tree_without_its_mirror():
    """A tree of tensors solves only with its host mirror and on its own
    device; no data is read back to recover host values."""
    inc = IncrementalRound(make_config(), "default", make_nodes(4), QUEUES, [],
                           [job(i) for i in range(8)])
    resident = ResidentRound(device="cpu")
    dev = resident.device_round(inc)
    with pytest.raises(ValueError, match="host mirror"):
        solve_round(dev, device="cpu")
    with pytest.raises(ValueError, match="host mirror"):
        solve_round(dev, device="cpu", budget_s=60.0)
    with pytest.raises(ValueError, match="is on cpu"):
        solve_round(dev, host=resident.host_round(), device="meta")
    with pytest.raises(ValueError, match="numpy arrays"):
        solve_round(resident.host_round(), host=resident.host_round(), device="cpu")
    other = dataclasses.replace(resident.host_round(), job_req=resident.host_round().job_req[:4])
    with pytest.raises(ValueError, match="job_req"):
        solve_round(dev, host=other, device="cpu")


def _sequence(pkg, cls):
    """One delta sequence on either package's IncrementalRound; yields
    after each sync-worthy step."""
    inc = cls(make_config(pkg, solve_kernel_path="lax"), "default", make_nodes(8, pkg),
              queues(pkg), [], [job(i, queue="q-a" if i % 2 else "q-b", cpu=1 + i % 3, pkg=pkg)
                                for i in range(40)])
    yield inc
    inc.add_jobs([job(100 + i, pkg=pkg) for i in range(4)])
    yield inc
    inc.bind([(f"job-{i:04d}", f"node-{i % 8:03d}", 1000, 1.0) for i in range(0, 12, 2)])
    inc.set_round_params(global_rate_tokens=1e9)
    yield inc
    inc.remove_jobs(["job-0001", "job-0002", "job-0101"])
    yield inc
    inc.unbind(["job-0004"])
    inc.add_jobs([job(200 + i, queue="q-b", cpu=3, pkg=pkg) for i in range(10)])
    yield inc
    # Past the padded capacity: a reset.
    inc.add_jobs([job(400 + i, pkg=pkg) for i in range(120)])
    yield inc
    inc.set_priority("job-0005", 3)
    yield inc


def test_last_sync_matches_reference():
    """The port's ResidentRound books what the reference's books on one
    delta sequence: mode, fields, permuted and bytes_up, cycle by cycle."""
    port = ResidentRound(device="cpu")
    ref = RefResidentRound()
    modes = []
    for inc_p, inc_r in zip(_sequence(PORT, IncrementalRound), _sequence(REF, RefIncrementalRound)):
        port.device_round(inc_p)
        ref.device_round(inc_r)
        assert port.last_sync == ref.last_sync, (port.last_sync, ref.last_sync)
        assert port.check_drift() == []
        modes.append((port.last_sync["mode"], port.last_sync["permuted"]))
    assert ("delta", True) in modes and ("delta", False) in modes
    assert [m for m, _ in modes].count("reset") == 2


def _market_inputs():
    return (make_config(market_driven=True), "default", make_nodes(4), QUEUES, [], _bid_jobs(24))


CASES = {
    # name: (inputs, solve keywords)
    "fused": (lambda: build_inputs(200, 8, n_running=16), {}),
    "budgeted": (lambda: build_inputs(200, 8, n_running=16),
                 {"budget_s": 1e-6, "chunk_loops": 3}),
    "compacted": (lambda: build_inputs(200, 8, n_running=16, fill_window=2),
                  {"window": 2, "window_min_slots": 0}),
    "compacted_fast_fill": (lambda: build_inputs(200, 8, n_running=16, fast_fill=True,
                                                 fill_window=2),
                            {"window": 2, "window_min_slots": 0, "budget_s": 60.0}),
    "market": (_market_inputs, {}),
    "priority": (lambda: policy_inputs(build_inputs(200, 8, n_running=16), "priority"), {}),
}


def _reference_round(dev):
    """The port's padded round as the JAX package's DeviceRound."""
    names = [f.name for f in dataclasses.fields(ref_prep.DeviceRound)]
    return ref_prep.DeviceRound(**{**{n: getattr(dev, n) for n in names}, "kernel_path": "lax"})


@pytest.mark.parametrize("case", sorted(CASES))
def test_solves_leave_the_resident_round_untouched(case):
    """Two solves of one resident tree on the "cuda" path (the kernels'
    plain versions): no drift after either, equal to each other, to a
    fresh upload's solve and to the reference's solve of the same round;
    then a delta cycle leaves the first outputs untouched, and the delta
    tree solves as a fresh upload does."""
    make_inputs, kw = CASES[case]
    inc = IncrementalRound(*make_inputs())
    resident = ResidentRound(device="cpu")
    dev = resident.device_round(inc)
    fresh = pad_device_round(inc.device_round())
    want = ref_kernel.solve_round(_reference_round(fresh), **{
        k: v for k, v in kw.items() if k in ("budget_s", "chunk_loops")})
    first = resident_solve(resident, dev, **kw)
    if case.startswith("compacted"):
        assert first["profile"]["compacted"], case
    if case == "budgeted":
        assert first["truncated"] is True and want["truncated"] is True
    if case == "market":
        assert dev.market_driven and first["spot_price"] == first["spot_price"]
    assert int(np.asarray(first["scheduled_mask"]).sum()) > 0
    assert resident.check_drift() == []
    kept = {k: np.array(first[k]) for k in DECISION_KEYS}
    second = resident_solve(resident, dev, **kw)
    assert resident.check_drift() == []
    _same_decisions(second, first, f"{case}: second solve")
    _same_decisions(first, solve_round(fresh, device="cpu", **kw), f"{case}: fresh upload")
    _assert_same(case, {k: first[k] for k in want}, want)

    lease_some(inc, first, 8)
    snap = inc.snapshot()
    inc.add_jobs([dataclasses.replace(snap_job, id=f"again-{i}")
                  for i, snap_job in enumerate(make_inputs()[5][:8])])
    dev = resident.device_round(inc)
    assert resident.last_sync["mode"] == "delta"
    for k in DECISION_KEYS:
        assert np.array_equal(np.asarray(first[k]), kept[k], equal_nan=True), (case, k)
    third = resident_solve(resident, dev, **kw)
    assert resident.check_drift() == []
    _same_decisions(third, solve_round(pad_device_round(inc.device_round()), device="cpu", **kw),
                    f"{case}: after a delta")


def test_warm_cycle_and_a_replaced_kernel_path():
    """workload.WarmCycle, bench.py's warm cycle, on the CPU: each cycle
    a delta sync, a solve booking no upload, admitted, no drift, equal to
    a fresh upload's solve. A "lax" solve of the resident tree (its
    kernel path replaced on the returned tree, as the scheduler's ladder
    does) equals the "cuda" one and forces no reset."""
    from armada_tpu_torch.core.config import RateLimits
    from armada_tpu_torch.workload import WarmCycle

    # A burst of 60 jobs a round keeps every cycle leasing on a pool with
    # room to spare, inside the padded capacity.
    cfg, *rest = build_inputs(600, 200, n_running=16, fast_fill=True, fill_window=4)
    cfg = dataclasses.replace(cfg, rate_limits=RateLimits(
        maximum_scheduling_burst=60, maximum_per_queue_scheduling_burst=60))
    warm = WarmCycle((cfg, *rest), device="cpu")
    assert warm.window == 8
    assert warm.cold()["sync"]["mode"] == "reset"
    for _ in range(2):
        rec = warm.cycle()
        assert rec["leased"] > 0 and rec["sync"]["mode"] == "delta"
        assert rec["transfer"]["bytes_up"] == 0 and rec["violation"] is None
        assert 0.0 <= rec["snapshot_s"] <= rec["h2d_s"]
        assert rec["cycle_s"] == rec["delta_s"] + rec["h2d_s"] + rec["solve_s"]
        assert warm.resident.check_drift() == []
        fresh, _ = warm.fresh_solve()
        _same_decisions(warm.out, fresh, "warm cycle")
    dev = warm.resident.device_round(warm.inc)
    lax = warm.solve(dataclasses.replace(dev, kernel_path="lax"), warm.resident.host_round(),
                     warm.inc.snapshot().num_jobs)
    _same_decisions(lax, warm.out, "lax")
    warm.inc.set_round_params(global_rate_tokens=1e9)
    assert warm.resident.device_round(warm.inc) is dev
    assert warm.resident.last_sync["mode"] == "delta"
    assert 0.0 < warm.fairness()["jain"] <= 1.0
