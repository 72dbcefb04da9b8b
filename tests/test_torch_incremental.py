"""The port's IncrementalRound (armada_tpu_torch/snapshot/incremental.py).

Port copies of tests/test_incremental.py's six tests, on the port's own
types and solve (`solve_round(device="cpu")`): the incremental state
reaches the same decisions as a fresh `build_round_snapshot` at every
point of a delta sequence (adds, binds, removals, unbinds, gang
completion across cycles, market bids, key-group compaction, growth past
capacity), refuses what it cannot absorb, and leaves its state untouched
when a batch fails.

And one cross-package test: the same delta sequence applied to both
packages' IncrementalRound gives a `pad_device_round(inc.device_round())`
bit-equal field by field at every cycle, and the port's solve of it
equals the reference's (decisions, num_loops and spot_price bit-exact,
fair shares within 4/16 ULP, `test_torch_round._assert_same`).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch_cpu  # noqa: F401

import armada_tpu.core.config as ref_config
import armada_tpu.core.types as ref_types
import armada_tpu.snapshot.incremental as ref_incremental
from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver import kernel_prep as ref_prep
import armada_tpu_torch.core.config as port_config
import armada_tpu_torch.core.types as port_types
from armada_tpu_torch.snapshot.incremental import IncrementalRound, SnapshotRebuildRequired
from armada_tpu_torch.snapshot.round import build_round_snapshot
from armada_tpu_torch.solver.kernel import solve_round
from armada_tpu_torch.solver.kernel_prep import _META_FIELDS, pad_device_round, prep_device_round
from test_torch_round import _assert_same

# Each package's config and types modules, for inputs built for either.
PORT = types.SimpleNamespace(config=port_config, types=port_types)
REF = types.SimpleNamespace(config=ref_config, types=ref_types)


def make_config(pkg=PORT, **kw):
    c = pkg.config
    return c.SchedulingConfig(
        priority_classes={
            "high": c.PriorityClass("high", 30000, preemptible=False),
            "low": c.PriorityClass("low", 1000, preemptible=True),
        },
        default_priority_class="low",
        **kw,
    )


def make_nodes(n=8, pkg=PORT):
    t = pkg.types
    nodes = []
    for i in range(n):
        taints = (t.Taint("gpu", "true", "NoSchedule"),) if i % 4 == 3 else ()
        labels = {"zone": f"z{i % 2}", "disk": "ssd" if i % 2 else "hdd"}
        nodes.append(
            t.NodeSpec(
                id=f"node-{i:03d}",
                pool="default",
                taints=taints,
                labels=labels,
                total_resources={"cpu": "16", "memory": "64Gi"},
            )
        )
    return nodes


def job(i, queue="q-a", cpu=2, pc="low", prio=0, sel=None, tol=False, gang=None, pkg=PORT,
        bid=None):
    t = pkg.types
    return t.JobSpec(
        id=f"job-{i:04d}",
        queue=queue,
        priority=prio,
        priority_class=pc,
        requests={"cpu": str(cpu), "memory": f"{cpu * 2}Gi"},
        node_selector=sel or {},
        tolerations=(t.Toleration("gpu", "Equal", "true", "NoSchedule"),) if tol else (),
        gang=gang,
        submitted_ts=float(i),
        bid_prices=bid or {},
    )


def queues(pkg=PORT):
    return [pkg.types.QueueSpec("q-a", 1.0), pkg.types.QueueSpec("q-b", 2.0)]


QUEUES = queues()


def solve_ids(snap, dev):
    """Solve and decode to comparable, row-order-independent structures."""
    out = solve_round(pad_device_round(dev), device="cpu")
    J = snap.num_jobs
    sched = {}
    for j in np.flatnonzero(np.asarray(out["scheduled_mask"][:J])):
        sched[str(snap.job_ids[j])] = (
            snap.node_ids[int(out["assigned_node"][j])],
            int(out["scheduled_priority"][j]),
        )
    preempted = {
        str(snap.job_ids[j]) for j in np.flatnonzero(np.asarray(out["preempted_mask"][:J]))
    }
    fs = np.asarray(out["fair_share"][: snap.num_queues])
    return sched, preempted, fs


class Mirror:
    """Python-object mirror of the incremental state, driving fresh builds."""

    def __init__(self, cfg, nodes, running, queued):
        self.cfg = cfg
        self.nodes = nodes
        self.running = {r.job.id: r for r in running}
        self.queued = {j.id: j for j in queued}

    def fresh(self):
        return build_round_snapshot(
            self.cfg, "default", self.nodes, QUEUES,
            list(self.running.values()), list(self.queued.values()),
        )

    def add(self, jobs):
        for j in jobs:
            self.queued[j.id] = j

    def bind(self, leases):
        for jid, nid, prio, ts in leases:
            self.running[jid] = port_types.RunningJob(
                job=self.queued.pop(jid), node_id=nid, scheduled_at_priority=prio, leased_ts=ts,
            )

    def unbind(self, ids):
        for jid in ids:
            self.queued[jid] = self.running.pop(jid).job

    def remove(self, ids):
        for jid in ids:
            self.running.pop(jid, None)
            self.queued.pop(jid, None)


def assert_same_decisions(inc, mirror):
    snap_i = inc.snapshot()
    dev_i = inc.device_round()
    snap_f = mirror.fresh()
    dev_f = prep_device_round(snap_f)
    s_i, p_i, fs_i = solve_ids(snap_i, dev_i)
    s_f, p_f, fs_f = solve_ids(snap_f, dev_f)
    assert s_i == s_f
    assert p_i == p_f
    np.testing.assert_allclose(fs_i, fs_f, rtol=1e-12)
    # Accounting parity, mapped by id (row orders differ).
    ids_f = list(snap_f.job_ids)
    rows_i = [inc._id_to_row[i] for i in ids_f]
    np.testing.assert_array_equal(snap_i.job_req[rows_i], snap_f.job_req)
    np.testing.assert_array_equal(snap_i.job_queue[rows_i], snap_f.job_queue)
    np.testing.assert_array_equal(snap_i.job_is_running[rows_i], snap_f.job_is_running)
    np.testing.assert_array_equal(snap_i.job_priority[rows_i], snap_f.job_priority)
    np.testing.assert_array_equal(snap_i.queue_allocated, snap_f.queue_allocated)
    np.testing.assert_array_equal(snap_i.queue_demand, snap_f.queue_demand)
    np.testing.assert_array_equal(snap_i.allocatable, snap_f.allocatable)
    # Node identity of bound jobs.
    for k, r in zip(range(len(ids_f)), rows_i):
        nf = snap_f.job_node[k]
        ni = snap_i.job_node[r]
        if nf >= 0 or ni >= 0:
            assert snap_i.node_ids[ni] == snap_f.node_ids[nf]
    # Relative within-queue order among live jobs must match.
    of = np.argsort(snap_f.job_order)
    oi = np.argsort(snap_i.job_order[rows_i])
    assert [ids_f[int(j)] for j in of] == [ids_f[int(j)] for j in oi]


def test_lifecycle_differential():
    cfg = make_config()
    nodes = make_nodes(8)
    running = [
        port_types.RunningJob(job=job(900 + i, cpu=4), node_id=f"node-{i:03d}",
                              scheduled_at_priority=1000, leased_ts=float(i))
        for i in range(2)
    ]
    queued = [job(i, queue="q-a" if i % 2 else "q-b", cpu=1 + i % 3,
                  sel={"zone": "z0"} if i % 5 == 0 else None, tol=i % 7 == 0)
              for i in range(40)]
    inc = IncrementalRound(cfg, "default", nodes, QUEUES, running, queued)
    mirror = Mirror(cfg, nodes, running, queued)
    assert_same_decisions(inc, mirror)

    # Cycle 1: submit more work, including a gang that stays incomplete.
    gang = port_types.Gang(id="g1", cardinality=3)
    new1 = [job(100 + i, cpu=2, gang=gang) for i in range(2)]
    new1 += [job(120 + i, queue="q-b", cpu=1, prio=-1) for i in range(5)]
    inc.add_jobs(new1)
    mirror.add(new1)
    assert_same_decisions(inc, mirror)

    # Cycle 2: the gang completes; bind a few of last round's decisions.
    new2 = [job(102, cpu=2, gang=gang)]
    inc.add_jobs(new2)
    mirror.add(new2)
    sched, _, _ = solve_ids(inc.snapshot(), inc.device_round())
    leases = [(jid, nid, prio, 50.0) for jid, (nid, prio) in sorted(sched.items())[:6]]
    inc.bind(leases)
    mirror.bind(leases)
    assert_same_decisions(inc, mirror)

    # Cycle 3: some running jobs finish, some queued are cancelled.
    done = [leases[0][0], leases[1][0], "job-0003", "job-0010"]
    inc.remove_jobs(done)
    mirror.remove(done)
    assert_same_decisions(inc, mirror)

    # Cycle 4: a running job is preempted back to queued.
    back = [leases[2][0]]
    inc.unbind(back)
    mirror.unbind(back)
    assert_same_decisions(inc, mirror)

    # Cycle 5: row reuse — new submits land in tombstoned rows.
    new3 = [job(200 + i, queue="q-b", cpu=3) for i in range(6)]
    inc.add_jobs(new3)
    mirror.add(new3)
    assert_same_decisions(inc, mirror)


def _bid_jobs(n, pkg=PORT):
    return [
        pkg.types.JobSpec(
            id=f"bid-{i:03d}",
            queue="q-a" if i % 2 else "q-b",
            priority_class="low",
            requests={"cpu": "2", "memory": "4Gi"},
            submitted_ts=float(i),
            bid_prices={"default": {"queued": 1.0 + i * 0.25, "running": 2.0 + i * 0.25}},
        )
        for i in range(n)
    ]


def test_market_lifecycle():
    cfg = make_config(market_driven=True)
    nodes = make_nodes(4)
    queued = _bid_jobs(12)
    inc = IncrementalRound(cfg, "default", nodes, QUEUES, [], queued)
    mirror = Mirror(cfg, nodes, [], queued)
    assert_same_decisions(inc, mirror)

    sched, _, _ = solve_ids(inc.snapshot(), inc.device_round())
    leases = [(jid, nid, p, 9.0) for jid, (nid, p) in sorted(sched.items())[:3]]
    inc.bind(leases)
    mirror.bind(leases)
    assert_same_decisions(inc, mirror)

    # Market unbind restores the queued-phase bid.
    inc.unbind([leases[0][0]])
    mirror.unbind([leases[0][0]])
    assert_same_decisions(inc, mirror)


def test_vocab_miss_raises():
    cfg = make_config()
    nodes = make_nodes(4)
    inc = IncrementalRound(cfg, "default", nodes, QUEUES, [], [job(i) for i in range(4)])
    # "disk" exists on nodes but was never referenced -> not interned.
    with pytest.raises(SnapshotRebuildRequired):
        inc.add_jobs([job(50, sel={"disk": "ssd"})])
    # Unknown queue.
    with pytest.raises(SnapshotRebuildRequired):
        inc.add_jobs([port_types.JobSpec(id="x", queue="nope", requests={"cpu": "1"})])
    # A selector on a key no node carries is NOT a rebuild (impossible job).
    inc.add_jobs([job(51, sel={"ghost": "v"})])
    assert not inc.snapshot().job_possible[inc._id_to_row["job-0051"]]


def test_failed_batch_leaves_state_untouched():
    cfg = make_config()
    nodes = make_nodes(2)
    queued = [job(i) for i in range(4)]
    inc = IncrementalRound(cfg, "default", nodes, QUEUES, [], queued)
    size0, free0, gen0 = inc._size, list(inc._free), inc._gen
    # Duplicate ids WITHIN one batch must raise, not leak a ghost row.
    with pytest.raises(SnapshotRebuildRequired):
        inc.add_jobs([job(50), job(50)])
    assert (inc._size, inc._free, inc._gen) == (size0, free0, gen0)
    assert "job-0050" not in inc._id_to_row
    # A malformed quantity raises before any mutation.
    bad = port_types.JobSpec(id="bad", queue="q-a", requests={"memory": "4GiBB"})
    with pytest.raises(ValueError):
        inc.add_jobs([job(51), bad])
    assert (inc._size, inc._free, inc._gen) == (size0, free0, gen0)
    assert "job-0051" not in inc._id_to_row
    # State still fully functional.
    assert_same_decisions(inc, Mirror(cfg, nodes, [], queued))


def test_key_group_compaction():
    cfg = make_config()
    nodes = make_nodes(2)
    inc = IncrementalRound(cfg, "default", nodes, QUEUES, [], [job(0)])
    mirror = Mirror(cfg, nodes, [], [job(0)])
    # Churn 1500 distinct request shapes through the state; without
    # compaction num_key_groups would exceed 1500.
    for wave in range(3):
        batch = [
            port_types.JobSpec(
                id=f"w{wave}-{i}", queue="q-a",
                requests={"cpu": "1", "memory": f"{1000 + wave * 500 + i}Ki"},
                submitted_ts=float(i),
            )
            for i in range(500)
        ]
        inc.add_jobs(batch)
        mirror.add(batch)
        ids = [j.id for j in batch[:400]]
        inc.remove_jobs(ids)
        mirror.remove(ids)
    assert inc._num_key_groups < 1500
    assert_same_decisions(inc, mirror)


def test_grow_past_capacity():
    cfg = make_config()
    nodes = make_nodes(2)
    queued = [job(i) for i in range(3)]
    inc = IncrementalRound(cfg, "default", nodes, QUEUES, [], queued)
    mirror = Mirror(cfg, nodes, [], queued)
    big = [job(1000 + i, cpu=1) for i in range(2000)]
    inc.add_jobs(big)
    mirror.add(big)
    assert inc._cap >= 2003
    assert_same_decisions(inc, mirror)


# ---------------------------------------------------------------------------
# cross-package: one delta sequence through both packages' IncrementalRound
# ---------------------------------------------------------------------------


def _initial(pkg, kind):
    """(config, nodes, queues, running, queued) of one package."""
    t = pkg.types
    extra = {"solve_kernel_path": "lax"}
    if kind == "market":
        return (make_config(pkg, market_driven=True, **extra), make_nodes(4, pkg), queues(pkg),
                [], _bid_jobs(12, pkg))
    if kind == "fast_fill":
        extra.update(enable_fast_fill=True, batch_fill_window=4)
    running = [
        t.RunningJob(job=job(900 + i, cpu=4, pkg=pkg), node_id=f"node-{i:03d}",
                     scheduled_at_priority=1000, leased_ts=float(i))
        for i in range(3)
    ]
    queued = [job(i, queue="q-a" if i % 2 else "q-b", cpu=1 + i % 3,
                  sel={"zone": "z0"} if i % 5 == 0 else None, tol=i % 7 == 0, pkg=pkg)
              for i in range(40)]
    return make_config(pkg, **extra), make_nodes(8, pkg), queues(pkg), running, queued


def _delta_steps(pkg, kind):
    """The delta sequence, one callable per cycle: each takes (inc, the
    decoded last decisions) and applies one cycle's deltas."""
    t = pkg.types

    def lease(inc, sched, n, ts):
        leases = [(jid, nid, p, ts) for jid, (nid, p) in sorted(sched.items())[:n]]
        inc.bind(leases)
        return [jid for jid, *_ in leases]

    if kind == "market":
        def market_1(inc, sched, st):
            st["leased"] = lease(inc, sched, 3, 9.0)

        def market_2(inc, sched, st):
            inc.unbind(st["leased"][:1])
            inc.add_jobs([job(300 + i, queue="q-b", cpu=2, pkg=pkg,
                              bid={"default": {"queued": 4.0 + i, "running": 5.0 + i}})
                          for i in range(3)])

        def market_3(inc, sched, st):
            inc.remove_jobs(st["leased"][1:2] + ["bid-005"])
            inc.set_round_params(global_rate_tokens=2.0)

        return [market_1, market_2, market_3]

    gang = t.Gang(id="g1", cardinality=3)

    def step_1(inc, sched, st):
        inc.add_jobs([job(100 + i, cpu=2, gang=gang, pkg=pkg) for i in range(2)]
                     + [job(120 + i, queue="q-b", cpu=1, prio=-1, pkg=pkg) for i in range(5)])

    def step_2(inc, sched, st):
        inc.add_jobs([job(102, cpu=2, gang=gang, pkg=pkg)])
        st["leased"] = lease(inc, sched, 6, 50.0)

    def step_3(inc, sched, st):
        inc.remove_jobs(st["leased"][:2] + ["job-0003", "job-0010"])
        inc.set_priority("job-0011", 7)
        inc.set_round_params(excluded_nodes={"job-0013": ["node-001", "node-002"]},
                             cordoned_queues={"q-a"}, global_rate_tokens=20.0)

    def step_4(inc, sched, st):
        inc.unbind(st["leased"][2:3])
        inc.set_round_params(short_job_penalty={"q-b": {"cpu": "1"}})

    def step_5(inc, sched, st):
        inc.add_jobs([job(200 + i, queue="q-b", cpu=3, pkg=pkg) for i in range(6)])
        lease(inc, sched, 4, 60.0)

    return [step_1, step_2, step_3, step_4, step_5]


def _assert_rounds_bit_equal(label, got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), (label, f.name)
            assert g.dtype == w.dtype and g.shape == w.shape, (label, f.name)
            assert g.tobytes() == w.tobytes(), (label, f.name)
        elif f.name in _META_FIELDS:
            assert tuple(np.atleast_1d(g)) == tuple(np.atleast_1d(w)), (label, f.name)
        else:
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), (label, f.name)


def _decode(snap, out):
    J = snap.num_jobs
    return {
        str(snap.job_ids[j]): (snap.node_ids[int(out["assigned_node"][j])],
                               int(out["scheduled_priority"][j]))
        for j in np.flatnonzero(np.asarray(out["scheduled_mask"])[:J])
    }


@pytest.mark.parametrize("kind", ["default", "fast_fill", "market"])
def test_delta_sequence_bit_equal_across_packages(kind):
    """Both packages' IncrementalRound under one delta sequence: the
    padded rounds bit-equal field by field at every cycle, the port's
    solve ("lax" and "cuda" with the kernels' plain versions) equal to
    the reference's "lax" solve."""
    incs = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        cls = IncrementalRound if pkg is PORT else ref_incremental.IncrementalRound
        cfg, *rest = _initial(pkg, kind)
        incs[name] = cls(cfg, "default", *rest)
    steps = {"port": _delta_steps(PORT, kind), "ref": _delta_steps(REF, kind)}
    state = {"port": {}, "ref": {}}
    for cycle in range(len(steps["port"]) + 1):
        label = f"{kind}/cycle {cycle}"
        got = pad_device_round(incs["port"].device_round())
        want = ref_prep.pad_device_round(incs["ref"].device_round())
        assert incs["port"]._gen == incs["ref"]._gen, label
        _assert_rounds_bit_equal(label, got, want)
        ref_out = ref_kernel.solve_round(want)
        for path in ("lax", "cuda"):
            out = solve_round(dataclasses.replace(got, kernel_path=path), device="cpu")
            _assert_same(f"{label}/{path}", out, ref_out)
        if cycle == len(steps["port"]):
            break
        sched = _decode(incs["port"].snapshot(), out)
        assert sched == _decode(incs["ref"].snapshot(), ref_out), label
        for name in ("port", "ref"):
            steps[name][cycle](incs[name], sched, state[name])
