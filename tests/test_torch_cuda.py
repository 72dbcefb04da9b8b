"""The hand-written CUDA kernels against their plain torch versions, on
the card (marker `cuda`; each test skips where there is no card). This
file imports no JAX, so it also runs on a machine with only the port:

    python -m pytest tests/test_torch_cuda.py -q

The input builders here are shared with tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from armada_tpu_torch.ops import kernels as tk
from armada_tpu_torch.ops.bitset import as_words

SENTINEL = np.iinfo(np.int64).max
# The fair shares' bounds in ULP (tests/test_torch_round.py).
ULP_BOUNDS = {"fair_share": 4, "demand_capped_fair_share": 4, "uncapped_fair_share": 16}


def _ulps(a, b):
    def ordered(x):
        i = np.ascontiguousarray(x, dtype=np.float64).view(np.int64)
        return np.where(i < 0, np.int64(-(2**63)) - i, i)

    return np.abs(ordered(a) - ordered(b))
# The kernels a sharded round launches; the ring kernel is driven apart.
ROUND_KERNELS = ("score_nodes", "fill_take", "winner_reduce")


def _score_inputs(rng, n, *, with_aff=True, job_ok=True, shards=1):
    """Inputs of score_nodes at n nodes; with shards > 1, those of the last
    of `shards` node blocks as a shard of the sharded round sees them: gids
    offset to the block, ranks, affinity row and rank bits global."""
    r = 3
    n_global = n * shards
    offset = n_global - n
    total = rng.integers(0, 40, size=(n, r)).astype(np.int32)
    # Negative allocatable (over-allocated nodes) exercises floor division.
    alloc0 = (total - rng.integers(-5, 45, size=(n, r))).astype(np.int32)
    taints = np.where(
        rng.random((n, 2)) < 0.3,
        rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64),
        0,
    ).astype(np.uint32)
    taints[::7, 1] |= np.uint32(0x80000000)
    labels = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(np.uint32)
    rank = rng.permutation(n_global)[offset:].astype(np.int32)
    gid = np.arange(offset, n_global, dtype=np.int32)
    unsched = rng.random(n) < 0.1
    aff_row = rng.integers(0, 2**32, size=(n_global + 31) // 32, dtype=np.uint64).astype(np.uint32)
    aff_row[offset // 32] |= np.uint32(0x80000000)
    tolerated = np.array([0xFFFF0000, 0x8000FFFF], dtype=np.uint32)
    selector = np.array([0x00000101, 0], dtype=np.uint32)
    req_fit = np.array([3, 0, 7], dtype=np.int32)
    excl = np.array([offset + 1, offset + 5, -1, -1], dtype=np.int32)
    oidx = np.array([0, 2], dtype=np.int32)
    ores = np.array([1, 2], dtype=np.int32)
    bits = (6, 5, max(1, (n_global - 1).bit_length()))
    return dict(
        alloc0=alloc0, node_total=total, taints=taints, labels=labels,
        rank=rank, gid=gid, unsched=unsched,
        aff_row=aff_row if with_aff else None, tolerated=tolerated,
        selector=selector, req_fit=req_fit, excl=excl, oidx=oidx,
        ores=ores, bits=bits, batch_window=8, job_ok=job_ok,
    )


def _port_args(a, device="cpu"):
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return dict(
        alloc0=t(a["alloc0"]), node_total=t(a["node_total"]),
        taints=t(as_words(a["taints"])), labels=t(as_words(a["labels"])),
        rank=t(a["rank"]), gid=t(a["gid"]), unsched=t(a["unsched"]),
        aff_row=None if a["aff_row"] is None else t(as_words(a["aff_row"])),
        tolerated=t(as_words(a["tolerated"])), selector=t(as_words(a["selector"])),
        req_fit=t(a["req_fit"]), excl=t(a["excl"]),
        order_res_idx=t(a["oidx"]), order_res_resolution=t(a["ores"]),
        bits=t(np.asarray(a["bits"], np.int32)),
        batch_window=a["batch_window"], job_ok=a["job_ok"],
    )


# (n, B, key span, dead share, reference fill_take meets the contract)
_TAKE_SPECS = (
    (512, 64, 2**40, 0.4, True),    # distinct keys, sentinel entries
    (1024, 256, 8, 0.3, False),     # heavy duplicates across the threshold
    (256, 200, 2**30, 0.9, False),  # fewer real keys than B: sentinel tail
    (100, 512, 2**20, 0.2, True),   # B > N
    (64, 64, 4, 0.0, True),         # B == N, duplicates only
)


def _take_cases():
    rng = np.random.default_rng(7)
    cases = []
    for n, b, span, dead, _ in _TAKE_SPECS:
        keys = rng.integers(0, span, size=n, dtype=np.int64)
        keys = np.where(rng.random(n) < dead, SENTINEL, keys)
        cases.append((keys, b))
    return cases


def _winner_inputs(rng, p, span, found_share):
    """Gathered winner tuples of P hosts: two duplicate-heavy leading keys
    and a permutation as the last key (the node rank), int32 throughout."""
    keys = [rng.integers(0, span, size=p).astype(np.int32) for _ in range(2)]
    keys.append(rng.permutation(p).astype(np.int32))
    found = rng.random(p) < found_share
    gids = (np.arange(p) + 7).astype(np.int32)
    return keys, found, gids


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _score_plan_on(a, device):
    """A ScorePlan of three jobs over the nodes of _score_inputs' `a`: job 0
    is a's job (affinity group 0), job 1 the same without a group, job 2 in
    group 1 and not possible."""
    p = _port_args(a, device=device)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    three = lambda v: np.stack([v, v, v])  # noqa: E731
    aff = as_words(np.stack([a["aff_row"], np.roll(a["aff_row"], 1)]))
    plan = tk.ScorePlan(
        p["node_total"], p["taints"], p["labels"], p["rank"], p["gid"], p["unsched"],
        t(three(as_words(a["tolerated"]))), t(three(as_words(a["selector"]))),
        t(three(a["req_fit"])), t(three(a["excl"])), t(np.array([0, -1, 1], np.int32)),
        t(np.array([True, True, False])), t(aff), p["order_res_idx"],
        p["order_res_resolution"], p["bits"], a["batch_window"],
    )
    rows = [
        {**p, "aff_row": t(aff[0])},
        {**p, "aff_row": None},
        {**p, "aff_row": t(aff[1]), "job_ok": False},
    ]
    return p, plan, rows


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    for n, shards in ((4096, 1), (2048, 4), (65536, 1)):
        a = _score_inputs(np.random.default_rng(12), n, shards=shards)
        p, plan, rows = _score_plan_on(a, "cuda")
        got = tk.score_nodes(**p)
        want = tk.score_nodes_plain(**p)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for j, row in enumerate(rows):
            got = plan.score(p["alloc0"], j)
            want = tk.score_nodes_plain(**row)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (n, shards, j)
    for keys, b in _take_cases():
        kt = torch.as_tensor(keys, device=cuda_device)
        got = tk.fill_take(kt, b)
        want = tk.fill_take_plain(kt, b)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # Every cluster size, ragged slices, a ragged head, the streamed path.
    rng = np.random.default_rng(14)
    for n, cluster, resident in (
        (8192, 1, True), (16384, 2, True), (32768, 4, True), (65536, 8, True),
        (4097, 1, True), (20001, 4, True), (262144, 8, False),
    ):
        cfg = tk.fill_take_config(n, 512)
        assert (cfg.cluster, cfg.resident) == (cluster, resident)
        keys = rng.integers(0, 2**40, size=n + 1, dtype=np.int64)
        keys[rng.random(n + 1) < 0.3] = SENTINEL
        base = torch.as_tensor(keys, device=cuda_device)
        for kt in (base[:n], base[1:]):
            # 4,096 and 8,192: past the shared-memory budget, the global sort.
            for b in (1, 512, 2048, 4096, 8192):
                got = tk.fill_take(kt, b)
                want = tk.fill_take_plain(kt, b)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (n, b)


@pytest.mark.cuda
def test_fast_fill_rounds_on_card_equal_rounds_on_cpu(cuda_device):
    """Fast fill on the card: the bench round at a window of 512 (with its
    evicted jobs' rebind window) and of 4,096 on more nodes (fill_take
    past its shared-memory budget), and the home/away round, each equal
    to the same solve on the CPU, with both fill kernels launched."""
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.parallel.scenarios import home_away_round
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import build_inputs

    snaps = [
        build_round_snapshot(*build_inputs(4000, 200, n_running=400, fast_fill=True)),
        build_round_snapshot(*build_inputs(3000, 4500, n_running=0, fast_fill=True,
                                           fill_window=4096)),
        home_away_round(256, 1024),
    ]
    for snap in snaps:
        dev = pad_device_round(prep_device_round(snap))
        K.reset_launches()
        stats = {}
        on_card = solve_round(dev, stats=stats)
        assert K.LAUNCHES["score_nodes"] > 0 and K.LAUNCHES["fill_take"] > 0
        assert stats["merged_fill_loops"] > 0
        on_cpu = solve_round(dev, device="cpu")
        for k in on_cpu:
            assert np.array_equal(on_card[k], on_cpu[k], equal_nan=True), k


def _same_round(got, want, what):
    """Decisions, num_loops and spot_price bit-equal, fair shares within
    their ULP bounds (float64 sums may pair differently on the card)."""
    for k in want:
        if k in ULP_BOUNDS:
            assert int(_ulps(got[k], want[k]).max()) <= ULP_BOUNDS[k], (what, k)
        else:
            assert np.array_equal(got[k], want[k], equal_nan=True), (what, k)


@pytest.mark.cuda
def test_policy_rounds_on_card_equal_lax_and_cpu(cuda_device):
    """The bench round with fast fill under each fairness policy (queue
    weights 1 to 10, deadlines stamped): "cuda" bit-equal to "lax" on the
    card with both fill kernels launched, and equal to the CPU solve."""
    import dataclasses

    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import POLICY_KINDS, build_inputs, repolicy

    base = pad_device_round(prep_device_round(build_round_snapshot(
        *build_inputs(4000, 200, n_running=400, fast_fill=True))))
    for kind in POLICY_KINDS:
        dev = repolicy(base, kind)
        K.reset_launches()
        stats = {}
        on_card = solve_round(dev, stats=stats)
        assert K.LAUNCHES["score_nodes"] > 0 and K.LAUNCHES["fill_take"] > 0, kind
        assert stats["merged_fill_loops"] > 0, kind
        lax = solve_round(dataclasses.replace(dev, kernel_path="lax"))
        for k in lax:
            assert np.array_equal(on_card[k], lax[k], equal_nan=True), (kind, k)
        _same_round(on_card, solve_round(dev, device="cpu"), kind)


@pytest.mark.cuda
def test_market_round_on_card_equals_lax_cpu_and_mesh(cuda_device):
    """market_round(128, 2048) on the card: "cuda" bit-equal to "lax"
    (a market round takes no fill, so on one device only the segment
    kernel launches, and "lax" launches none), equal to the CPU solve, and a 2x2 mesh of shard threads
    on the card equal to it with every select through winner_reduce."""
    import dataclasses

    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.parallel.mesh import pad_nodes
    from armada_tpu_torch.parallel.multihost import resolve_solver
    from armada_tpu_torch.parallel.scenarios import market_round
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round

    dev = pad_device_round(prep_device_round(market_round(128, 2048)))
    K.reset_launches()
    on_card = solve_round(dev)
    assert sum(K.LAUNCHES[name] for name in ROUND_KERNELS) == 0
    assert K.LAUNCHES["segment_add"] > 0
    K.reset_launches()
    lax = solve_round(dataclasses.replace(dev, kernel_path="lax"))
    assert sum(K.LAUNCHES.values()) == 0
    for k in lax:
        assert np.array_equal(on_card[k], lax[k], equal_nan=True), k
    _same_round(on_card, solve_round(dev, device="cpu"), "market")
    run = resolve_solver("2x2", "cuda", devices=_card_devices(4))
    K.reset_launches()
    sharded = run(pad_nodes(dev, 4))
    for k in on_card:
        assert np.array_equal(sharded[k], on_card[k], equal_nan=True), k
    stats = run.last_stats.as_dict()
    assert stats["selects"] > 0
    assert K.LAUNCHES["winner_reduce"] == 2 * stats["selects"] * 4


@pytest.mark.cuda
def test_round_on_card_equals_round_on_cpu(cuda_device):
    """A small round of the bench's shape solves to the same arrays on the
    card (kernels) and on the CPU (plain versions)."""
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import build_inputs

    dev = pad_device_round(prep_device_round(build_round_snapshot(
        *build_inputs(2000, 100, n_running=200)
    )))
    K.reset_launches()
    on_card = solve_round(dev)
    assert K.LAUNCHES["score_nodes"] > 0 and K.LAUNCHES["fill_take"] > 0
    on_cpu = solve_round(dev, device="cpu")
    for k in on_cpu:
        assert np.array_equal(on_card[k], on_cpu[k], equal_nan=True), k


@pytest.mark.cuda
def test_driver_rounds_on_card_equal_rounds_on_cpu(cuda_device):
    """The host-driven driver on the card: compacted solves (a small
    window with rewindows, fast fill off and on, and the home/away round)
    equal to the card's fused solve and to the CPU's compacted solve, with
    both fill kernels launched in the windows; a budget of 1e-6 truncated
    on the card as on the CPU ("cuda" and "lax" equal), its placements and
    preemptions subsets of the full round's."""
    import dataclasses

    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.parallel.scenarios import home_away_round
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import build_inputs

    snaps = [
        build_round_snapshot(*build_inputs(4000, 200, n_running=400, fill_window=8)),
        build_round_snapshot(*build_inputs(4000, 200, n_running=400, fast_fill=True,
                                           fill_window=8)),
        home_away_round(1024, 4096),
    ]
    snaps[2] = dataclasses.replace(
        snaps[2], config=dataclasses.replace(snaps[2].config, batch_fill_window=8)
    )
    for snap in snaps:
        dev = pad_device_round(prep_device_round(snap))
        fused = solve_round(dev)
        K.reset_launches()
        win = solve_round(dev, window=8, window_min_slots=0)
        assert win["profile"]["compacted"] and win["profile"]["rewindows"] >= 1
        assert K.LAUNCHES["score_nodes"] > 0 and K.LAUNCHES["fill_take"] > 0
        on_cpu = solve_round(dev, device="cpu", window=8, window_min_slots=0)
        for k in fused:
            assert np.array_equal(win[k], fused[k], equal_nan=True), k
            # The fair shares' float64 sums run in another order on the
            # card: held within the port's ULP bounds, the rest exact.
            if k in ULP_BOUNDS:
                assert _ulps(win[k], on_cpu[k]).max() <= ULP_BOUNDS[k], k
            else:
                assert np.array_equal(win[k], on_cpu[k], equal_nan=True), k
        assert win["profile"]["rewindows"] == on_cpu["profile"]["rewindows"]

    dev = pad_device_round(prep_device_round(build_round_snapshot(
        *build_inputs(2000, 100, n_running=200)
    )))
    full = solve_round(dev)
    cuts = {p: solve_round(dataclasses.replace(dev, kernel_path=p), budget_s=1e-6)
            for p in ("cuda", "lax")}
    cuts["cpu"] = solve_round(dev, budget_s=1e-6, device="cpu")
    for cut in cuts.values():
        assert cut["truncated"] is True
        for k in full:
            assert np.array_equal(cut[k], cuts["cuda"][k], equal_nan=True), k
    placed = np.flatnonzero(cuts["cuda"]["scheduled_mask"])
    assert full["scheduled_mask"][placed].all()
    assert (cuts["cuda"]["assigned_node"][placed] == full["assigned_node"][placed]).all()
    assert not (cuts["cuda"]["preempted_mask"] & ~full["preempted_mask"]).any()


@pytest.mark.cuda
def test_warm_cycles_on_card_equal_warm_cycles_on_cpu(cuda_device):
    """The warm cycle with its round resident on the card: each cycle a
    delta sync below the reset's bytes, a solve booking no upload and
    launching both fill kernels, no drift, decisions equal to a fresh
    upload's solve on the card and to the same cycles on the CPU (fair
    shares within the port's ULP bounds); a "lax" solve of the resident
    tree equals it and forces no reset."""
    import dataclasses

    from armada_tpu_torch.core.config import RateLimits
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.workload import WarmCycle, build_inputs

    # A burst of 200 jobs a round: every cycle leases, inside the padded
    # capacity, on a pool with room to spare.
    cfg, *rest = build_inputs(4000, 400, n_running=400, fast_fill=True, fill_window=32)
    cfg = dataclasses.replace(cfg, rate_limits=RateLimits(
        maximum_scheduling_burst=200, maximum_per_queue_scheduling_burst=200))
    inputs = (cfg, *rest)
    card, cpu = WarmCycle(inputs, device=cuda_device), WarmCycle(inputs, device="cpu")
    reset = card.cold()["sync"]["bytes_up"]
    cpu.cold()
    for _ in range(3):
        K.reset_launches()
        rec = card.cycle()
        launches = dict(K.LAUNCHES)
        cpu.cycle()
        assert rec["leased"] > 0, rec
        assert rec["sync"]["mode"] == "delta" and rec["sync"]["bytes_up"] < reset, rec["sync"]
        assert rec["transfer"]["bytes_up"] == 0 and rec["violation"] is None
        assert launches["score_nodes"] > 0 and launches["fill_take"] > 0, launches
        assert card.resident.check_drift() == []
        fresh, _ = card.fresh_solve()
        for k in fresh:
            if k in ("profile", "truncated"):
                continue
            assert np.array_equal(card.out[k], fresh[k], equal_nan=True), k
            if k in ULP_BOUNDS:
                assert _ulps(card.out[k], cpu.out[k]).max() <= ULP_BOUNDS[k], k
            else:
                assert np.array_equal(card.out[k], cpu.out[k], equal_nan=True), k
    dev = card.resident.device_round(card.inc)
    lax = card.solve(dataclasses.replace(dev, kernel_path="lax"), card.resident.host_round(),
                     card.inc.snapshot().num_jobs)
    for k in ("assigned_node", "scheduled_mask", "preempted_mask", "num_loops"):
        assert np.array_equal(lax[k], card.out[k]), k
    card.inc.set_round_params()
    assert card.resident.device_round(card.inc) is dev
    assert card.resident.last_sync["mode"] == "delta"


@pytest.mark.cuda
def test_service_cycles_on_card_cuda_equal_lax(cuda_device):
    """A small scheduler service on the card (workload.ServiceRun: 3,000
    queued jobs through the submit service, two fake executors of 300
    nodes), 3 cycles on the "cuda" path and 3 on "lax": equal leases and
    preemptions cycle by cycle, a ladder of the configured path alone (no
    "lax" or host rung below it on the card), every round on it,
    resident with a delta sync from the second cycle on, no drift, and
    both fill kernels launched by the "cuda" service only."""
    from armada_tpu_torch.workload import ServiceRun, submit_events

    tk.build_all()
    cfg, entries, _ = submit_events(3000)
    hist = {}
    for path in ("cuda", "lax"):
        tk.reset_launches()
        run = ServiceRun(cfg, entries, 600, kernel_path=path)
        recs = [run.cycle() for _ in range(3)]
        launches = dict(tk.LAUNCHES)
        hist[path] = [(r["leases"], r["preempted"]) for r in recs]
        first = "local:cuda" if path == "cuda" else "LOCAL"
        assert [r.label for r in run.sched._rungs] == [first]
        for i, r in enumerate(recs):
            st = r["stats"]
            assert st["rung"] == first and st["failover"] is None, (path, i)
            assert r["leases"], (path, i)
            if i:
                assert (st["snapshot_mode"], st["sync"]["mode"]) == ("resident", "delta"), (path, i)
        assert not run.sched.recent_failovers and not run.sched.recent_rejections
        assert run.sched._resident["default"].check_drift() == []
        fills = (launches["score_nodes"], launches["fill_take"])
        assert all(fills) if path == "cuda" else not any(launches.values()), (path, launches)
    assert hist["cuda"] == hist["lax"]


@pytest.mark.cuda
def test_lookout_views_follow_a_kernel_service_on_card(cuda_device, tmp_path):
    """Lookout beside a kernel service on the card (workload.ServiceRun:
    3,000 queued jobs, two fake executors of 300 nodes, "cuda"): an
    in-memory and a SQLite Lookout store follow its log, synced after
    each of 3 cycles; their rows are equal, their per-queue counts by
    state are the job database's, a query API answers alike over both,
    and score_nodes, fill_take and segment_add were launched."""
    from armada_tpu_torch.services.lookout_ingester import LookoutStore
    from armada_tpu_torch.services.lookout_sqlite import SqliteLookoutStore
    from armada_tpu_torch.services.queryapi import JobFilter, Order, QueryApi
    from armada_tpu_torch.workload import ServiceRun, submit_events

    tk.build_all()
    cfg, entries, _ = submit_events(3000)
    tk.reset_launches()
    run = ServiceRun(cfg, entries, 600, kernel_path="cuda")
    log = run.sched.log
    stores = [LookoutStore(log), SqliteLookoutStore(log, str(tmp_path / "lookout.db"))]
    for _ in range(3):
        rec = run.cycle()
        assert rec["leases"] and rec["stats"]["rung"] == "local:cuda"
        for store in stores:
            store.sync()
        rows = [{r.job_id: r for r in s.all_rows()} for s in stores]
        assert rows[0] == rows[1] and len(rows[0]) == 3000
        counts = {}
        for j in run.sched.jobdb.read_txn().all_jobs():
            counts[j.queue, j.state.value] = counts.get((j.queue, j.state.value), 0) + 1
        got = {}
        for r in rows[0].values():
            got[r.queue, r.state] = got.get((r.queue, r.state), 0) + 1
        assert got == counts
        pages = [QueryApi(lookout=s).get_jobs([JobFilter("state", "leased")],
                                              Order("job_id", "asc"), 0, 50) for s in stores]
        assert pages[0] == pages[1] and pages[0][1] > 0
    stores[1].close()
    for name in ("score_nodes", "fill_take", "segment_add"):
        assert tk.LAUNCHES[name] > 0, name


@pytest.mark.cuda
def test_agent_leases_from_a_kernel_stack_on_card(cuda_device):
    """A kernel-backed stack on the card as chip_smoke.py's phase 17 wires
    it (`WireStack`, "cuda"): 600 queued jobs of workload.build_inputs
    submitted by REST through the ChaosProxy, one executor agent of 100
    nodes leasing through the loopback (the method table over the JSON
    codec). The cycle after the agent's first exchange leases every job
    on local:cuda; after the next exchange every lease is a pod on the
    agent and every pod a lease, and the pods' reported states are the
    job database's after the cycle that follows. score_nodes, fill_take
    and segment_add were launched."""
    import importlib.util
    import os

    from armada_tpu_torch.services.chaos import FaultPlan, VirtualClock
    from armada_tpu_torch.workload import build_inputs

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tk.build_all()
    cfg, _, _, queues, _, queued = build_inputs(600, 1, n_running=0, fast_fill=True,
                                                fill_window=2048)
    stack = smoke.WireStack(cfg, "cuda", VirtualClock(), FaultPlan([]), 1, 100)
    agent = stack.agents[0]
    try:
        assert [r.label for r in stack.sched._rungs] == ["local:cuda"]
        for q in queues:
            smoke._rest(stack.base, "/api/v1/queue", {"name": q.name})
            jobs = [smoke.job_spec_to_dict(j) for j in queued if j.queue == q.name]
            if jobs:
                smoke._rest(stack.base, "/api/v1/job/submit",
                            {"queue": q.name, "jobset": "bench", "jobs": jobs})
        agent.tick(0.0)
        tk.reset_launches()
        seqs = stack.sched.cycle(now=0.0)
        launches = dict(tk.LAUNCHES)
        leased = {e.job_id for seq in seqs for e in seq.events if type(e).__name__ == "JobRunLeased"}
        assert len(leased) == 600 and stack.sched.last_cycle_stats["rung"] == "local:cuda"
        reply = agent.tick(10.0)
        assert {x["job_id"] for x in reply["leases"]} == leased
        smoke._check_pods(stack, "on the card")
        assert {p["job_id"] for p in agent.runtime.pods.values()} == leased
        stack.sched.cycle(now=10.0)
        smoke._check_phases(stack, "on the card", None)
    finally:
        stack.close()
    for name in smoke.FILL_KERNELS:
        assert launches[name] > 0, name


@pytest.mark.cuda
def test_recorded_rounds_replay_on_card(cuda_device, tmp_path):
    """The round observatory on the card: the committed bundle the JAX
    package recorded replays under LOCAL (the "cuda" path), "lax" and
    hotwindow:64 (on "cuda") with zero divergences, both fill kernels
    launched by LOCAL and by hotwindow:64 and none by "lax"; a
    small "cuda" service records every round with no kernel library
    built or loaded after its first cycle, and its bundle replays on the
    card and on the CPU with zero divergences."""
    import os

    from armada_tpu_torch.trace import TraceRecorder, load_trace, replay_trace
    from armada_tpu_torch.workload import ServiceRun, submit_events

    tk.build_all()
    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "sim_steady.atrace")
    for solver in ("LOCAL", "lax", "hotwindow:64"):
        tk.reset_launches()
        report = replay_trace(load_trace(fixture), solvers=(solver,), allow_foreign=True)
        assert report["ok"] and report["rounds"] == 6, (solver, report["divergences"])
        fills = (tk.LAUNCHES["score_nodes"], tk.LAUNCHES["fill_take"])
        assert all(fills) if solver != "lax" else not any(fills), (solver, fills)
    cfg, entries, _ = submit_events(3000)
    run = ServiceRun(cfg, entries, 600, kernel_path="cuda")
    path = str(tmp_path / "service.atrace")
    run.sched.attach_trace_recorder(TraceRecorder(path, config=run.sched.config))
    recs = [run.cycle() for _ in range(3)]
    run.sched.trace_recorder.close()
    for r in recs[1:]:
        assert not r["stats"]["compiles"]["compiles"] and not r["stats"]["compiles"]["traces"]
    trace = load_trace(path)
    assert len(trace.rounds) == 3
    for device in (None, "cpu"):
        report = replay_trace(trace, solvers=("LOCAL", "lax"), device=device)
        assert report["ok"] and report["rounds"] == 3, (device, report["divergences"])


@pytest.mark.cuda
def test_fixed_sum_on_card_equals_cpu(cuda_device):
    """ROADMAP C4: the water-fill's sums (`_fixed_sum`, elementwise adds
    in one pairwise order) give the same bits on the card as on the CPU,
    along either axis, for Q from 1 to 64."""
    from armada_tpu_torch.solver.kernel import _fixed_sum

    for q in range(1, 65):
        rng = np.random.default_rng(q)
        x = torch.as_tensor(rng.random((q, 3)) * 10.0 ** rng.integers(-6, 3, size=(q, 3)))
        for dim in (0, 1):
            card = _fixed_sum(x.to(cuda_device), dim).cpu().numpy()
            assert card.tobytes() == _fixed_sum(x, dim).numpy().tobytes(), (q, dim)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    a = _port_args(_score_inputs(np.random.default_rng(13), 256), device="cuda")
    with pytest.raises(TypeError):
        tk.score_nodes(**{**a, "alloc0": a["alloc0"].to(torch.int64)})
    with pytest.raises(ValueError):
        tk.score_nodes(**{**a, "node_total": a["node_total"].t().contiguous().t()})
    with pytest.raises(ValueError):
        tk.score_nodes(**{**a, "req_fit": a["req_fit"][:2]})
    a = _score_inputs(np.random.default_rng(13), 256)
    p, plan, _ = _score_plan_on(a, "cuda")
    with pytest.raises(TypeError):
        plan.score(p["alloc0"].to(torch.int64), 0)
    with pytest.raises(ValueError):
        plan.score(p["alloc0"][:128].contiguous(), 0)
    with pytest.raises(ValueError):
        plan.score(p["alloc0"].cpu(), 0)
    with pytest.raises(IndexError):
        plan.score(p["alloc0"], 3)
    with pytest.raises(ValueError):
        tk.ScorePlan(
            plan.node_total, plan.taints, plan.labels, plan.rank, plan.gid, plan.unsched,
            plan.tolerated, plan.selector, plan.req_fit, plan.excl, plan.aff_group[:2],
            plan.possible, plan.affinity, plan.order_res_idx, plan.order_res_resolution,
            plan.bits, plan.batch_window,
        )
    key = torch.arange(4096, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        tk.fill_take(key, 0)
    with pytest.raises(TypeError):
        tk.fill_take(key.to(torch.int32), 16)
    with pytest.raises(ValueError):
        tk.fill_take(key[::2], 16)
    # A cluster shape or shared-memory request the card cannot run raises
    # rather than launching.
    for cfg in (
        tk.FillTakeConfig(16, 8192, 71688, True),
        tk.FillTakeConfig(8, 30000, 300000, True),
    ):
        with pytest.raises(RuntimeError):
            tk._fill_take_fits(cuda_device, cfg)


@pytest.mark.cuda
def test_segment_add_matches_plain_on_card(cuda_device):
    """segment_add and segment_sum against index_add on the card under
    every strategy segment_plan accepts (forced through its plan) and the
    one it picks: int32 and int64, along dim 0 and 1, values at the types'
    extremes (the sums wrap), many values into few segments, sorted
    indices, one index, empty index lists, indices out of range (they add
    nothing); one launch per non-empty call, none for an empty one."""
    rng = np.random.default_rng(31)
    cases = (
        (1, 5, ()), (7, 0, (3,)), (40, 200, (2, 3)), (10, 20480, ()), (8192, 1, (4,)),
        (8192, 131072, (4,)), (16, 100000, (4,)), (64, 131072, (4,)), (8192, 2048, (4,)),
        (3, 70000, (5,)),
    )

    def plans(outer, n, k, inner, eb):
        forced = [tk.segment_plan(outer, n, k, inner, eb, strategy=s)
                  for s in tk.segment_strategies(outer, n, k, inner, eb)]
        return [None] + forced

    for dtype in (torch.int32, torch.int64):
        info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
        eb = 4 if dtype == torch.int32 else 8
        for n, k, rest in cases:
            idx_np = rng.integers(0, n, size=k)
            if n in (16, 64):
                idx_np = np.sort(idx_np)  # the round's class and queue sums
            idx = torch.as_tensor(idx_np, device=cuda_device)
            vals = torch.as_tensor(rng.integers(info.min, info.max, size=(k,) + rest,
                                                dtype=np.int64), device=cuda_device).to(dtype)
            vals[rng.random(k) < 0.5] = 0
            x = torch.as_tensor(rng.integers(info.min, info.max, size=(n,) + rest,
                                             dtype=np.int64), device=cuda_device).to(dtype)
            inner = int(np.prod(rest, dtype=np.int64))
            want_add = tk.segment_add_plain(x, 0, idx, vals)
            want_sum = tk.segment_sum_plain(vals, idx, n)
            for plan in plans(1, n, k, inner, eb):
                tk.reset_launches()
                got = tk.segment_add(x, 0, idx, vals, plan=plan)
                assert tk.LAUNCHES["segment_add"] == (1 if k and inner else 0)
                assert torch.equal(got, want_add), (dtype, n, k, rest, plan)
                tk.reset_launches()
                got = tk.segment_sum(vals, idx, n, plan=plan)
                assert tk.LAUNCHES["segment_add"] == (1 if k and inner else 0)
                assert torch.equal(got, want_sum), (dtype, n, k, rest, plan)
            if rest:
                xt, vt = x.movedim(0, 1).contiguous(), vals.movedim(0, 1).contiguous()
                want = tk.segment_add_plain(xt, 1, idx, vt)
                for plan in plans(rest[0], n, k, inner // rest[0], eb):
                    assert torch.equal(tk.segment_add(xt, 1, idx, vt, plan=plan), want), (
                        dtype, n, k, rest, plan)
            if k:
                # Out-of-range indices add nothing (index_add would raise).
                bad = idx.clone()
                bad[::3] = -1
                bad[1::3] = n
                keep = (bad >= 0) & (bad < n)
                masked = torch.where(keep.reshape((k,) + (1,) * len(rest)), vals, 0)
                want = tk.segment_sum_plain(masked, torch.clamp(bad, 0, n - 1), n)
                for plan in plans(1, n, k, inner, eb):
                    assert torch.equal(tk.segment_sum(vals, bad, n, plan=plan), want), (
                        dtype, n, k, rest, plan)
    x = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    idx = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        tk.segment_add(x.float(), 0, idx, torch.ones(3, device=cuda_device))
    with pytest.raises(TypeError):
        tk.segment_add(x, 0, idx, torch.ones(3, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):
        tk.segment_add(x, 0, idx, torch.ones(4, dtype=torch.int32, device=cuda_device))
    ones = torch.ones(3, dtype=torch.int32, device=cuda_device)
    # A strategy that does not take the sum, and plans the C entry refuses
    # (an empty grid), raise.
    with pytest.raises(ValueError):
        tk.segment_sum(ones, idx, 2**20, plan=tk.SegmentPlan("shared", 1, False))
    for strategy in tk.SEGMENT_STRATEGIES:
        with pytest.raises(RuntimeError):
            tk.segment_sum(ones, idx, 8, plan=tk.SegmentPlan(strategy, 0, False))


@pytest.mark.cuda
def test_winner_reduce_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(21)
    for p in (1, 2, 3, 8, 32, 33, 1024):
        # Widths 3 to 16: 4-byte, 8-byte and 16-byte row loads.
        for n_keys in (1, 2, 3, 4, 5, 6, 7, 14):
            for share in (0.0, 0.5):
                keys, found, gids = _winner_inputs(rng, p, 3, share)
                keys = (keys * 5)[:n_keys - 1] + [keys[-1]]
                padded = tk.winner_rows(
                    [torch.as_tensor(k, device=cuda_device) for k in keys],
                    torch.as_tensor(found, device=cuda_device),
                    torch.as_tensor(gids, device=cuda_device),
                )
                # P rows as the sharded select gathers them, and the
                # reference's rows padded to a power of two.
                for rows in (padded[:p], padded):
                    got = tk.winner_reduce_rows(rows)
                    want = tk.winner_reduce_plain(rows)
                    row, gid, got_found = tk.winner_reduce_rows(rows, pick=True)
                    want_gid, want_found = tk.winner_pick_plain(want)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (p, n_keys, share)
                    assert torch.equal(row, want), (p, n_keys, share)
                    assert gid.dtype == torch.int32 and got_found.dtype == torch.bool
                    assert torch.equal(gid, want_gid) and torch.equal(got_found, want_found)
    with pytest.raises(TypeError):
        tk.winner_reduce_rows(rows.to(torch.int64))
    with pytest.raises(ValueError):
        tk.winner_reduce_rows(torch.zeros((1025, 3), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        tk.winner_reduce_rows(torch.zeros((2, tk.WINNER_MAX_WIDTH + 1), dtype=torch.int32, device=cuda_device))


@pytest.mark.cuda
def test_sharded_round_on_card_equals_cpu(cuda_device):
    """A 2x2 sharded round with its shards on the cards (cuda:k % count)
    solves to the same arrays as on the CPU, through all three kernels."""
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.parallel.mesh import pad_nodes
    from armada_tpu_torch.parallel.multihost import resolve_solver
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import build_inputs

    dev = pad_nodes(pad_device_round(prep_device_round(build_round_snapshot(
        *build_inputs(600, 24, n_running=60)
    ))), 4)
    count = torch.cuda.device_count()
    on_card = resolve_solver("2x2", "cuda", devices=[f"cuda:{k % count}" for k in range(4)])
    K.reset_launches()
    got = on_card(dev)
    assert all(K.LAUNCHES[name] > 0 for name in ROUND_KERNELS), K.LAUNCHES
    # Both stages of every select: two launches per select per shard.
    assert K.LAUNCHES["winner_reduce"] == 2 * on_card.last_stats.selects * 4
    want = resolve_solver("2x2", "cuda", devices=["cpu"] * 4)(dev)
    for k in want:
        assert np.array_equal(got[k], want[k], equal_nan=True), k


def _card_devices(n):
    count = torch.cuda.device_count()
    return [f"cuda:{k % count}" for k in range(n)]


@pytest.mark.cuda
def test_ring_exchange_matches_plain_on_card(cuda_device, tmp_path):
    """The ring kernel in two and in four gloo processes on the cards
    (several may share one): every call equals the plain version's row,
    over a 2- and a 4-member chip axis and a 1-member host axis."""
    from armada_tpu_torch.parallel.launcher import launch

    tk.build_all()
    for n in (2, 4):
        res = launch(None, 1, n, devices=_card_devices(n), backend="gloo", timeout_s=300.0,
                     out_dir=tmp_path, ring_calls=5)
        assert res["ok"], res.get("tails")
        for report in res["workers"]:
            assert report["ring"]["chips"]["n"] == n
            assert report["ring"]["chips"]["mismatches"] == 0
            assert report["ring"]["chips"]["launches"] > 0


@pytest.mark.cuda
def test_multiprocess_round_on_card_equals_cpu(cuda_device, tmp_path):
    """A 2x2 round in four processes on the cards solves to the same arrays
    as the in-process group on the CPU, through the round's kernels."""
    from armada_tpu_torch.parallel.launcher import launch, save_round
    from armada_tpu_torch.parallel.mesh import pad_nodes
    from armada_tpu_torch.parallel.multihost import resolve_solver
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import build_inputs

    tk.build_all()
    dev = pad_nodes(pad_device_round(prep_device_round(build_round_snapshot(
        *build_inputs(600, 24, n_running=60, gang_every=8)
    ))), 4)
    res = launch(save_round(dev, tmp_path / "round.npz"), 2, 2, devices=_card_devices(4),
                 backend="gloo", kernel_path="cuda", timeout_s=300.0, out_dir=tmp_path)
    assert res["ok"], res.get("tails") or res.get("mismatch")
    assert all(res["launches"][name] > 0 for name in ROUND_KERNELS), res["launches"]
    assert res["launches"]["winner_reduce"] == 2 * res["collectives"]["selects"] * 4
    inproc = resolve_solver("2x2", "cuda", devices=["cpu"] * 4)
    want = inproc(dev)
    for k in want:
        assert np.array_equal(res["outputs"][k], want[k], equal_nan=True), k
    assert res["collectives"] == inproc.last_stats.as_dict()


@pytest.mark.cuda
def test_two_threads_solving_at_once_equal_a_lone_solve(cuda_device):
    """ROADMAP C2 on the card: two threads solve the same round at once
    (as a what-if rollout beside the live round does), each on its own
    stream of the card, and both outputs equal a lone solve's, with the
    deterministic switch on throughout (ops/segment.py never turns it
    off)."""
    import threading

    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import build_inputs

    dev = pad_device_round(prep_device_round(build_round_snapshot(
        *build_inputs(4000, 200, n_running=400, fast_fill=True))))
    lone = solve_round(dev)
    outs, errors = [None, None], []

    def solve(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                outs[i] = solve_round(dev)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=solve, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert torch.are_deterministic_algorithms_enabled()
    for out in outs:
        for k in lone:
            assert np.array_equal(out[k], lone[k], equal_nan=True), k
