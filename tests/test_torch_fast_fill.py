"""Fast fill (the merged multi-queue window fill and the evicted-rebind
window): the port's solve_round against the JAX package's, on the CPU.

The rounds are port copies of tests/test_fill.py's: the random sweeps
(seeds 0 to 5 queued-only with gangs, 6 to 9 with running jobs) in
tests/test_torch_fast_fill_random.py, the directed cases here, and every
round of tests/torch_scenarios.py with fast fill on in
tests/test_torch_fast_fill_scenarios.py. Each padded round goes through
the reference's `solve_round` with `fast_fill=True` on its "lax" path
and through the port's on both of its paths ("cuda": the kernels' plain
versions on the CPU; "lax").
The decisions, num_loops and spot_price are bit-exact, the fair shares
within 4/16 ULP (`_assert_same`), the port's round firewall gives the
reference's verdict, and the port's fast fill merged where the
reference's does (`merged_fill_loops` > 0).

Also here: the flagship's fast-fill round built by replacing the window
of a prepared round (`workload.refill`), which must equal a fresh prep;
the port's home/away scenario against the reference's; and that a merged
step never updates the carry it may roll back to. The window-4,096 round
of the C1 repair is in tests/test_torch_fill_window.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401
import torch

from armada_tpu.core.config import PriorityClass, SchedulingConfig
from armada_tpu.core.types import JobSpec, NodeSpec, QueueSpec, RunningJob
from armada_tpu.snapshot.round import build_round_snapshot
from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver.kernel_prep import pad_device_round, prep_device_round
from armada_tpu.solver.validate import validate_round as ref_validate
from armada_tpu_torch.solver import kernel as port_kernel
from armada_tpu_torch.solver.kernel_prep import from_reference_round
from armada_tpu_torch.solver.validate import validate_round
from test_kernel_parity import PREEMPT_CFG
from test_torch_round import _assert_same


def fast_round(cfg, nodes, queues, running, queued, **replace):
    """The reference's padded round with fast fill on."""
    snap = build_round_snapshot(cfg, "default", nodes, queues, running, queued)
    dev = pad_device_round(prep_device_round(snap))
    return dataclasses.replace(dev, fast_fill=True, **replace)


def check_fast_fill(name, dev, *, merges=True):
    """Hold both port paths to the reference's "lax" path on the
    fast-fill round `dev`; returns the port's outputs and loop stats by
    path. The reference's fused "pallas" path is not solved here: its
    parity with its own "lax" path is the JAX package's to hold
    (tests/test_pallas_parity.py), and the one round where the two
    differ (ROADMAP C, the reference's top-B drops nodes) is
    tests/test_torch_round.py's."""
    want = ref_kernel.solve_round(dataclasses.replace(dev, kernel_path="lax"))
    got = {}
    for port_path in ("lax", "cuda"):
        port_dev = dataclasses.replace(
            from_reference_round(dataclasses.asdict(dataclasses.replace(dev, kernel_path="lax"))),
            kernel_path=port_path,
        )
        assert port_dev.fast_fill
        stats = {}
        out = port_kernel.solve_round(port_dev, device="cpu", stats=stats)
        _assert_same(f"{name}/{port_path}", out, want)
        # The round firewall gives the reference's verdict on its own
        # output: random rounds with gangs of mixed priority classes can
        # over-commit a node for one round (docs/parity.md), in the serial
        # loop as in fast fill, and then both firewalls refuse the round.
        verdict = ref_validate(want, dev=dataclasses.replace(dev, kernel_path="lax"))
        assert _verdict(validate_round(out, dev=port_dev)) == _verdict(verdict), name
        assert stats["fill_loops"] == 0, name
        if merges:
            assert stats["merged_fill_loops"] > 0, name
        got[port_path] = (out, stats)
    return got


def _verdict(v):
    return None if v is None else (v.invariant, v.detail)


def _nodes(n, cpu="32", mem="256Gi", width=3):
    return [
        NodeSpec(id=f"n{i:0{width}d}", pool="default", total_resources={"cpu": cpu, "memory": mem})
        for i in range(n)
    ]


def _jobs(n, queue, cpu, mem, prefix="j", ts0=0.0):
    return [
        JobSpec(id=f"{prefix}{i:05d}", queue=queue(i), requests={"cpu": cpu(i), "memory": mem(i)},
                submitted_ts=ts0 + float(i))
        for i in range(n)
    ]


def _collapses_loops():
    queued = _jobs(400, lambda i: f"q{i % 4}", lambda i: "1", lambda i: "1Gi")
    return SchedulingConfig(), _nodes(20), [QueueSpec(f"q{i}", 1.0) for i in range(4)], [], queued


def _burst_caps():
    cfg = SchedulingConfig()
    cfg = dataclasses.replace(
        cfg, rate_limits=dataclasses.replace(cfg.rate_limits, maximum_scheduling_burst=37)
    )
    queued = _jobs(120, lambda i: f"q{i % 3}", lambda i: "1", lambda i: "1Gi")
    return cfg, _nodes(1, "500", "500Gi"), [QueueSpec(f"q{i}") for i in range(3)], [], queued


def _heterogeneous_stream():
    sizes = np.random.default_rng(7).choice([1, 2, 4, 8], size=600)
    queued = _jobs(600, lambda i: f"q{i % 4}", lambda i: str(int(sizes[i])),
                   lambda i: f"{int(sizes[i])}Gi")
    return SchedulingConfig(), _nodes(100), [QueueSpec(f"q{i}", 1.0) for i in range(4)], [], queued


def _group_cap_cut():
    cfg = dataclasses.replace(SchedulingConfig(), fill_group_max=3)
    queued = _jobs(160, lambda i: f"q{i % 2}", lambda i: str(1 + i % 8), lambda i: "1Gi")
    return cfg, _nodes(12, "64", "512Gi"), [QueueSpec("q0", 1.0), QueueSpec("q1", 1.0)], [], queued


def _heterogeneous_queues():
    def shaped(prefix, queue, n, cpu, mem):
        return [
            JobSpec(id=f"{prefix}{i:03d}", queue=queue, requests={"cpu": cpu, "memory": mem},
                    submitted_ts=float(i))
            for i in range(n)
        ]

    queued = (shaped("s", "small", 60, "1", "2Gi") + shaped("b", "big", 30, "8", "16Gi")
              + shaped("m", "mid", 40, "3", "4Gi"))
    queues = [QueueSpec("small", 1.0), QueueSpec("big", 2.0), QueueSpec("mid", 1.0)]
    return SchedulingConfig(), _nodes(8, "64", "512Gi", 2), queues, [], queued


def _hog(n_running, node, cpu="2", mem="4Gi", queue="q0"):
    return [
        RunningJob(
            job=JobSpec(id=f"run-{i:05d}", queue=queue, requests={"cpu": cpu, "memory": mem},
                        submitted_ts=float(-n_running + i)),
            node_id=node(i),
            scheduled_at_priority=1000,
        )
        for i in range(n_running)
    ]


def _evicted_rebinds():
    running = _hog(400, lambda i: f"n{i % 50:03d}")
    queued = _jobs(200, lambda i: f"q{1 + i % 3}", lambda i: str(1 + i % 3), lambda i: "2Gi")
    cfg = dataclasses.replace(PREEMPT_CFG, protected_fraction_of_fair_share=0.5)
    return cfg, _nodes(50), [QueueSpec(f"q{i}", 1.0) for i in range(4)], running, queued


def _evicted_rebind_capacity_cut():
    nodes = [
        NodeSpec(id=f"n{i}", pool="default", total_resources={"cpu": "8", "memory": "32Gi"})
        for i in range(2)
    ]
    running = _hog(8, lambda i: f"n{i % 2}", queue="hog")
    queued = _jobs(4, lambda i: "fresh", lambda i: "4", lambda i: "8Gi")
    cfg = dataclasses.replace(PREEMPT_CFG, protected_fraction_of_fair_share=0.0)
    return cfg, nodes, [QueueSpec("hog", 1.0), QueueSpec("fresh", 1.0)], running, queued


def _lookback():
    cfg = SchedulingConfig(
        priority_classes={"d": PriorityClass("d", 1000, preemptible=True)},
        default_priority_class="d",
        max_queue_lookback=5,
        batch_fill_window=512,
    )
    nodes = [
        NodeSpec(id=f"n{i}", pool="default", total_resources={"cpu": "64", "memory": "256Gi"})
        for i in range(2)
    ]
    queued = [
        JobSpec(id=f"lb-{i}", queue="q", requests={"cpu": "1", "memory": "1Gi"},
                submitted_ts=float(i))
        for i in range(8)
    ]
    return cfg, nodes, [QueueSpec("q")], [], queued


DIRECTED = {
    "collapses_loops": _collapses_loops,
    "burst_caps": _burst_caps,
    "heterogeneous_stream": _heterogeneous_stream,
    "group_cap_cut": _group_cap_cut,
    "heterogeneous_queues": _heterogeneous_queues,
    "evicted_rebinds": _evicted_rebinds,
    "evicted_rebind_capacity_cut": _evicted_rebind_capacity_cut,
    "lookback": _lookback,
}


@pytest.mark.parametrize("name", sorted(DIRECTED))
def test_directed_fast_fill_round_matches_reference(name):
    got = check_fast_fill(name, fast_round(*DIRECTED[name]()))
    out, stats = got["cuda"]
    if name in ("collapses_loops", "heterogeneous_stream"):
        # The point of fast fill: a handful of loops, not one per job.
        assert int(out["num_loops"]) <= 12
    if name == "evicted_rebinds":
        # The pinned returns batch through the evicted-rebind window.
        assert int(out["num_loops"]) < 60 and stats["merged_fill_loops"] > 0


def test_refill_equals_a_fresh_prep():
    """chip_smoke.py solves the flagship with fast fill by refilling phase
    5's prepared round (window 512, fast fill off) to the bench's
    configuration (window 2,048, fast fill on): every field equals a fresh
    prep of the same inputs in that configuration."""
    from armada_tpu_torch.snapshot.round import build_round_snapshot as port_snapshot
    from armada_tpu_torch.solver.kernel_prep import pad_device_round as port_pad
    from armada_tpu_torch.solver.kernel_prep import prep_device_round as port_prep
    from armada_tpu_torch.workload import build_inputs, refill, scheduling_config

    def prepared(**kw):
        return port_pad(port_prep(port_snapshot(*build_inputs(2000, 200, n_running=100, **kw))))

    base = prepared()
    assert (base.batch_window, base.fast_fill) == (512, False)
    bench_cfg = scheduling_config(n_running=100, fast_fill=True, fill_window=2048)
    got = refill(base, bench_cfg)
    fresh = prepared(fast_fill=True, fill_window=2048)
    assert (got.batch_window, got.fast_fill, got.fill_groups) == (2048, True, 8)
    for f in dataclasses.fields(fresh):
        g, w = getattr(got, f.name), getattr(fresh, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name
    with pytest.raises(ValueError):
        refill(base, dataclasses.replace(bench_cfg, batch_fill_window=0))
    # The refilled round solves as the fresh one does.
    a = port_kernel.solve_round(got, device="cpu")
    b = port_kernel.solve_round(fresh, device="cpu")
    for k in b:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_home_away_round_equals_reference():
    """The port's copy of the home/away scenario builds the reference's
    round: after each package's prep and padding, every field equal."""
    from armada_tpu.parallel.scenarios import home_away_round as ref_home_away
    from armada_tpu_torch.parallel.scenarios import home_away_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round as port_pad
    from armada_tpu_torch.solver.kernel_prep import prep_device_round as port_prep

    want = dataclasses.asdict(pad_device_round(prep_device_round(ref_home_away(40, 160))))
    got = port_pad(port_prep(home_away_round(40, 160)))
    assert got.fast_fill and got.has_away
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), want[f.name]
        if f.name == "kernel_path":
            # The port's prep defaults to its "cuda" path, the reference's
            # to its own "lax".
            continue
        if isinstance(g, np.ndarray):
            w = np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True), f.name
        else:
            assert g == w, f.name


@pytest.mark.parametrize("name", ["evicted_rebind_capacity_cut", "eviction_gang"])
def test_merged_step_leaves_its_carry_untouched(monkeypatch, name):
    """The rollback of a merged step is the carry from before it: no apply
    may update a tensor of that carry in place. Every merged step's input
    carry is compared with a copy taken before the step; the rounds roll
    steps back (a shortfall with several active queues) and commit
    others."""
    from torch_scenarios import SCENARIOS

    args = DIRECTED[name]() if name in DIRECTED else SCENARIOS[name]()
    dev = from_reference_round(
        dataclasses.asdict(dataclasses.replace(fast_round(*args), kernel_path="lax"))
    )
    step = port_kernel._merged_fill_step
    committed = []

    def checked(rd, c, *a, **kw):
        before = {f: v.clone() for f, v in c._asdict().items() if isinstance(v, torch.Tensor)}
        out = step(rd, c, *a, **kw)
        for f, v in before.items():
            # bitwise, so that the nan spot price equals itself
            got = getattr(c, f).reshape(-1)
            if v.dtype == torch.float64:
                got, v = got.view(torch.int64), v.reshape(-1).view(torch.int64)
            assert torch.equal(got, v.reshape(-1)), f"{name}: merged step changed carry.{f}"
        committed.append(out[2])
        return out

    monkeypatch.setattr(port_kernel, "_merged_fill_step", checked)
    port_kernel.solve_round(dev, device="cpu")
    assert True in committed and False in committed
