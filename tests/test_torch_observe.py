"""Port copy of tests/test_observe.py: the round observatory
(armada_tpu_torch/observe): transfer-ledger accounting, the compile
telemetry of the port's kernel libraries (observe/compiles.py), and the
structured-log trace-id join, on the CPU.

The ledger asserts EXACTLY on a tiny round with known array shapes under
the fused LOCAL solve, the hot-window compacted driver (donated buffers
booked) and the 2x2 mesh of shard threads. Where the JAX package counts
XLA traces and compiles, the port counts nvcc builds and library loads:
warm cycles report zero after the first solve, a replay flags a build on
an already-replayed round shape as a `retrace` divergence, a build
through a stub `nvcc` (CUDA_HOME pointed at a script that writes its
output file) counts one compile and one cache miss, and the thread-scoped
bracket sees a build that a shard thread makes for the round, not one
that another thread makes.
"""

import dataclasses
import json
import logging
import stat
import threading

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401

from armada_tpu_torch.core.config import PriorityClass, SchedulingConfig
from armada_tpu_torch.core.types import JobSpec, NodeSpec, QueueSpec, RunningJob
from armada_tpu_torch.observe.compiles import TELEMETRY
from armada_tpu_torch.observe.ledger import note_down, note_up, round_ledger, tree_transfer_size
from armada_tpu_torch.ops import kernels
from armada_tpu_torch.snapshot.round import build_round_snapshot
from armada_tpu_torch.solver.kernel import solve_round
from armada_tpu_torch.solver.kernel_prep import DeviceRound, pad_device_round, prep_device_round


def _tiny_round(n_jobs=120, n_running=12, bw=4):
    """A small mixed round (hog queue over fair share, a few running
    jobs) big enough that window=4 compaction engages at
    window_min_slots=0."""
    cfg = SchedulingConfig(
        priority_classes={
            "high": PriorityClass("high", 30000, preemptible=False),
            "low": PriorityClass("low", 1000, preemptible=True),
        },
        default_priority_class="low",
        protected_fraction_of_fair_share=0.5,
        batch_fill_window=bw,
    )
    nodes = [
        NodeSpec(id=f"n{i:03d}", pool="default", total_resources={"cpu": "16", "memory": "64Gi"})
        for i in range(10)
    ]
    queues = [QueueSpec(f"q{i}", 1.0) for i in range(3)]
    rng = np.random.default_rng(7)
    queued = [
        JobSpec(id=f"j{i:04d}", queue=f"q{i % 3}", priority_class="low",
                requests={"cpu": str(int(rng.choice([1, 2])))}, submitted_ts=float(i))
        for i in range(n_jobs)
    ]
    running = [
        RunningJob(
            job=JobSpec(id=f"r{i:04d}", queue="q0", priority_class="low",
                        requests={"cpu": "2"}, submitted_ts=float(-n_running + i)),
            node_id=f"n{i % 10:03d}",
            scheduled_at_priority=1000,
        )
        for i in range(n_running)
    ]
    snap = build_round_snapshot(cfg, "default", nodes, queues, running, queued)
    return pad_device_round(prep_device_round(snap))


def _host_bytes(dev) -> tuple[int, int]:
    nbytes = arrays = 0
    for f in dataclasses.fields(DeviceRound):
        v = getattr(dev, f.name)
        if isinstance(v, np.ndarray):
            nbytes += v.nbytes
            arrays += 1
    return nbytes, arrays


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """CUDA_HOME with a bin/nvcc that writes its `-o` file, and the
    kernel libraries built into a fresh directory; the loaded-library
    cache emptied for the test."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then echo stub > "$2"; fi\n'
        "  shift\n"
        "done\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_libs", {})
    return tmp_path / "build"


def _build(name="fill_take"):
    kernels._finish_build(name, kernels._start_build(name))


# ---------------------------------------------------------------------------
# Ledger unit behavior


def test_ledger_nesting_and_host_only_filter():
    """Notes book into EVERY active ledger on the stack; note_up counts
    only the leaves not already on the solve's device."""
    host = np.zeros(10, np.int64)  # 80 bytes
    on_device = torch.zeros(4, dtype=torch.int32)  # already on the CPU solve's device
    with round_ledger() as outer:
        with round_ledger() as inner:
            note_up({"h": host, "d": on_device}, device="cpu")
            note_down([np.zeros(3, np.float64)])  # 24 bytes
        note_up(host, device="cpu")
    assert inner.bytes_up == 80 and inner.arrays_up == 1
    assert inner.bytes_down == 24 and inner.arrays_down == 1
    assert outer.bytes_up == 160 and outer.arrays_up == 2
    note_up(host)  # outside any ledger: a no-op
    assert outer.bytes_up == 160


def test_tree_transfer_size_matches_numpy_nbytes():
    dev = _tiny_round(n_jobs=24, n_running=0)
    assert tree_transfer_size(dev, host_only=True) == _host_bytes(dev)


# ---------------------------------------------------------------------------
# Exact accounting through the solvers


def test_transfer_ledger_exact_local():
    """Fused LOCAL solve: bytes_up is exactly the host DeviceRound,
    bytes_down exactly the materialized output dict; nothing donated."""
    dev = _tiny_round()
    expected_up, expected_arrays = _host_bytes(dev)
    with round_ledger() as led:
        out = solve_round(dev, device="cpu")
    assert led.bytes_up == expected_up and led.arrays_up == expected_arrays
    arrays = [v for v in out.values() if isinstance(v, np.ndarray)]
    assert led.bytes_down == sum(v.nbytes for v in arrays)
    assert led.arrays_down == len(arrays)
    assert led.donated_buffers == 0 and led.donated_bytes == 0


def test_transfer_ledger_exact_hotwindow_with_donations():
    """Host-driven compacted solve: the same exact bytes_up, the
    scatter-back booked on the donated side, and profile['transfer']
    carrying the solve's own complete view."""
    dev = _tiny_round()
    expected_up, expected_arrays = _host_bytes(dev)
    with round_ledger() as led:
        out = solve_round(dev, window=4, window_min_slots=0, device="cpu")
    assert out["profile"]["compacted"] is True
    assert led.bytes_up == expected_up and led.arrays_up == expected_arrays
    assert led.donated_buffers > 0 and led.donated_bytes > 0
    transfer = out["profile"]["transfer"]
    assert transfer["bytes_up"] == expected_up
    assert transfer["donated_buffers"] == led.donated_buffers
    assert transfer["bytes_down"] == led.bytes_down > 0


def test_transfer_ledger_exact_mesh_2x2():
    """The 2x2 mesh of shard threads books exactly the padded host tree
    as its placement upload, on the calling thread's ledger."""
    from armada_tpu_torch.parallel.mesh import pad_nodes
    from armada_tpu_torch.parallel.multihost import resolve_solver

    run = resolve_solver("2x2", devices=["cpu"] * 4)
    dev = pad_nodes(_tiny_round(), run.n_shards)
    expected_up, expected_arrays = _host_bytes(dev)
    with round_ledger() as led:
        run(dev)
    assert led.bytes_up == expected_up and led.arrays_up == expected_arrays


# ---------------------------------------------------------------------------
# Compile telemetry


def test_warm_cycle_zero_builds_after_first_solve():
    """After the first solve of a padded shape, re-solving it builds and
    loads nothing, under the fused and the compacted drivers; the delta
    carries every key the JAX package's does, and alloc_segments."""
    dev = _tiny_round()
    for kwargs in ({}, {"window": 4, "window_min_slots": 0}):
        solve_round(dev, device="cpu", **kwargs)
        snap0 = TELEMETRY.snapshot()
        solve_round(dev, device="cpu", **kwargs)
        delta = TELEMETRY.delta_since(snap0)
        assert set(delta) == {"traces", "compiles", "compile_seconds", "cache_hits",
                              "cache_misses", "alloc_segments"}
        assert not any(delta.values()), (kwargs, delta)


def test_replay_flags_warm_shape_rebuild_as_divergence(tmp_path, stub_nvcc):
    """A solver that rebuilds a kernel library on an already-replayed
    round signature classifies as a `retrace` divergence; the plain
    replay of the same bundle is clean."""
    from armada_tpu_torch.trace import TraceRecorder, load_trace, replay_trace
    from armada_tpu_torch.trace import replayer as replayer_mod

    dev = _tiny_round(n_jobs=24, n_running=0)
    out = solve_round(dev, device="cpu")
    path = str(tmp_path / "warm.atrace")
    with TraceRecorder(path, source="test") as rec:
        for _ in range(2):  # two rounds, identical shape signature
            rec.record_round(
                pool="default", dev=dev,
                decisions={k: np.asarray(v) for k, v in out.items() if k != "profile"},
                num_jobs=24, num_queues=3,
            )
    trace = load_trace(path)
    clean = replay_trace(trace, solvers=("LOCAL",), device="cpu")
    assert clean["ok"], clean
    orig = replayer_mod.replay_solver

    def cold_solver(spec, header=None, *, device=None):
        label, solve = orig(spec, header, device=device)

        def cold(dev_):
            for lib in stub_nvcc.glob("*.so"):
                lib.unlink()
            _build()
            return solve(dev_)

        return label, cold

    replayer_mod.replay_solver = cold_solver
    try:
        report = replay_trace(trace, solvers=("LOCAL",), device="cpu")
    finally:
        replayer_mod.replay_solver = orig
    assert report["divergences"] == {"retrace": 1}, report


def test_stub_nvcc_build_counts_one_compile(stub_nvcc):
    """A kernel library built through nvcc counts one compile and one
    cache miss with its seconds; found built, it counts one hit and no
    compile."""
    snap0 = TELEMETRY.thread_snapshot()
    _build()
    delta = TELEMETRY.delta_since(snap0, thread=True)
    assert (delta["compiles"], delta["cache_misses"], delta["cache_hits"]) == (1, 1, 0)
    assert delta["compile_seconds"] >= 0.0 and delta["traces"] == 0
    assert list(stub_nvcc.glob("libfill_take-*.so"))
    snap1 = TELEMETRY.thread_snapshot()
    _build()
    delta = TELEMETRY.delta_since(snap1, thread=True)
    assert (delta["compiles"], delta["cache_misses"], delta["cache_hits"]) == (0, 0, 1)


def test_bracket_sees_shard_thread_builds_not_other_threads(stub_nvcc):
    """The round's thread-scoped bracket counts a build that a shard
    thread of its shard group makes (parallel/comm.py adopts the round
    thread's scope), and not one that an unrelated thread makes."""
    from armada_tpu_torch.parallel.comm import ShardGroup

    snap0 = TELEMETRY.thread_snapshot()
    group = ShardGroup(("chips",), (2,), ["cpu", "cpu"])
    group.run(lambda shard: _build("score_nodes") if shard.index == 1 else None)
    delta = TELEMETRY.delta_since(snap0, thread=True)
    assert (delta["compiles"], delta["cache_misses"]) == (1, 1)

    snap1 = TELEMETRY.thread_snapshot()
    other = threading.Thread(target=_build, args=("winner_reduce",))
    other.start()
    other.join()
    assert TELEMETRY.delta_since(snap1, thread=True)["compiles"] == 0
    assert TELEMETRY.delta_since(snap0)["compiles"] >= 2  # process-wide


# ---------------------------------------------------------------------------
# Structured logging joins the trace


def test_scheduler_cycle_log_line_carries_round_trace_id():
    """A scheduling-round log record rendered by the JSON formatter
    carries the SAME trace id as the round span open around it."""
    from armada_tpu_torch.events import InMemoryEventLog
    from armada_tpu_torch.services.fake_executor import FakeExecutor, make_nodes
    from armada_tpu_torch.services.scheduler import SchedulerService
    from armada_tpu_torch.services.submit import SubmitService
    from armada_tpu_torch.utils.logging import _JsonFormatter
    from armada_tpu_torch.utils.tracing import Tracer

    log = InMemoryEventLog()
    sched = SchedulerService(SchedulingConfig(), log, device="cpu")
    tracer = Tracer()
    sched.attach_tracer(tracer)
    submit = SubmitService(SchedulingConfig(), log, scheduler=sched)
    submit.create_queue(QueueSpec("q"))
    ex = FakeExecutor("ex", log, sched, nodes=make_nodes("ex", count=2, cpu="8"),
                      runtime_for=lambda jid: 60.0)
    submit.submit("q", "s", [
        JobSpec(id="obs-1", queue="q", requests={"cpu": "1", "memory": "1Gi"}, submitted_ts=0.0),
    ], now=0.0)
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(_JsonFormatter().format(record))
    logger = logging.getLogger("armada_tpu_torch.scheduler")
    logger.addHandler(handler)
    try:
        ex.tick(0.0)
        sched.cycle(now=0.0)
    finally:
        logger.removeHandler(handler)
    round_spans = [s for s in tracer.finished if s.name == "scheduler.round"]
    assert round_spans, "no round span recorded"
    docs = [json.loads(r) for r in records]
    round_lines = [d for d in docs if "scheduling round complete" in d.get("msg", "")]
    assert round_lines, docs
    assert round_lines[0]["trace_id"] == round_spans[0].trace_id
    assert round_lines[0]["pool"] == "default"
    assert round_lines[0]["level"] == "INFO"
    # The round's compile delta rides on the round span and in the stats.
    assert round_spans[0].attrs["xla_compiles"] == 0
    assert sched.last_cycle_stats["compiles"]["compiles"] == 0
