"""Port copy of tests/test_trace_replay.py: the flight recorder
(armada_tpu_torch/trace) and the port's replay gate
(armada_tpu_torch/tools/replay_gate.py), on the CPU.

Every case is the JAX package's, with the port's imports and its solver
spellings: the recorded simulation runs on the port's kernel on the CPU,
"LOCAL" replays on the port's "cuda" path (its kernels' plain versions
on the CPU), the mesh replays on "2x2" shard threads, and every replay
solves on the CPU. The mesh and hot-window cases, slow in the JAX
package, run here.

The committed fixture (recorded by the JAX package) replays on the port
with zero divergences; tests/test_torch_trace_cross.py carries bundles
across the packages both ways. The port refuses a bundle recorded with
x64 off and the JAX package's kernel-path spellings.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu_torch.solver.kernel import solve_round
from armada_tpu_torch.solver.kernel_prep import (
    DeviceRound,
    pad_device_round,
    prep_device_round,
)
from armada_tpu_torch.trace import (
    TraceRecorder,
    TraceTargetMismatch,
    check_target,
    load_trace,
    replay_trace,
)
from armada_tpu_torch.trace.codec import decode_record, encode_record

REPO = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "sim_steady.atrace")


def record_sim_trace(path, *, backend="kernel", max_rounds=None, max_time=1500.0,
                     package="armada_tpu_torch"):
    """A small whole-sim service run (steady queue + gang bursts on a
    shared fleet) with the flight recorder attached; returns the
    SimResult. The port's simulator solves on the CPU."""
    import importlib

    cfgm = importlib.import_module(f"{package}.core.config")
    S = importlib.import_module(f"{package}.sim")
    simmod = importlib.import_module(f"{package}.sim.simulator")
    cfg = cfgm.SchedulingConfig(
        priority_classes={
            "high": cfgm.PriorityClass("high", 30000, preemptible=False),
            "low": cfgm.PriorityClass("low", 1000, preemptible=True),
        },
        default_priority_class="low",
        protected_fraction_of_fair_share=0.5,
        batch_fill_window=2,
    )
    kw = {"device": "cpu"} if package == "armada_tpu_torch" else {}
    sim = S.Simulator(
        [S.ClusterSpec("c1", node_templates=(
            simmod.NodeTemplate(count=6, cpu="16", memory="64Gi"),))],
        S.WorkloadSpec(queues=(
            S.QueueSpecSim("steady", job_templates=(
                S.JobTemplate(id="long", number=24, cpu="2", memory="4Gi",
                              runtime=simmod.ShiftedExponential(minimum=200.0)),)),
            S.QueueSpecSim("bursty", job_templates=(
                S.JobTemplate(id="gangs", number=8, cpu="4", memory="4Gi",
                              gang_cardinality=4, submit_time=50.0,
                              runtime=simmod.ShiftedExponential(minimum=100.0)),)),
        )),
        config=cfg, backend=backend, seed=0, max_time=max_time, trace_path=path, **kw,
    )
    if max_rounds is not None:
        sim.trace_recorder.max_rounds = max_rounds
    return sim.run()


@pytest.fixture(scope="module")
def sim_trace(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "sim.atrace")
    res = record_sim_trace(path)
    assert res.finished_jobs > 0
    return path


def test_fixture_replays_bit_exact_local():
    """The COMMITTED fixture bundle (recorded by the JAX package) replays
    bit-exactly on the port under LOCAL, "lax" and the hot window.
    allow_foreign is sound here — the header pins x64 exact-cost mode."""
    assert os.path.getsize(FIXTURE) < 100_000, "fixture must stay tiny"
    trace = load_trace(FIXTURE)
    assert trace.header["target"]["x64"] is True
    assert trace.header["source"] == "sim"
    report = replay_trace(trace, solvers=("LOCAL", "lax", "hotwindow:64"),
                          allow_foreign=True, device="cpu")
    assert report["ok"], report["divergences"]
    assert report["rounds"] >= 2
    scheduled = sum(
        int(np.asarray(r.decisions()["scheduled_mask"]).sum())
        for r in trace.rounds
    )
    assert scheduled > 0


def test_recorded_sim_rounds_replay_bit_exact_local(sim_trace):
    """Rounds recorded live from the port's service loop replay
    bit-exactly under LOCAL — placements, evictions, shares, AND the
    pass-1 loop stream (compare_round checks num_loops)."""
    trace = load_trace(sim_trace)
    assert len(trace.rounds) >= 5
    assert trace.header["seeds"] == {"workload_seed": 0}
    assert trace.header["config_fingerprint"]
    assert trace.header["target"]["x64"] is True
    assert trace.header["target"]["xla"].startswith("torch-")
    report = replay_trace(trace, solvers=("LOCAL",), device="cpu")
    assert report["ok"], report["divergences"]
    assert report["rounds"] == len(trace.rounds)


def test_recorded_sim_rounds_replay_two_level_mesh(sim_trace):
    """The same recorded rounds re-solved on a 2x2 mesh of shard threads
    match the recorded decision stream bit-for-bit."""
    trace = load_trace(sim_trace)
    report = replay_trace(trace, solvers=("2x2", "lax:2x2"), max_rounds=4, device="cpu")
    assert report["ok"], report["divergences"]
    assert report["rounds"] == 4
    assert {r["solver"] for r in report["results"]} == {"mesh:2x2", "kernel:lax:mesh:2x2"}


def test_recorded_sim_rounds_replay_hot_window(sim_trace):
    """Hot-window compaction on vs off over recorded rounds: both
    reproduce the recorded decisions and loop stream."""
    trace = load_trace(sim_trace)
    report = replay_trace(trace, solvers=("hotwindow:2", "lax:hotwindow:2", "LOCAL"),
                          max_rounds=4, device="cpu")
    assert report["ok"], report["divergences"]
    assert {r["solver"] for r in report["results"]} == {
        "hotwindow:2", "kernel:lax:hotwindow:2", "LOCAL"}


def test_oracle_recorded_trace_replays_on_kernel(tmp_path):
    """Record once from an ORACLE-backed service, replay on the kernel:
    the bundle's DeviceRound is the same device prep, so the kernel's
    decisions must match the oracle's."""
    path = str(tmp_path / "oracle.atrace")
    record_sim_trace(path, backend="oracle", max_rounds=6, max_time=400.0)
    trace = load_trace(path)
    assert trace.rounds and trace.rounds[0].backend == "oracle"
    report = replay_trace(trace, solvers=("LOCAL",), device="cpu")
    assert report["ok"], report["divergences"]


def test_mixed_fleet_fields_round_trip(tmp_path):
    """Away/market pools and gang membership survive a recorded trace:
    every DeviceRound field decodes bit-identical for the dryrun
    scenario set, and the decoded round re-solves bit-exactly."""
    from armada_tpu_torch.parallel.scenarios import mixed_fleet_rounds

    for label, snap in mixed_fleet_rounds(24, 96):
        snap = dataclasses.replace(
            snap, config=dataclasses.replace(snap.config, batch_fill_window=4)
        )
        dev = pad_device_round(prep_device_round(snap))
        out = solve_round(dev, device="cpu")
        path = str(tmp_path / f"{label}.atrace")
        with TraceRecorder(path, source="test", config=snap.config) as rec:
            rec.record_round(
                pool=snap.pool, dev=dev, decisions=out,
                num_jobs=snap.num_jobs, num_queues=snap.num_queues,
                config=snap.config, solver={"backend": "kernel"},
                ids={"jobs": list(snap.job_ids)},
            )
        trace = load_trace(path)
        dev2 = trace.rounds[0].device_round()
        for f in dataclasses.fields(DeviceRound):
            a, b = getattr(dev, f.name), getattr(dev2, f.name)
            if isinstance(a, tuple) or not hasattr(a, "shape"):
                assert a == b, f"{label}: {f.name} changed type/value"
            else:
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype, f"{label}: {f.name} dtype drifted"
                assert np.array_equal(a, b), f"{label}: {f.name} not bit-exact"
        if label == "home_away":
            assert bool(dev2.has_away)
            assert np.asarray(dev2.pc_away_count).any(), "away tables lost"
            assert np.asarray(dev2.node_taints).any(), "borrowed gpu taints lost"
            assert (np.asarray(dev2.slot_count) > 1).any(), "gangs lost"
        if label == "market":
            assert bool(dev2.market_driven)
            assert np.asarray(dev2.job_bid).any(), "market bids lost"
        report = replay_trace(trace, solvers=("LOCAL",), device="cpu")
        assert report["ok"], (label, report["divergences"])


def test_foreign_target_refuses_with_clear_error(tmp_path, sim_trace):
    """A bundle whose target signature names a different host refuses to
    replay, and an x64-mode mismatch refuses even with allow_foreign:
    the port runs x64 only, so a bundle recorded with x64 off always
    refuses."""
    trace = load_trace(sim_trace)
    foreign = dict(trace.header)
    foreign["target"] = dict(foreign["target"], host_cpu="feedface00000000")
    with pytest.raises(TraceTargetMismatch, match="different host"):
        check_target(foreign)
    check_target(foreign, allow_foreign=True)  # explicit override works
    wrong_mode = dict(trace.header)
    wrong_mode["target"] = dict(wrong_mode["target"], x64=False)
    with pytest.raises(TraceTargetMismatch, match="x64"):
        check_target(wrong_mode, allow_foreign=True)
    tampered = tmp_path / "foreign.atrace"
    with open(sim_trace) as f, open(tampered, "w") as out:
        for i, line in enumerate(f):
            record = decode_record(line)
            if i == 0:
                record["target"]["host_cpu"] = "feedface00000000"
            out.write(encode_record(record) + "\n")
    with pytest.raises(TraceTargetMismatch):
        replay_trace(load_trace(str(tampered)), device="cpu")


def test_second_recording_session_replaces_bundle(tmp_path, sim_trace):
    """A new recorder on an existing path REPLACES the bundle; a
    hand-concatenated multi-session file is refused."""
    from armada_tpu_torch.trace import TraceFormatError

    rec0 = load_trace(sim_trace).rounds[0]
    path = tmp_path / "b.atrace"
    for _ in range(2):
        with TraceRecorder(str(path), source="test") as recorder:
            recorder.record_round(
                pool="default", dev=rec0.device_round(),
                decisions=rec0.decisions(), num_jobs=rec0.num_jobs,
                num_queues=rec0.num_queues,
            )
    assert len(load_trace(str(path)).rounds) == 1  # replaced, not merged
    doubled = tmp_path / "doubled.atrace"
    doubled.write_text(path.read_text() * 2)
    with pytest.raises(TraceFormatError, match="second header"):
        load_trace(str(doubled))


def test_truncated_rounds_are_skipped(sim_trace):
    """A budget-truncated decision stream is skipped, not compared."""
    trace = load_trace(sim_trace)
    for rec in trace.rounds:
        rec.raw["truncated"] = True
    report = replay_trace(trace, solvers=("LOCAL",), device="cpu")
    assert report["rounds"] == 0
    assert report["skipped"] == len(trace.rounds)


def test_replay_divergence_metrics_counter(sim_trace):
    """Divergences reach the metrics registry by kind, and the recorder's
    capture counters move."""
    from armada_tpu_torch.services.metrics import HAVE_PROMETHEUS, SchedulerMetrics

    if not HAVE_PROMETHEUS:
        pytest.skip("prometheus_client unavailable")
    trace = load_trace(sim_trace)
    metrics = SchedulerMetrics()
    report = replay_trace(
        trace, solvers=("LOCAL",), max_rounds=2, perturb="tiebreak",
        metrics=metrics, device="cpu",
    )
    assert not report["ok"]
    rendered = metrics.render().decode()
    assert 'scheduler_trace_replay_divergences_total{kind="placement"}' in rendered
    rec0 = trace.rounds[0]
    with TraceRecorder(os.devnull, source="test") as recorder:
        recorder.record_round(
            pool="default", dev=rec0.device_round(),
            decisions=rec0.decisions(), num_jobs=rec0.num_jobs,
            num_queues=rec0.num_queues, metrics=metrics,
        )
    rendered = metrics.render().decode()
    assert 'scheduler_trace_rounds_recorded_total{pool="default"}' in rendered
    assert "scheduler_trace_bytes_written_total" in rendered


def test_replay_gate_cli(sim_trace, tmp_path):
    """armada_tpu_torch.tools.replay_gate: exit 0 on HEAD, 1 on a
    deliberately perturbed kernel, 2 on an unusable bundle and on the JAX
    package's kernel-path spellings."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(REPO)

    def gate(*args):
        return subprocess.run(
            [sys.executable, "-m", "armada_tpu_torch.tools.replay_gate", *args,
             "--device", "cpu"],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=900,
        )

    clean = gate(sim_trace, "--max-rounds", "2", "--json")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    summary = json.loads(clean.stdout.strip().splitlines()[-1])["summary"]
    assert summary["ok"] and summary["rounds"] == 2

    perturbed = gate(sim_trace, "--max-rounds", "2", "--perturb", "tiebreak")
    assert perturbed.returncode == 1, perturbed.stdout + perturbed.stderr
    assert "DIVERGED" in perturbed.stdout

    bogus = tmp_path / "not_a_trace.atrace"
    bogus.write_text("this is not a bundle\n")
    broken = gate(str(bogus))
    assert broken.returncode == 2, broken.stdout + broken.stderr

    pallas = gate(sim_trace, "--solver", "pallas")
    assert pallas.returncode == 2, pallas.stdout + pallas.stderr
    assert "cuda, lax" in pallas.stdout


def test_reference_kernel_paths_refused():
    """The JAX package's kernel paths are not the port's: refused by name."""
    from armada_tpu_torch.trace import replay_solver

    for spec in ("pallas", "blocked", "native", "pallas:2x2"):
        with pytest.raises(ValueError, match="cuda, lax"):
            replay_solver(spec, device="cpu")
    assert replay_solver("LOCAL", device="cpu")[0] == "LOCAL"
    assert replay_solver("lax", device="cpu")[0] == "kernel:lax"
    assert replay_solver("hotwindow:8", device="cpu")[0] == "hotwindow:8"
    assert replay_solver("lax:hotwindow:8", device="cpu")[0] == "kernel:lax:hotwindow:8"
