"""Port copy of the tests/test_slo.py cases that need no gRPC, lookout,
CLI or front door: the SLO tracker (armada_tpu_torch/services/slo.py) on
a virtual clock, the config's SLO declarations, the port's SLO gate
(armada_tpu_torch/tools/slo_gate.py) on the committed fixture, and the
simulator's tracker.

Every case is the JAX package's, with the port's imports; the tracker
cases also hold the port's snapshots and verdicts to the JAX package's
tracker fed the same observations, exactly. The simulator case runs on
the host oracle, as the JAX package's does, and again on the port's
kernel on the CPU.
"""

import json
import os

import pytest
import torch_cpu  # noqa: F401

import armada_tpu.services.slo as ref_slo
from armada_tpu_torch.core.config import SchedulingConfig, SLOSpec
from armada_tpu_torch.services.slo import DEFAULT_SLOS, SLOTracker
from torch_control_plane import plain, to_reference

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "sim_steady.atrace")


class TwinTracker:
    """The port's SLOTracker with the JAX package's fed alongside: every
    read returns the port's answer after asserting the reference's is
    the same."""

    def __init__(self, slos):
        self.port = SLOTracker(slos)
        self.ref = ref_slo.SLOTracker(to_reference(tuple(slos)))

    def observe(self, *a, **k):
        self.port.observe(*a, **k)
        self.ref.observe(*a, **k)

    def __getattr__(self, name):
        def call(*a, **k):
            got = getattr(self.port, name)(*a, **k)
            assert plain(got) == plain(getattr(self.ref, name)(*a, **k)), name
            return got
        return call


FAST_SLO = SLOSpec(
    name="lat", signal="latency_seconds", threshold_s=1.0, objective=0.9,
    fast_burn_window_s=10.0, slow_burn_window_s=100.0,
    fast_burn_threshold=2.0, slow_burn_threshold=1.5,
)


def test_tracker_burn_rates_on_virtual_clock():
    """burn = error_rate / error_budget per window: 10 observations with
    2 bad in the fast window → error rate 0.2 against a 0.1 budget →
    burn 2.0; the slow window sees all 20 with 2 bad → burn 1.0."""
    t = TwinTracker((FAST_SLO,))
    for i in range(10):  # old good events, outside the fast window
        t.observe("latency_seconds", 0.1, now=float(i))
    for i in range(10):  # recent: 8 good + 2 bad
        value = 5.0 if i >= 8 else 0.1
        t.observe("latency_seconds", value, now=90.0 + i)
    burns = t.burn_rates(now=99.0)["lat"]
    assert burns["fast"] == pytest.approx(2.0)
    assert burns["slow"] == pytest.approx(1.0)
    snap = t.snapshot(now=99.0)["slos"][0]
    assert snap["observed"] == 20 and snap["bad"] == 2
    assert snap["compliance"] == pytest.approx(0.9)
    # fast >= 2.0 AND slow >= 1.5 is the alert; slow sits at 1.0 → no.
    assert not snap["alerting"]


def test_tracker_multiwindow_alert_memory_and_evaluate():
    """The gate remembers a mid-run multiwindow burn even when lifetime
    compliance recovers — and reports it as a breach."""
    t = TwinTracker((FAST_SLO,))
    # A dense burst of bad events: both windows burn past threshold.
    for i in range(10):
        t.observe("latency_seconds", 9.0, now=float(i))
    assert t.snapshot(now=9.0)["slos"][0]["breached_at"] is not None
    # A long good tail recovers lifetime compliance above the objective.
    for i in range(200):
        t.observe("latency_seconds", 0.1, now=20.0 + i)
    verdict = t.evaluate(now=220.0)
    snap = verdict["slos"][0]
    assert snap["compliance"] > FAST_SLO.objective
    assert not verdict["ok"]
    assert "multiwindow burn alert fired" in verdict["breaches"][0]


def test_tracker_unobserved_slo_never_breaches():
    t = TwinTracker(DEFAULT_SLOS)
    t.observe("round_seconds", 0.1, now=0.0)
    verdict = t.evaluate(now=1.0)
    assert verdict["ok"]
    observed = {s["name"]: s["observed"] for s in verdict["slos"]}
    assert observed["round-latency"] == 1
    assert observed["queue-wait"] == 0  # reported, never a breach


def test_config_declares_and_validates_slos():
    cfg = SchedulingConfig.from_dict({
        "slos": [
            {"name": "round-latency", "signal": "round_seconds",
             "thresholdSeconds": 2.0, "objective": 0.999,
             "fastBurnWindowSeconds": 60.0},
        ]
    })
    assert cfg.slos[0].threshold_s == 2.0
    assert cfg.slos[0].objective == 0.999
    assert cfg.slos[0].fast_burn_window_s == 60.0
    tracker = SLOTracker.from_config(cfg)
    assert tracker.slos == cfg.slos
    # Empty config → tracked defaults.
    assert SLOTracker.from_config(SchedulingConfig()).slos == DEFAULT_SLOS
    from armada_tpu_torch.core.config import validate_config

    with pytest.raises(ValueError, match="error budget"):
        validate_config(SchedulingConfig(slos=(
            SLOSpec(name="x", signal="s", threshold_s=1.0, objective=1.0),
        )))
    with pytest.raises(ValueError, match="thresholdSeconds"):
        validate_config(SchedulingConfig(slos=(
            SLOSpec(name="x", signal="s", threshold_s=0.0),
        )))


# ---------------------------------------------------------------------------
# The gate CLI (acceptance pair: fixture passes, tightened SLO trips)


def test_slo_gate_passes_on_committed_fixture(capsys):
    from armada_tpu_torch.tools.slo_gate import main as slo_gate_main

    assert slo_gate_main([FIXTURE]) == 0
    out = capsys.readouterr().out
    assert "round-latency" in out and "OK" in out


def test_slo_gate_trips_on_tightened_slo(capsys):
    from armada_tpu_torch.tools.slo_gate import main as slo_gate_main

    assert slo_gate_main([FIXTURE, "--override", "round-latency=1e-6"]) == 1
    assert "BREACH" in capsys.readouterr().out
    # Typo'd override names must not silently gate nothing.
    assert slo_gate_main([FIXTURE, "--override", "nosuch=1"]) == 2
    # Objective override too: keep the threshold, demand perfection the
    # fixture cannot deliver against a sub-ms threshold.
    assert (
        slo_gate_main([FIXTURE, "--override", "round-latency=0.001:0.5"]) == 1
    )


def test_slo_gate_reads_observation_documents(tmp_path, capsys):
    from armada_tpu_torch.tools.slo_gate import main as slo_gate_main

    doc = {
        "observations": [
            {"signal": "frontdoor_submit_seconds", "value": 0.01, "now": i}
            for i in range(20)
        ]
    }
    path = tmp_path / "obs.json"
    path.write_text(json.dumps(doc))
    assert slo_gate_main([str(path)]) == 0
    bad = {
        "observations": [
            {"signal": "frontdoor_submit_seconds", "value": 9.0, "now": i}
            for i in range(20)
        ]
    }
    path.write_text(json.dumps(bad))
    assert slo_gate_main([str(path)]) == 1
    # No decodable observations is unusable, not a green gate.
    path.write_text(json.dumps({"observations": []}))
    assert slo_gate_main([str(path)]) == 2
    capsys.readouterr()


@pytest.mark.parametrize("backend", ["oracle", "kernel"])
def test_sim_attaches_tracker_and_observes_on_virtual_clock(backend):
    from armada_tpu_torch.sim.simulator import (
        ClusterSpec,
        JobTemplate,
        NodeTemplate,
        QueueSpecSim,
        Simulator,
        WorkloadSpec,
    )

    sim = Simulator(
        [ClusterSpec(name="c", node_templates=(NodeTemplate(count=2, cpu="8"),))],
        WorkloadSpec(queues=(
            QueueSpecSim(name="q", job_templates=(
                JobTemplate(id="t", number=4, cpu="2"),
            )),
        )),
        backend=backend,
        device="cpu",
        cycle_interval=10.0,
        max_time=300.0,
        slo=True,
    )
    sim.run()
    verdict = sim.slo.evaluate()
    by_name = {s["name"]: s for s in verdict["slos"]}
    assert by_name["round-latency"]["observed"] > 0
    assert by_name["queue-wait"]["observed"] == 4
    # Oracle cycles are milliseconds and first leases land within a
    # couple of virtual cycles: the default objectives hold.
    assert verdict["ok"], verdict
