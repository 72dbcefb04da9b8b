"""Flight-recorder bundles as the state carried across the packages,
both ways, on the CPU: a bundle the port records replays on the JAX
package's own `replay_trace`, a bundle the JAX package records live
replays on the port, each with zero divergences, and the policy A/B
harness scores a bundle alike on both.
"""

import pytest
import torch_cpu  # noqa: F401

from armada_tpu_torch.trace import load_trace, replay_trace
from test_torch_trace_replay import FIXTURE, record_sim_trace


@pytest.fixture(scope="module")
def sim_trace(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "sim.atrace")
    assert record_sim_trace(path).finished_jobs > 0
    return path


def test_port_bundle_replays_on_reference(sim_trace):
    """A bundle the port recorded replays on the JAX package's own
    replay_trace (its "lax" path) with zero divergences, loop stream and
    fairness ledger included."""
    from armada_tpu.trace import load_trace as ref_load_trace
    from armada_tpu.trace import replay_trace as ref_replay_trace

    trace = ref_load_trace(sim_trace)
    report = ref_replay_trace(trace, solvers=("lax",), allow_foreign=True)
    assert report["ok"], report["divergences"]
    assert report["rounds"] == len(trace.rounds)


def test_reference_bundle_replays_on_port(tmp_path):
    """A bundle the JAX package records live (its kernel, x64) replays on
    the port with zero divergences."""
    path = str(tmp_path / "ref.atrace")
    record_sim_trace(path, max_rounds=6, max_time=400.0, package="armada_tpu")
    trace = load_trace(path)
    assert trace.header["target"]["x64"] is True and len(trace.rounds) == 6
    report = replay_trace(trace, solvers=("LOCAL", "lax"), allow_foreign=True, device="cpu")
    assert report["ok"], report["divergences"]
    assert report["rounds"] == 6


def test_policy_ab_scorecards_equal_reference():
    """The policy A/B harness (trace/policy_ab.py) scores the committed
    fixture under DRF and the proportional policy: the port's scorecards
    equal the JAX package's on its "lax" path, and the operator view
    renders every candidate."""
    from armada_tpu.trace.policy_ab import ab_compare as ref_ab_compare
    from armada_tpu_torch.trace.policy_ab import ab_compare, render_ab

    got = ab_compare([FIXTURE], ("drf", "proportional"), solver="lax",
                     allow_foreign=True, device="cpu")
    want = ref_ab_compare([FIXTURE], ("drf", "proportional"), solver="lax",
                          allow_foreign=True)
    assert got["policies"] == want["policies"]
    assert got["inputs"] == want["inputs"]
    text = render_ab(got)
    assert "drf" in text and "proportional" in text
