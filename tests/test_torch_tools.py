"""The port's fairness and Perfetto tools against the JAX package's
(armada_tpu_torch/tools/fairness_report.py and trace2perfetto.py, the
counterparts of the repo's tools/fairness_report.py and
tools/trace2perfetto.py).

- tests/test_trace2perfetto.py, all 4 cases, side by side on both
  packages (`torch_control_plane.run_side_by_side`; the port's copy
  imports the port's converter and runs its CLI as a module), and the
  committed fixture's conversion equal event for event.
- tests/test_fairness.py::test_offline_scorecard_matches_live_sim: its
  contention simulation recorded on the port's kernel backend on the
  CPU, the port's fairness_report over the bundle equal to the live
  scorecard; the same simulation on the JAX package (its host oracle,
  whose scorecard test_fairness.py holds to its kernel's) leases the
  same jobs every cycle, and both live and offline scorecards are equal
  across the packages, exactly.
"""

import json
import os

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import port_copy, record_cycles, run_side_by_side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "sim_steady.atrace")

PERFETTO_SUBS = (
    (r'sys\.path\.insert\(0, os\.path\.join\(REPO, "tools"\)\)\n\nimport trace2perfetto',
     "from armada_tpu_torch.tools import trace2perfetto"),
    (r'\[sys\.executable, os\.path\.join\(REPO, "tools", "trace2perfetto\.py"\),',
     '[sys.executable, "-m", "armada_tpu_torch.tools.trace2perfetto",'),
    (r'capture_output=True, text=True, env=', "capture_output=True, text=True, cwd=REPO, env="),
)
PERFETTO_CASES = (
    "test_check_round_trips_committed_fixture",
    "test_atrace_conversion_covers_every_round",
    "test_otlp_spans_convert_with_nesting_metadata",
    "test_twenty_round_sim_exports_loadable_timeline",
)


@pytest.mark.parametrize("test", PERFETTO_CASES)
def test_trace2perfetto_case_matches_reference(test, monkeypatch, tmp_path):
    run_side_by_side("test_trace2perfetto", test, monkeypatch, tmp_path,
                     port_subs=PERFETTO_SUBS)


def test_fixture_converts_as_the_reference_converts():
    import importlib.util

    from armada_tpu_torch.tools import trace2perfetto

    spec = importlib.util.spec_from_file_location(
        "ref_trace2perfetto", os.path.join(REPO, "tools", "trace2perfetto.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert trace2perfetto.FIXTURE == ref.FIXTURE == FIXTURE
    got = trace2perfetto.convert([FIXTURE])
    assert got == ref.convert([FIXTURE]) and trace2perfetto.validate(got) == []


FAIRNESS_SUBS = (("import fairness_report\n", "from armada_tpu_torch.tools import fairness_report\n"),)


def test_offline_scorecard_matches_live_sim(monkeypatch, tmp_path, capsys):
    import armada_tpu.services.scheduler as ref_scheduler
    import armada_tpu_torch.device as port_device
    import armada_tpu_torch.services.scheduler as port_scheduler
    from armada_tpu.observe.fairness import aggregate_scorecard as ref_scorecard
    from armada_tpu_torch.observe.fairness import aggregate_scorecard

    import test_fairness as ref

    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    port = port_copy("test_fairness", FAIRNESS_SUBS)
    ref_history = record_cycles(monkeypatch, ref_scheduler)
    ref_sim = ref.contention_sim(backend="oracle", trace_path=str(tmp_path / "ref.atrace"))
    ref_blocks = ref.tap_fairness(ref_sim)
    ref_sim.run()
    port_history = record_cycles(monkeypatch, port_scheduler)
    path = str(tmp_path / "port.atrace")
    sim = port.contention_sim(backend="kernel", trace_path=path)
    assert sim.scheduler._rungs[0].label == "local:cuda"
    blocks = port.tap_fairness(sim)
    result = sim.run()
    assert result.preemptions > 0
    assert len(port_history) == len(ref_history) == 1
    assert port_history[0] == ref_history[0]

    # The reference's case, on the port's run and the port's tool.
    port.test_offline_scorecard_matches_live_sim((sim, result, blocks, path), capsys)
    live = json.loads(json.dumps(aggregate_scorecard(blocks)))
    assert live == json.loads(json.dumps(ref_scorecard(ref_blocks)))
    from armada_tpu_torch.tools import fairness_report

    for bundle in (path, str(tmp_path / "ref.atrace")):
        assert fairness_report.main(["--json", bundle]) == 0
        assert json.loads(capsys.readouterr().out)["scorecard"] == live


def test_fairness_report_sim_matches_reference(capsys):
    """`--sim`, the built-in starvation simulation, on the port's kernel
    on the CPU, against the JAX package's (which runs it on its oracle):
    the same scorecard document, rendered to the same text."""
    import importlib.util

    from armada_tpu_torch.tools import fairness_report

    spec = importlib.util.spec_from_file_location(
        "ref_fairness_report", os.path.join(REPO, "tools", "fairness_report.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert ref.main(["--sim", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert fairness_report.main(["--sim", "--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want
    text = fairness_report.render(got["scorecard"], got["inputs"])
    assert text == ref.render(want["scorecard"], want["inputs"])
    assert all(q in text for q in ("qa", "qb", "qc"))
