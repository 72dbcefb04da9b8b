"""The port's autotune (armada_tpu_torch/autotune, services/checkpoint.py,
`python -m armada_tpu_torch.tools.autotune`) against the JAX package's,
on the CPU.

Every case of tests/test_autotune.py, and the autotune case of
tests/test_hotwindow.py, runs side by side on both packages (the port's
copy compiled from the reference's source with its imports pointed at
the port, `torch_control_plane.run_side_by_side`): each case's own
assertions hold on both, and the leases after every scheduler cycle are
equal. The port's copy of the two CLI cases runs the port's CLI on the
CPU in place of the reference's script, and runs alone: the reference's
script runs in tests/test_autotune.py's own cases, a subprocess that
cycles no scheduler and costs 30 s of JAX start-up and compiles here,
and the tuner it drives is held to the port's below. The reference's
`slow` marks stay on their cases (the full default grid).

Direct twins, each exact (these are decisions, not measurements):
- a checkpoint written by either package loads in the other to an
  equal state, classes of the JAX package arriving as the port's;
- on the committed fixture corpus, `workload_fingerprint`,
  `baseline_params`, the candidate labels and every candidate's
  `bit_exact` are equal (`selected` is chosen by wall time and may
  differ);
- the online controller adopts the same changes, in the same order, for
  the same seeded sequence of synthetic profiles (synthetic, because the
  shrink signal reads `gather_s`, a time).
"""

import importlib
import os

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import case_marks, plain, port_copy, run_side_by_side, to_reference

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "sim_steady.atrace")
# The port's copy of a CLI case runs the port's CLI on the CPU.
PORT_CLI = ((r'os\.path\.join\(REPO, "tools", "autotune\.py"\)',
             '"-m", "armada_tpu_torch.tools.autotune", "--device", "cpu"'),)


CLI_CASES = ("test_offline_tuner_cli_smoke", "test_offline_tuner_refuses_unusable_corpus")


def _cases():
    ref = importlib.import_module("test_autotune")
    out = [("test_autotune", t) for t in sorted(vars(ref)) if t.startswith("test_")]
    return out + [("test_hotwindow", "test_window_size_autotuning")]


CASES = _cases()


def test_every_autotune_case_is_collected():
    """The reference's 16 autotune cases and the hot window's one."""
    assert len(CASES) == 17


@pytest.mark.parametrize(
    "name, test",
    [pytest.param(n, t, marks=case_marks(n, t), id=f"{n}::{t}") for n, t in CASES],
)
def test_autotune_case_matches_reference(name, test, monkeypatch, tmp_path):
    if test in CLI_CASES:
        getattr(port_copy(name, PORT_CLI), test)(tmp_path)
    else:
        run_side_by_side(name, test, monkeypatch, tmp_path)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_interchange(writer, tmp_path):
    """A checkpoint written by either package loads in the other to an
    equal state: a tuning-store dump, and the scheduler's settings with a
    job record of the writer's classes (the port loads the JAX package's
    classes as its own, importing nothing of the JAX package)."""
    from armada_tpu.autotune import TunedParams as RefParams
    from armada_tpu.autotune import make_entry as ref_entry
    from armada_tpu.core.types import JobSpec as RefJobSpec
    from armada_tpu.services.checkpoint import CheckpointStore as RefStore
    from armada_tpu_torch.services.checkpoint import CheckpointStore as PortStore
    from armada_tpu_torch.utils.carry import to_port

    store = {"format": 1, "entries": {
        "t/default/w": ref_entry(RefParams(7, 0, 2), target="t", workload="w",
                                 pool="default", created=1.0),
    }}
    ref_state = {
        "autotune": store,
        "cordoned_queues": {"q"},
        "executor_fences": {"ex-a": 3},
        "job": RefJobSpec(id="j0", queue="q", requests={"cpu": "1"}),
    }
    port_state = to_port(ref_state)
    directory = str(tmp_path / "ckpt")
    if writer == "reference":
        RefStore(directory).save("view", 42, ref_state)
        cursor, got = PortStore(directory).load("view")
        assert type(got["job"]).__module__ == "armada_tpu_torch.core.types"
        assert (cursor, got) == (42, port_state)
    else:
        PortStore(directory).save("view", 42, port_state)
        cursor, got = RefStore(directory).load("view")
        assert cursor == 42
        assert plain(got) == plain(ref_state)
        assert to_reference(got) == ref_state


def test_offline_tuner_decisions_match_reference():
    """tune_corpus over the committed fixture corpus on a small grid:
    the workload fingerprint, the baseline, the candidate labels and
    every candidate's bit-exactness are the reference's."""
    from armada_tpu import autotune as ref
    from armada_tpu.trace import load_trace as ref_load
    from armada_tpu_torch import autotune as port
    from armada_tpu_torch.trace import load_trace as port_load

    grid = [(2, 0, 1), (4, 0, 1)]
    ref_traces, port_traces = [ref_load(FIXTURE)], [port_load(FIXTURE)]
    want = ref.tune_corpus(ref_traces, [ref.TunedParams(*p) for p in grid],
                           repeats=1, allow_foreign=True)
    got = port.tune_corpus(port_traces, [port.TunedParams(*p) for p in grid],
                           repeats=1, allow_foreign=True, device="cpu")
    assert port.workload_fingerprint(port_traces) == ref.workload_fingerprint(ref_traces)
    assert got["workload"] == want["workload"]
    assert (port.baseline_params(port_traces).as_dict()
            == ref.baseline_params(ref_traces).as_dict())
    assert got["rounds"] == want["rounds"] and got["ok"] and want["ok"]

    def rows(report):
        return [(r["label"], r["params"], r["bit_exact"], r["divergences"])
                for r in report["results"]]

    assert rows(got) == rows(want)
    assert got["selected"]["workload"] == want["selected"]["workload"]
    assert got["selected"]["pool"] == want["selected"]["pool"]


def _profiles(seed, n):
    """A seeded sequence of synthetic solve profiles: starved, oversized,
    steady, disengaged and missing ones, in runs long enough to trip the
    hysteresis."""
    rng = np.random.default_rng(seed)
    kinds = (
        lambda: {"compacted": True, "rewindows": int(rng.integers(4, 12)),
                 "gather_s": 0.01, "pass1_s": float(rng.uniform(0.1, 1.0))},
        lambda: {"compacted": True, "rewindows": 0,
                 "gather_s": float(rng.uniform(0.3, 1.0)), "pass1_s": 0.1},
        lambda: {"compacted": True, "rewindows": int(rng.integers(1, 4)),
                 "gather_s": 0.05, "pass1_s": 0.5},
        lambda: {"compacted": False},
        lambda: None,
    )
    out = []
    while len(out) < n:
        kind = kinds[int(rng.integers(len(kinds)))]
        out += [kind() for _ in range(int(rng.integers(1, 6)))]
    return out[:n]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_adoptions_match_reference(seed):
    """The same seeded profile sequence over two pools adopts the same
    changes in the same order, with the same per-pool vectors and store
    entries, on both packages."""
    from armada_tpu.autotune import AutotuneController as RefController
    from armada_tpu.core.config import SchedulingConfig as RefConfig
    from armada_tpu_torch.autotune import AutotuneController
    from armada_tpu_torch.core.config import SchedulingConfig

    kw = dict(hot_window_slots=64, hot_window_min_slots=0, batch_fill_window=2,
              autotune_enabled=True, autotune_hysteresis_rounds=2,
              autotune_min_window_slots=4, autotune_max_window_slots=1024)
    ref, port = RefController(RefConfig(**kw)), AutotuneController(SchedulingConfig(**kw))
    for i, profile in enumerate(_profiles(seed, 300)):
        pool = ("a", "b")[i % 2]
        want = ref.observe_round(pool, profile, solve_s=0.5)
        got = port.observe_round(pool, profile, solve_s=0.5)
        assert (got is None) == (want is None), i
        assert port.params_for(pool).as_dict() == ref.params_for(pool).as_dict(), i

    def adoptions(ctl):
        return [{k: v for k, v in a.items() if k != "ts"} for a in ctl.adoptions]

    assert adoptions(port) == adoptions(ref)
    assert len(adoptions(port)) >= 4

    def entries(ctl):
        return sorted((e["pool"], e["params"]["hot_window_slots"], e["meta"]["direction"])
                      for e in ctl.store.entries())

    assert entries(port) == entries(ref)
