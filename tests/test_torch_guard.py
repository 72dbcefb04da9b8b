"""The port stands alone: no module of armada_tpu_torch (the home/away
scenario module, the hot window and the transfer ledger included), and
not chip_smoke.py, imports jax or armada_tpu, also when the main path,
the fast-fill path, a budgeted, compacted solve, a market round, a
deadline-policy round and a warm cycle (incremental snapshot, resident
round, fairness ledger) run; and the
default device is the CUDA card, which raises where there is none."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = textwrap.dedent(
    """
    import importlib, importlib.util, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "armada_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, ROOT)
    import armada_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        armada_tpu_torch.__path__, "armada_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT + "/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    # Run the main path once on the CPU so lazy imports load too.
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.solver.validate import validate_round

    from armada_tpu_torch.workload import build_inputs

    inputs = build_inputs(60, 6, n_running=8)
    dev = pad_device_round(prep_device_round(build_round_snapshot(*inputs)))
    out = solve_round(dev, device="cpu")
    assert validate_round(out, dev=dev) is None
    assert int(out["scheduled_mask"].sum()) > 0
    # The fast-fill path on the port's own home/away round.
    assert "armada_tpu_torch.parallel.scenarios" in names
    from armada_tpu_torch.parallel.scenarios import home_away_round

    dev = pad_device_round(prep_device_round(home_away_round(16, 48)))
    stats = {}
    out = solve_round(dev, device="cpu", stats=stats)
    assert dev.fast_fill and stats["merged_fill_loops"] > 0
    assert int(out["scheduled_mask"].sum()) > 0
    # The host-driven driver: a budgeted, compacted solve (hot window and
    # transfer ledger), as the scheduler asks for it.
    assert "armada_tpu_torch.solver.hotwindow" in names
    assert "armada_tpu_torch.observe.ledger" in names
    inputs = build_inputs(60, 6, n_running=8, fill_window=2)
    dev = pad_device_round(prep_device_round(build_round_snapshot(*inputs)))
    out = solve_round(dev, device="cpu", budget_s=60.0, window=2, window_min_slots=0)
    assert out["profile"]["compacted"] and out["truncated"] is False
    assert out["profile"]["transfer"]["bytes_up"] > 0
    # A market round (the port's market_round) and a policy round.
    from armada_tpu_torch.parallel.scenarios import market_round
    from armada_tpu_torch.workload import policy_inputs

    dev = pad_device_round(prep_device_round(market_round(16, 256)))
    out = solve_round(dev, device="cpu")
    assert dev.market_driven and out["spot_price"] == out["spot_price"]
    assert validate_round(out, dev=dev) is None
    inputs = policy_inputs(build_inputs(60, 6, n_running=8), "deadline")
    dev = pad_device_round(prep_device_round(build_round_snapshot(*inputs)))
    out = solve_round(dev, device="cpu")
    assert dev.fairness_policy[0] == "deadline" and validate_round(out, dev=dev) is None
    assert int(out["scheduled_mask"].sum()) > 0
    # The warm cycle: the incremental snapshot, the resident round (its
    # sync booked, its solve booking no upload) and the fairness ledger.
    for name in ("snapshot.incremental", "snapshot.residency", "observe.fairness"):
        assert "armada_tpu_torch." + name in names
    from armada_tpu_torch.workload import WarmCycle

    warm = WarmCycle(build_inputs(400, 6, n_running=8, fast_fill=True, fill_window=4),
                     device="cpu")
    assert warm.cold()["sync"]["mode"] == "reset"
    rec = warm.cycle()
    assert rec["sync"]["mode"] == "delta" and rec["transfer"]["bytes_up"] == 0
    assert rec["violation"] is None and warm.resident.check_drift() == []
    assert 0.0 < warm.fairness()["jain"] <= 1.0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "armada_tpu"))
    assert not loaded, loaded
    print("GUARD_OK", len(names))
    """
)


def test_port_imports_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _GUARD],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "GUARD_OK" in r.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    from armada_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert device.COST_DTYPE == torch.float64 and device.KEY_DTYPE == torch.int64


def test_solve_round_defaults_to_the_card(monkeypatch):
    """With no device argument the solve asks for CUDA and raises here."""
    from armada_tpu_torch.solver import kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.solve_round(_tiny_round())


def _tiny_round():
    from armada_tpu_torch.core.config import SchedulingConfig
    from armada_tpu_torch.core.types import JobSpec, NodeSpec, QueueSpec
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round

    snap = build_round_snapshot(
        SchedulingConfig(), "default",
        [NodeSpec(id="n0", pool="default", total_resources={"cpu": "4", "memory": "4Gi"})],
        [QueueSpec("q")], [],
        [JobSpec(id="j0", queue="q", requests={"cpu": "1", "memory": "1Gi"})],
    )
    return pad_device_round(prep_device_round(snap))
