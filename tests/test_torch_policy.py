"""The fairness policies (proportional, priority, deadline): the port's
solve_round against the JAX package's, on the CPU.

Each padded round goes through the reference's `solve_round` on its
"lax" path and through the port's on both of its paths ("cuda": the
kernels' plain versions on the CPU; "lax"): the decisions, num_loops and
spot_price bit-exact, the fair shares within 4 ULP (16 for the uncapped
accumulator), as tests/test_torch_round.py holds the DRF rounds. The
reference's fused "pallas" path is its own tests' to hold to its "lax"
path (tests/test_pallas_parity.py). The rounds:

- the port's copy of tests/test_policy.py's oracle-parity round at seed
  0, deadlines stamped for the deadline policy;
- the extreme-weight waterfill (weights 1e-6 to 1e6), whose fair shares
  are also held to the reference's host oracle within the same bounds;
- a proportional round over four resources whose per-queue fractions sum
  to different floats in another association: the port's cost measure
  equals the reference's bit for bit where a pairwise or reversed sum
  would not;
- the replace of a prepared bench round into its policy variant
  (`workload.repolicy`, which chip_smoke.py's policy phase solves) equal
  to a fresh prep of the same inputs, and solved equal to the reference.

Every round of tests/torch_scenarios.py under each policy is in
tests/test_torch_policy_scenarios.py (fused) and
tests/test_torch_policy_fast_fill.py (fast fill).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401
import torch

from armada_tpu.core.config import SchedulingConfig
from armada_tpu.core.types import JobSpec, NodeSpec, QueueSpec
from armada_tpu.snapshot.round import build_round_snapshot
from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver.kernel_prep import pad_device_round, prep_device_round
from armada_tpu.solver.reference import ReferenceSolver
from armada_tpu_torch.solver import kernel as port_kernel
from armada_tpu_torch.solver.kernel_prep import from_reference_round
from armada_tpu_torch.solver.validate import validate_round
from test_kernel_parity import rand_scenario
from test_policy import NON_DRF, _cfg, _stamp_deadlines
from test_torch_round import ULP_BOUNDS, _assert_same, _ulps
from torch_scenarios import to_reference

PATHS = (("lax", "lax"), ("lax", "cuda"))


def padded(cfg, nodes, queues, running, queued):
    snap = build_round_snapshot(cfg, "default", nodes, queues, running, queued)
    return snap, pad_device_round(prep_device_round(snap))


def check_round_paths(name, dev, paths=PATHS):
    """Hold the port's paths to the reference's on the padded round `dev`;
    returns the port's outputs and loop stats by path."""
    got = {}
    for ref_path, port_path in paths:
        d = dataclasses.replace(dev, kernel_path=ref_path)
        want = ref_kernel.solve_round(d)
        port_dev = dataclasses.replace(
            from_reference_round(dataclasses.asdict(d)), kernel_path=port_path)
        assert port_dev.fairness_policy == tuple(dev.fairness_policy)
        stats = {}
        out = port_kernel.solve_round(port_dev, device="cpu", stats=stats)
        _assert_same(f"{name}/{port_path}", out, want)
        assert validate_round(out, dev=port_dev) is None, name
        got[port_path] = (out, stats)
    return got


@pytest.mark.parametrize("kind", NON_DRF)
def test_oracle_parity_round_matches_reference(kind):
    rng = np.random.default_rng(1000)
    nodes, queues, running, queued = rand_scenario(rng, with_running=True)
    if kind == "deadline":
        queued = _stamp_deadlines(queued)
    snap, dev = padded(_cfg(kind), nodes, queues, running, queued)
    assert dev.fairness_policy[0] == kind
    if kind == "deadline":
        assert np.isfinite(dev.queue_deadline[: snap.num_queues]).any()
    got = check_round_paths(f"oracle/{kind}", dev)
    assert int(np.asarray(got["cuda"][0]["scheduled_mask"]).sum()) > 0


@pytest.mark.parametrize("kind", NON_DRF)
def test_extreme_weight_waterfill_matches_reference(kind):
    """Weights across 12 orders of magnitude: the port's entitlements
    within 4/16 ULP of the reference's device solve and of its host
    oracle, the decisions bit-exact."""
    nodes = [
        NodeSpec(id=f"n{i}", pool="default", total_resources={"cpu": "16", "memory": "64Gi"})
        for i in range(3)
    ]
    factors = [1e6, 1e3, 1.0, 1e-3, 1e-6]
    queues = [QueueSpec(f"q{i}", f) for i, f in enumerate(factors)]
    queued = [
        JobSpec(
            id=f"j{i:03d}", queue=f"q{i % len(queues)}",
            requests={"cpu": "2", "memory": "2Gi"}, submitted_ts=float(i),
            annotations={"armadaproject.io/deadline": str(100.0 + 31.0 * i)},
        )
        for i in range(15)
    ]
    snap, dev = padded(_cfg(kind), nodes, queues, [], queued)
    got = check_round_paths(f"extreme/{kind}", dev)
    oracle = ReferenceSolver(snap).solve()
    Q = snap.num_queues
    for out, _ in got.values():
        for key, bound in ULP_BOUNDS.items():
            ulps = _ulps(np.asarray(out[key])[:Q], np.asarray(getattr(oracle, key)))
            assert int(ulps.max()) <= bound, (kind, key)


def _four_resource_round():
    """Four resources, each queue's demand a different mix of them: the
    fractions' float sum depends on its association."""
    total = {"cpu": "10", "memory": "10Gi", "ephemeral-storage": "10Gi", "nvidia.com/gpu": "10"}
    nodes = [NodeSpec(id=f"n{i}", pool="default", total_resources=total) for i in range(3)]
    queues = [QueueSpec(f"q{i}") for i in range(4)]
    queued = [
        JobSpec(
            id=f"j{i:02d}", queue=f"q{i % 4}",
            requests={"cpu": str(1 + (i % 4) % 3), "memory": f"{1 + i % 5}Gi",
                      "ephemeral-storage": f"{1 + (i * 7) % 3}Gi", "nvidia.com/gpu": str(i % 3)},
            submitted_ts=float(i),
        )
        for i in range(24)
    ]
    return padded(_cfg("proportional", base=SchedulingConfig()), nodes, queues, [], queued)


def test_proportional_cost_sums_in_the_reference_association():
    import jax.numpy as jnp

    _, dev = _four_resource_round()
    R = dev.total_resources.shape[0]
    assert R >= 3
    demand = np.minimum(dev.queue_demand_pc.astype(np.float64), dev.queue_pc_limit).sum(axis=1)
    rng = np.random.default_rng(0)
    alloc = np.concatenate([demand, rng.uniform(0, 1, (256, R)) * dev.total_resources])
    frac = np.where(dev.total_resources > 0, alloc / dev.total_resources, 0.0) * dev.drf_multipliers
    seq = frac[:, 0]
    for r in range(1, R):
        seq = seq + frac[:, r]
    pairwise = (frac[:, 0] + frac[:, 1]) + (frac[:, 2] + frac[:, 3])
    reversed_ = frac[:, 3] + frac[:, 2] + frac[:, 1] + frac[:, 0]
    # The round's own demands already tell the associations apart.
    assert (seq[: len(demand)] != pairwise[: len(demand)]).any()
    assert (seq != reversed_).any()

    want = np.asarray(ref_kernel._policy_cost(dev, jnp.asarray(alloc)))
    port_dev = from_reference_round(dataclasses.asdict(dev))
    rd = port_kernel._Round(port_dev, torch.device("cpu"))
    got = port_kernel._policy_cost(rd, torch.as_tensor(alloc)).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, np.maximum(seq, 0.0))


def test_proportional_four_resource_round_matches_reference():
    _, dev = _four_resource_round()
    got = check_round_paths("four_resources", dev)
    assert int(np.asarray(got["cuda"][0]["scheduled_mask"]).sum()) > 0


@pytest.mark.parametrize("kind", NON_DRF)
def test_repolicy_equals_a_fresh_prep_and_the_reference(kind):
    """chip_smoke.py's policy phase replaces the policy fields of a
    prepared bench round instead of preparing 1M jobs again: the replace
    equals a fresh prep of `policy_inputs` field by field, and the
    variant (fast fill, window 64, eviction) solves equal to the
    reference."""
    from armada_tpu_torch.snapshot.round import build_round_snapshot as port_snapshot
    from armada_tpu_torch.solver.kernel_prep import pad_device_round as port_pad
    from armada_tpu_torch.solver.kernel_prep import prep_device_round as port_prep
    from armada_tpu_torch.workload import build_inputs, policy_inputs, repolicy

    inputs = build_inputs(600, 24, n_running=40, fast_fill=True, fill_window=64)
    dev = port_pad(port_prep(port_snapshot(*inputs)))
    fresh = port_pad(port_prep(port_snapshot(*policy_inputs(inputs, kind))))
    variant = repolicy(dev, kind)
    for f in dataclasses.fields(fresh):
        a, b = getattr(fresh, f.name), getattr(variant, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), f.name
        else:
            assert type(a) is type(b) and a == b, f.name
    assert variant.fairness_policy[0] == kind
    assert np.unique(variant.queue_weight[variant.queue_weight > 0]).size == 10
    # The same inputs through the reference's host prep: one padded round.
    cfg, pool, nodes, queues, running, queued = to_reference(policy_inputs(inputs, kind))
    ref_dev = pad_device_round(prep_device_round(build_round_snapshot(
        cfg, pool, nodes, queues, running, queued)))
    assert tuple(ref_dev.fairness_policy) == variant.fairness_policy
    got = check_round_paths(f"repolicy/{kind}", ref_dev)
    assert got["cuda"][1]["merged_fill_loops"] > 0


def policy_scenario(kind, name, fast):
    """A round of tests/torch_scenarios.py under policy `kind` (deadlines
    stamped for the deadline policy), padded, with fast fill on or off."""
    from torch_scenarios import SCENARIOS

    cfg, nodes, queues, running, queued = SCENARIOS[name]()
    if kind == "deadline":
        queued = _stamp_deadlines(queued)
    _, dev = padded(dataclasses.replace(cfg, fairness_policy_default=kind),
                    nodes, queues, running, queued)
    return dataclasses.replace(dev, fast_fill=fast)


def check_policy_scenario(kind, name, fast):
    """Both port paths held to the reference's "lax" path (the reference's
    "pallas" top-B can drop nodes that its lax path keeps, ROADMAP C; the
    port follows the lax path on both of its paths)."""
    dev = policy_scenario(kind, name, fast)
    got = check_round_paths(f"{name}/{kind}/fast={fast}", dev)
    for _, stats in got.values():
        assert stats["fill_loops"] == 0 if fast else stats["merged_fill_loops"] == 0
