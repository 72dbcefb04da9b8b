"""Whole-round parity: the port's solve_round against the JAX package's.

Both solvers consume one padded round: the reference's host prep builds
it, and `from_reference_round` hands its fields to the port. Both of the
port's paths, "cuda" (on CPU tensors: the kernels' plain versions) and
"lax", are held against the reference's "lax" path (the reference's own
fused "pallas" path is its tests' to hold to its "lax" path,
tests/test_pallas_parity.py; the round where the two differ is
`test_fill_sort_follows_stable_sort_where_reference_top_b_drops_nodes`):

- the decisions (assigned_node, scheduled_priority, scheduled_mask,
  preempted_mask), num_loops and spot_price are bit-exact;
- the fair shares are within 4 ULP (fair_share, demand_capped_fair_share)
  and 16 ULP (uncapped_fair_share): float64 sums taken in another order,
  the bounds the reference holds its own kernel to;
- the port's round firewall admits every round.
"""

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu.snapshot.round import build_round_snapshot
from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver.kernel_prep import pad_device_round, prep_device_round
from armada_tpu_torch.ops.kernels import pack_plan
from armada_tpu_torch.solver import kernel as port_kernel
from armada_tpu_torch.solver.kernel_prep import from_reference_round
from armada_tpu_torch.solver.validate import validate_round
from torch_scenarios import SCENARIOS

EXACT_KEYS = (
    "assigned_node", "scheduled_priority", "scheduled_mask", "preempted_mask",
    "num_loops", "spot_price",
)
ULP_BOUNDS = {
    "fair_share": 4,
    "demand_capped_fair_share": 4,
    "uncapped_fair_share": 16,
}


def _ordered(x):
    i = np.ascontiguousarray(x, dtype=np.float64).view(np.int64)
    return np.where(i < 0, np.int64(-(2**63)) - i, i)


def _ulps(a, b):
    return np.abs(_ordered(a) - _ordered(b))


def _reference_round(name):
    cfg, nodes, queues, running, queued = SCENARIOS[name]()
    snap = build_round_snapshot(cfg, "default", nodes, queues, running, queued)
    return pad_device_round(prep_device_round(snap))


def _assert_same(name, got, want):
    assert set(got) == set(want), name
    for k in EXACT_KEYS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
        assert np.array_equal(g, w, equal_nan=True), f"{name}: {k} diverged"
    for k, bound in ULP_BOUNDS.items():
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape, (name, k)
        assert int(_ulps(g, w).max()) <= bound, f"{name}: {k} beyond {bound} ULP"


GATE_AND_GANG = (
    "gang_atomicity", "gang_uniformity", "gang_uniformity_impossible",
    "gang_uniformity_unknown_label", "lookback", "rate_limited", "round_fraction",
)


def check_round_matches_reference(name):
    dev = _reference_round(name)
    outs = {}
    d = dataclasses.replace(dev, kernel_path="lax")
    want = ref_kernel.solve_round(d)
    for port_path in ("cuda", "lax"):
        port_dev = dataclasses.replace(
            from_reference_round(dataclasses.asdict(d)), kernel_path=port_path)
        got = port_kernel.solve_round(port_dev, device="cpu")
        _assert_same(f"{name}/{port_path}", got, want)
        assert validate_round(got, dev=port_dev) is None, name
        outs[port_path] = got
    # The fused path engaged (the pack plan fits) and agrees with lax.
    assert pack_plan(dev) is not None
    for k in outs["lax"]:
        assert np.array_equal(outs["cuda"][k], outs["lax"][k], equal_nan=True), k


@pytest.mark.parametrize(
    "name", sorted(set(SCENARIOS) - set(GATE_AND_GANG))
)
def test_round_matches_reference(name):
    check_round_matches_reference(name)


def test_fill_loops_ran():
    """The batched fill (the kernels' caller) runs in the random rounds."""
    dev = from_reference_round(dataclasses.asdict(_reference_round("random_queued")))
    stats = {}
    port_kernel.solve_round(dev, device="cpu", stats=stats)
    assert stats["fill_loops"] > 0 and stats["gang_loops"] > 0


def test_readback_rows_trim_is_byte_identical():
    dev = from_reference_round(dataclasses.asdict(_reference_round("random_running")))
    full = port_kernel.solve_round(dev, device="cpu")
    trimmed = port_kernel.solve_round(dev, device="cpu", readback_rows=3)
    for k in full:
        assert full[k].dtype == trimmed[k].dtype
        assert np.array_equal(full[k], trimmed[k], equal_nan=True), k


def test_unported_paths_raise():
    """Only a kernel path the port does not have raises now (ValueError).
    The two rounds this test once held to NotImplementedError, a market
    round and a proportional one, solve equal to the reference
    (tests/test_torch_market.py and test_torch_policy*.py hold many more);
    and solve_round takes the round budget, hot window and profile
    options with the reference's keywords (tests/test_torch_hotwindow.py,
    test_torch_round_deadline.py)."""
    ref_dev = _reference_round("rate_limited")
    for ref_round in (
        dataclasses.replace(ref_dev, market_driven=True, batch_window=0),
        dataclasses.replace(ref_dev, fairness_policy=("proportional",)),
    ):
        want = ref_kernel.solve_round(ref_round)
        got = port_kernel.solve_round(
            from_reference_round(dataclasses.asdict(ref_round)), device="cpu"
        )
        _assert_same(f"formerly unported {ref_round.fairness_policy}", got, want)
    dev = from_reference_round(dataclasses.asdict(ref_dev))
    with pytest.raises(ValueError, match="kernel_path"):
        port_kernel.solve_round(dataclasses.replace(dev, kernel_path="pallas"), device="cpu")
    fused = port_kernel.solve_round(dev, device="cpu")
    for kw in (
        {"budget_s": 60.0, "chunk_loops": 3},
        {"window": 64, "window_min_slots": 0},
        {"profile": True},
    ):
        out = port_kernel.solve_round(dev, device="cpu", **kw)
        # A window that cannot shrink this small round disengages: the
        # fused solve, with neither key (as in the reference).
        assert ("profile" in out) == ("window" not in kw), kw
        assert ("truncated" in out) == ("budget_s" in kw), kw
        for k in fused:
            assert np.array_equal(out[k], fused[k], equal_nan=True), (kw, k)


def test_fill_sort_follows_stable_sort_where_reference_top_b_drops_nodes():
    """A nearly full pool with more nodes than the fill window: 13 nodes of
    1 cpu, then 3 of 8 cpu, jobs of 2 cpu, batch_fill_window=4. Fewer than
    4 nodes fit, so the reference's top-B (`fill_take`) takes the first 4
    node indices, none of which fit: its fused path never fills and runs
    21 loops where its lax path runs 4 (ROADMAP C). The port's top-B is the
    stable sort, so both its paths equal the reference's lax path."""
    from armada_tpu.core.config import SchedulingConfig
    from armada_tpu.core.types import JobSpec, NodeSpec, QueueSpec

    nodes = [
        NodeSpec(id=f"n{i:02d}", pool="default",
                 total_resources={"cpu": "1" if i < 13 else "8", "memory": "32Gi"})
        for i in range(16)
    ]
    queued = [
        JobSpec(id=f"j{i}", queue="q", requests={"cpu": "2", "memory": "1Gi"},
                submitted_ts=i)
        for i in range(10)
    ]
    snap = build_round_snapshot(
        SchedulingConfig(batch_fill_window=4), "default", nodes, [QueueSpec("q")],
        [], queued,
    )
    dev = pad_device_round(prep_device_round(snap))
    want = ref_kernel.solve_round(dataclasses.replace(dev, kernel_path="lax"))
    ref_fused = ref_kernel.solve_round(dataclasses.replace(dev, kernel_path="pallas"))
    assert int(want["num_loops"]) == 4 and int(ref_fused["num_loops"]) == 21
    for ref_path in ("pallas", "lax"):
        port_dev = from_reference_round(
            dataclasses.asdict(dataclasses.replace(dev, kernel_path=ref_path))
        )
        got = port_kernel.solve_round(port_dev, device="cpu")
        _assert_same(f"top-b/{port_dev.kernel_path}", got, want)


def _pairwise_numpy(x):
    """The fixed-order sum of `_fixed_sum` in numpy float64 scalars:
    adjacent pairs level by level, an odd last entry carried up."""
    level = [np.float64(v) for v in x]
    while len(level) > 1:
        nxt = [level[i] + level[i + 1] for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


@pytest.mark.parametrize("q", range(1, 65))
def test_fixed_sum_is_the_pairwise_sum_bit_for_bit(q):
    """The water-fill's sums (`_fixed_sum`, ROADMAP C4) are the pairwise
    sum in one fixed order: bit for bit numpy's in that order, along
    either axis of a [Q, R] table, over weights of mixed magnitudes
    (queue weights, capped shares, spares) and exact zeros."""
    import torch

    rng = np.random.default_rng(q)
    x = rng.random(q) * 10.0 ** rng.integers(-6, 3, size=q)
    x[rng.random(q) < 0.25] = 0.0
    got = port_kernel._fixed_sum(torch.as_tensor(x))
    assert got.dtype == torch.float64 and got.shape == ()
    assert got.numpy().tobytes() == _pairwise_numpy(x).tobytes()
    table = rng.random((q, 3)) * 1e3
    by_rows = port_kernel._fixed_sum(torch.as_tensor(table), dim=1).numpy()
    assert by_rows.tobytes() == np.array([_pairwise_numpy(r) for r in table]).tobytes()
    by_cols = port_kernel._fixed_sum(torch.as_tensor(table), dim=0).numpy()
    assert by_cols.tobytes() == np.array([_pairwise_numpy(c) for c in table.T]).tobytes()
