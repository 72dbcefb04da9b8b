"""The round budget (solve_round's budget_s) and the host-driven driver:
the port against the JAX package, on the CPU.

Port copies of tests/test_round_deadline.py's kernel cases, on the same
padded rounds handed to the port by `from_reference_round`. A budget of
1e-6 is spent before the first loop, so pass 1 runs exactly one chunk
of `chunk_loops` loops (the forward-progress floor) and the truncated
round is deterministic: the port's is bit-exact against the reference's,
`truncated` and `num_loops` included. Also: a generous budget equals the
unbudgeted solve, truncation with evictions never over-preempts (the
rescue pass), the host-driven outputs carry the reference's profile
keys, and the solve's transfer ledger books the reference's up and down
bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu.snapshot.round import build_round_snapshot
from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver.kernel_prep import pad_device_round, prep_device_round
from armada_tpu_torch.observe import ledger
from armada_tpu_torch.solver import kernel as port_kernel
from armada_tpu_torch.solver.kernel_prep import from_reference_round
from test_round_deadline import _evicting_inputs, _inputs
from test_torch_round import _assert_same

REF_ONLY = ("profile", "truncated")


def _round(inputs):
    cfg, nodes, queues, running, queued = inputs
    snap = build_round_snapshot(cfg, "default", nodes, queues, running, queued)
    return snap, pad_device_round(prep_device_round(snap))


def _queued_round():
    cfg, nodes, queues, queued = _inputs()
    return _round((cfg, nodes, queues, [], queued))


def _arrays(out):
    return {k: v for k, v in out.items() if k not in REF_ONLY}


@pytest.mark.parametrize("chunk_loops", [1, 3])
def test_truncated_round_bit_exact(chunk_loops):
    """budget_s=1e-6: pass 1 runs exactly `chunk_loops` loops, then the
    finish; the port's cut equals the reference's, `truncated` and
    `num_loops` included, on both of the port's kernel paths."""
    snap, dev = _queued_round()
    want = ref_kernel.solve_round(dev, budget_s=1e-6, chunk_loops=chunk_loops)
    assert want["truncated"] is True
    for ref_path in ("lax", "pallas"):
        pdev = from_reference_round(dataclasses.asdict(dataclasses.replace(dev, kernel_path=ref_path)))
        got = port_kernel.solve_round(pdev, device="cpu", budget_s=1e-6, chunk_loops=chunk_loops)
        assert got["truncated"] is True
        _assert_same(f"cut/{chunk_loops}/{pdev.kernel_path}", _arrays(got), _arrays(want))
        assert set(got["profile"]) == set(want["profile"])
        assert got["profile"]["gang_loops"] == want["profile"]["gang_loops"] == chunk_loops
        placed = int(got["scheduled_mask"][: snap.num_jobs].sum())
        assert 1 <= placed < snap.num_jobs


def test_generous_budget_matches_unbudgeted():
    snap, dev = _queued_round()
    pdev = from_reference_round(dataclasses.asdict(dev))
    full = port_kernel.solve_round(pdev, device="cpu")
    assert "truncated" not in full and "profile" not in full
    budgeted = port_kernel.solve_round(pdev, device="cpu", budget_s=120.0)
    assert budgeted["truncated"] is False
    for k in full:
        assert np.array_equal(budgeted[k], full[k], equal_nan=True), k
    _assert_same("full", full, ref_kernel.solve_round(dev))


def test_truncation_with_evictions_never_over_preempts():
    """The rescue pass: a cut round preempts a subset of the full round's
    jobs, places a prefix of its queued jobs on the same nodes, and
    leaves every running job it did not preempt on its own node. The
    port's cut is held to the port's full round, and that full round to
    the reference's fused solve (no reference chunk program compiles)."""
    snap, dev = _round(_evicting_inputs())
    J = snap.num_jobs
    pdev = from_reference_round(dataclasses.asdict(dev))
    full = port_kernel.solve_round(pdev, device="cpu")
    _assert_same("evicting full", full, ref_kernel.solve_round(dev))
    cut = port_kernel.solve_round(pdev, device="cpu", budget_s=1e-6)
    assert cut["truncated"] is True
    cut_pre = set(np.flatnonzero(cut["preempted_mask"][:J]))
    full_pre = set(np.flatnonzero(full["preempted_mask"][:J]))
    assert cut_pre <= full_pre
    placed = np.flatnonzero(cut["scheduled_mask"][:J])
    assert full["scheduled_mask"][:J][placed].all()
    assert (cut["assigned_node"][:J][placed] == full["assigned_node"][:J][placed]).all()
    for j in np.flatnonzero(snap.job_is_running):
        if j not in cut_pre:
            assert cut["assigned_node"][j] == snap.job_node[j]


def test_transfer_ledger_matches_reference():
    """The host-driven profile's transfer ledger books the reference's up
    and down bytes and arrays for the same host round, and the fused
    solve books the same into an outer ledger."""
    _, dev = _queued_round()
    want = ref_kernel.solve_round(dev, profile=True)["profile"]["transfer"]
    pdev = from_reference_round(dataclasses.asdict(dev))
    got = port_kernel.solve_round(pdev, device="cpu", profile=True)["profile"]["transfer"]
    assert set(got) == set(want)
    for k in ("bytes_up", "arrays_up", "bytes_down", "arrays_down"):
        assert got[k] == want[k], k
    assert want["bytes_up"] > 0 and want["bytes_down"] > 0
    with ledger.round_ledger() as outer:
        port_kernel.solve_round(pdev, device="cpu")
    fused = outer.as_dict()
    for k in ("bytes_up", "arrays_up", "bytes_down", "arrays_down"):
        assert fused[k] == want[k], k


def test_tree_transfer_size_host_leaves_only():
    """Uploads count host leaves only (numpy arrays and CPU tensors, not
    numpy scalars); downloads count every array leaf."""
    import torch

    tree = {
        "a": np.zeros((4, 2), np.int32),
        "b": [torch.zeros(3, dtype=torch.float64), np.float64(1.0)],
        "c": (None, 7, "x"),
    }
    assert ledger.tree_transfer_size(tree, host_only=True) == (32 + 24, 2)
    assert ledger.tree_transfer_size(tree) == (32 + 24 + 8, 3)
    with ledger.round_ledger() as outer, ledger.round_ledger() as inner:
        ledger.note_up(tree, site="up")
        ledger.note_donated(tree["a"], site="d")
    assert outer.as_dict() == inner.as_dict()
    assert inner.bytes_up == 56 and inner.donated_bytes == 32 and inner.sites == {"up": 1, "d": 1}


@pytest.mark.parametrize("kind", ["proportional", "priority", "deadline", "market"])
def test_truncated_policy_and_market_rounds_bit_exact(kind):
    """budget_s=1e-6 with 3-loop chunks under each fairness policy and on
    a market round (market_round(16, 256), which sets a spot price): the
    port's cut equals the reference's, `truncated` and `num_loops`
    included, and the rescue pass runs on the evicted jobs."""
    from armada_tpu_torch.workload import repolicy

    if kind == "market":
        from armada_tpu.parallel.scenarios import market_round

        dev = pad_device_round(prep_device_round(market_round(16, 256)))
    else:
        dev = repolicy(_round(_evicting_inputs())[1], kind)
    want = ref_kernel.solve_round(dev, budget_s=1e-6, chunk_loops=3)
    assert want["truncated"] is True
    got = port_kernel.solve_round(
        from_reference_round(dataclasses.asdict(dev)), device="cpu", budget_s=1e-6, chunk_loops=3
    )
    assert got["truncated"] is True
    _assert_same(f"cut/{kind}", _arrays(got), _arrays(want))
    assert {k: got["profile"][k] for k in ("gang_loops", "fill_loops", "merged_fill_loops")} == {
        k: want["profile"][k] for k in ("gang_loops", "fill_loops", "merged_fill_loops")}
