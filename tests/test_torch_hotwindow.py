"""Hot-window compaction (solver/hotwindow.py and the compacted driver of
solve_round): the port against the JAX package, on the CPU.

Port copies of tests/test_hotwindow.py's rounds, each one padded round
from the reference's prep handed to the port by `from_reference_round`.
Windows are tiny (1 to 4 slots against rounds of a hundred slots and
more), so pass 1 rewindows many times. Each round holds:

- the port's compacted solve against the reference's fused solve_round:
  decisions, num_loops and spot_price bit-exact, fair shares within
  4/16 ULP (`test_torch_round._assert_same`), on both of the port's
  kernel paths ("cuda" with the kernels' plain versions, and "lax")
  against the reference's "lax" path;
- the port's compacted solve against the port's fused solve, every array;
- on the forced-rewindow round, `compacted`, `rewindows` and the pass-1
  loop counts by kind equal to the reference's own windowed profile.

And the port's `gather_window` and `scatter_back` against the
reference's, field by field, on one (round, carry, pointers) with dead
window rows and out-of-window evicted jobs, across one real window chunk.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401
import torch

from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver import hotwindow as ref_hotwindow
from armada_tpu.solver.kernel_prep import pad_device_round, prep_device_round
from armada_tpu_torch.solver import hotwindow, kernel as port_kernel
from armada_tpu_torch.solver.kernel_prep import from_reference_round
from test_hotwindow import _dev
from test_torch_round import _assert_same

PROFILE_KEYS = {
    "setup_s", "pass1_s", "gather_s", "finish_s", "gang_loops", "fill_loops",
    "merged_fill_loops", "compacted", "window_slots", "rewindows", "transfer",
}
LOOP_KEYS = ("gang_loops", "fill_loops", "merged_fill_loops", "compacted", "window_slots",
             "rewindows")


def _port(dev, ref_path):
    return from_reference_round(dataclasses.asdict(dataclasses.replace(dev, kernel_path=ref_path)))


def _same_arrays(got, want, label):
    for k in want:
        if k in ("profile", "truncated"):
            continue
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k]), equal_nan=True), (label, k)


def check_window(name, dev, window, **kw):
    """Hold the port's compacted solve of `dev`, on both of its kernel
    paths, to the reference's fused "lax" solve and to its own fused
    solve; returns the port's compacted outputs by port path. (The
    reference's "pallas" path is not the target: its top-B drops nodes
    where equal keys straddle its threshold, ROADMAP C, and the port
    follows the stable sort, as the reference's "lax" path does.)"""
    want = ref_kernel.solve_round(dataclasses.replace(dev, kernel_path="lax"))
    outs = {}
    for ref_path, port_path in (("pallas", "cuda"), ("lax", "lax")):
        pdev = _port(dev, ref_path)
        assert pdev.kernel_path == port_path
        got = port_kernel.solve_round(pdev, device="cpu", window=window, window_min_slots=0, **kw)
        assert set(got["profile"]) == PROFILE_KEYS, name
        assert got["profile"]["compacted"], f"{name}: the window did not engage"
        _assert_same(f"{name}/{port_path}", {k: got[k] for k in want}, want)
        _same_arrays(got, port_kernel.solve_round(pdev, device="cpu"), f"{name}/{port_path} fused")
        outs[port_path] = got
    return outs


@pytest.mark.parametrize("fast_fill", [False, True])
def test_compacted_solve_bit_exact_with_forced_rewindows(fast_fill):
    """Evictions, fair preemption, gangs and the uniformity search at a
    window of 4 slots: bit-exact with the fused solve across many
    rewindows, and the port's windowed profile is the reference's
    (compaction, rewindows and the pass-1 loops by kind), as is its
    uncompacted host-driven profile."""
    dev = _dev(fast_fill=fast_fill)
    outs = check_window(f"rewindows/fast_fill={fast_fill}", dev, 4)
    ref = ref_kernel.solve_round(
        dataclasses.replace(dev, kernel_path="lax"), window=4, window_min_slots=0
    )["profile"]
    assert ref["compacted"] and ref["rewindows"] >= 1
    for got in outs.values():
        assert {k: got["profile"][k] for k in LOOP_KEYS} == {k: ref[k] for k in LOOP_KEYS}
    seg = port_kernel.solve_round(_port(dev, "lax"), device="cpu", profile=True)
    assert not seg["profile"]["compacted"] and seg["profile"]["rewindows"] == 0
    _same_arrays(seg, outs["lax"], "segmented")
    loops = sum(seg["profile"][k] for k in ("gang_loops", "fill_loops", "merged_fill_loops"))
    assert loops == sum(ref[k] for k in ("gang_loops", "fill_loops", "merged_fill_loops"))


def test_window_smaller_than_one_gang():
    """A 4-wide gang is ONE slot, so a 1-slot window still places it
    atomically, the uniformity-search gangs included."""
    check_window("window<gang", _dev(fast_fill=False, bw=1), 1)


def test_compacted_solve_bit_exact_home_away():
    """The mixed-fleet set's home/away round (away pools borrowing
    tainted nodes; fast fill on), with the batch window shrunk so that a
    window of 2 slots truncates the streams. The market half of the
    reference's test waits for the market-round slice."""
    from armada_tpu.parallel.scenarios import home_away_round

    snap = home_away_round(24, 96)
    snap = dataclasses.replace(snap, config=dataclasses.replace(snap.config, batch_fill_window=4))
    check_window("home_away", pad_device_round(prep_device_round(snap)), 2)


def test_budgeted_window_truncates_to_prefix():
    """Round budget and compaction compose: a generous budget equals the
    unbudgeted solve; a budget of 1e-6 runs exactly one pass-1 loop in
    the first window, bit-exact with the reference's own cut, and commits
    a prefix of the full round."""
    dev = _dev(fast_fill=True)
    pdev = _port(dev, "lax")
    full = port_kernel.solve_round(pdev, device="cpu", window=4, window_min_slots=0)
    _same_arrays(full, port_kernel.solve_round(pdev, device="cpu"), "windowed against fused")
    generous = port_kernel.solve_round(
        pdev, device="cpu", window=4, window_min_slots=0, budget_s=120.0
    )
    assert generous["truncated"] is False
    _same_arrays(generous, full, "generous budget")
    cut = port_kernel.solve_round(pdev, device="cpu", window=4, window_min_slots=0, budget_s=1e-6)
    assert cut["truncated"] is True and cut["profile"]["compacted"]
    want = ref_kernel.solve_round(
        dataclasses.replace(dev, kernel_path="lax"), window=4, window_min_slots=0, budget_s=1e-6
    )
    assert want["truncated"] is True
    _assert_same("cut", {k: cut[k] for k in want if k not in ("profile", "truncated")},
                 {k: v for k, v in want.items() if k not in ("profile", "truncated")})
    placed = np.flatnonzero(cut["scheduled_mask"])
    assert len(placed) and full["scheduled_mask"][placed].all()
    assert (cut["assigned_node"][placed] == full["assigned_node"][placed]).all()


def test_tiny_round_disengages():
    """A round the window axes cannot shrink runs uncompacted (the
    profile reports compaction off; the result is the fused one)."""
    dev = _dev(fast_fill=False, n_jobs=12, n_running=0, gangs=0, bw=0)
    want = ref_kernel.solve_round(dataclasses.replace(dev, kernel_path="lax"))
    got = port_kernel.solve_round(
        _port(dev, "lax"), device="cpu", window=2048, window_min_slots=0, profile=True
    )
    assert not got["profile"]["compacted"] and got["profile"]["window_slots"] == 0
    _assert_same("disengaged", {k: got[k] for k in want}, want)


def _field(x):
    """A window field as numpy (bitset words back to uint32)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def test_gather_and_scatter_match_reference():
    """gather_window and scatter_back against the reference's, field by
    field: one queue's pointer 2 slots short of its end (dead slot and job
    rows), the hog queue's evicted jobs outside the windows, Ep above
    their count (dead evicted rows); then one window chunk on each side
    and the scatter back into the full carry."""
    dev = _dev(fast_fill=True)
    Ws = 4
    ref_c, ref_ptr, ref_budgets, *_ = ref_kernel._pass1_begin(dev)
    rd = port_kernel._Round(_port(dev, "lax"), torch.device("cpu"))
    c, ptr, budgets, *_ = port_kernel._pass1_begin(rd)
    assert np.array_equal(ptr, np.asarray(ref_ptr))
    # One known difference of the setups: the reference's rank walk
    # scatters a singleton's padded member columns (clipped to job 0) with
    # the first slot's ranks, and XLA keeps job 0's old -1 (ROADMAP C);
    # the port ranks job 0 at 0. The gather is held on the same carry.
    ref_rank = np.array(ref_c.evict_rank)
    diff = np.flatnonzero(c.evict_rank.numpy() != ref_rank)
    assert diff.tolist() == [0] and ref_rank[0] == -1
    c = c._replace(evict_rank=torch.as_tensor(ref_rank))
    ptr = ptr.copy()
    ptr[2] = int(dev.queue_slot_end[2]) - 2
    n_ev = int(torch.sum(c.evict_rank >= 0))
    Ep = port_kernel._pow2(n_ev, 1) * 2

    ref = ref_hotwindow.gather_window(dev, ref_c, ptr, Ws, Ep)
    got = hotwindow.gather_window(rd.h, rd.t, c, ptr, Ws, Ep)
    ref_dev_w, ref_c_w, ref_ptr_w, ref_trunc, ref_len, ref_sidx, ref_jidx = ref
    h_w, t_w, c_w, ptr_w, trunc, win_len, sidx, jidx = got
    assert (np.asarray(ref_sidx) < 0).any() and (np.asarray(ref_jidx) < 0).any()
    assert np.asarray(ref_trunc).any() and not np.asarray(ref_trunc).all()
    for name, want, mine in (
        ("ptr_w", ref_ptr_w, ptr_w), ("trunc", ref_trunc, trunc), ("win_len", ref_len, win_len),
        ("sidx", ref_sidx, sidx), ("jidx", ref_jidx, jidx),
    ):
        assert np.array_equal(np.asarray(want), np.asarray(mine)), name
    for f in dataclasses.fields(ref_dev_w):
        want = getattr(ref_dev_w, f.name)
        if not hasattr(want, "shape") or getattr(want, "ndim", 0) == 0:
            continue
        want = np.asarray(want)
        for side, mine in (("h", getattr(h_w, f.name)), ("t", getattr(t_w, f.name))):
            mine = _field(mine)
            if want.dtype == np.uint32:
                mine = mine.view(np.uint32)
            assert mine.dtype == want.dtype and np.array_equal(mine, want), (side, f.name)
    for name in ("job_node", "job_prio", "job_evicted", "job_scheduled", "evict_rank",
                 "slot_state"):
        assert np.array_equal(_field(getattr(c_w, name)), np.asarray(getattr(ref_c_w, name))), name

    # One window chunk of up to 3 loops on each side, then the scatter
    # back.
    rd_w = port_kernel._Round(h_w, torch.device("cpu"), t=t_w, base=rd)
    c_w, ptr_w, _ = port_kernel._pass1_segment(rd_w, c_w, ptr_w, False, budgets, 3,
                                               window_trunc=trunc)
    ref_c_w, ref_ptr_w, _, _ = ref_kernel._pass1_window_chunk(
        ref_dev_w, ref_c_w, ref_ptr_w, np.zeros((), bool), np.zeros(3, np.int32),
        ref_budgets, np.int32(3), ref_trunc,
    )
    # The rewindow handshake stops both after the first merged loop.
    assert c_w.loops == int(ref_c_w.loops) >= 1
    merged, new_ptr = hotwindow.scatter_back(c, c_w, ptr_w, sidx, jidx, ptr, Ws)
    ref_merged, ref_new_ptr = ref_hotwindow.scatter_back(
        ref_c, ref_c_w, ref_ptr_w, ref_sidx, ref_jidx, ptr, Ws
    )
    assert np.array_equal(new_ptr, np.asarray(ref_new_ptr))
    for name in ("job_node", "job_prio", "job_evicted", "job_scheduled", "evict_rank",
                 "slot_state", "alloc", "qalloc", "tokens", "qtokens"):
        assert np.array_equal(
            _field(getattr(merged, name)), np.asarray(getattr(ref_merged, name))
        ), name
    assert np.array_equal(merged.unfeasible, np.asarray(ref_merged.unfeasible))


@pytest.mark.parametrize("kind", ["proportional", "priority", "deadline"])
def test_compacted_solve_bit_exact_under_policy(kind):
    """Each fairness policy at a window of 4 slots with fast fill on: the
    policy's rank key leads the pick, the merged step and the eviction
    ranks in every window, bit-exact with the fused solve."""
    from armada_tpu_torch.workload import repolicy

    check_window(f"policy/{kind}", repolicy(_dev(fast_fill=True), kind), 4)


def test_compacted_solve_bit_exact_market():
    """The market half of the reference's mixed-fleet window test: the
    market round (price order, no fill, so a lookahead of 1) at a window
    of 2 slots."""
    from armada_tpu.parallel.scenarios import mixed_fleet_rounds

    (_, snap), = [r for r in mixed_fleet_rounds(24, 96) if r[0] == "market"]
    dev = pad_device_round(prep_device_round(snap))
    assert dev.market_driven and hotwindow.window_lookahead(dev) == 1
    outs = check_window("market", dev, 2)
    assert all(o["profile"]["rewindows"] >= 1 for o in outs.values())
