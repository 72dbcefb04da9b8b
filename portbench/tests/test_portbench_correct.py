"""The check that decides `correct` fails what it must.

The controls: the plain reference put in the program's place with queue
fairness broken (candidates in submission order across queues,
`--control fifo`) or with best fit broken (first fit by node index,
`--control firstfit`). The faults: the timed path broken underneath,
in the round's decisions as the solver hands them to the service, or
in the fill's node choice (the best-fit key without its resource lanes;
the candidates' best node skipped), with the ladder cut to its first
rung as on the card (on the CPU a rejected round would fall back to the
host oracle); and a warm round that the budget cut. The exchange between
chips is not a fault these one-card cells can have."""

import numpy as np
import pytest
from conftest import tiny

import armada_tpu_torch.solver.dist as dist
import armada_tpu_torch.solver.failover as failover
import armada_tpu_torch.solver.kernel as kernel
from portbench import run as run_mod


def run(traffic="steady", seed=21, controls=(), warm=3):
    bench, cell, config, mix = tiny(traffic, warm)
    return run_mod.run_cell(bench, cell, config, mix, seed=seed, seconds=0.6, trace=False,
                            t0=0.0, device="cpu", controls=controls, log=lambda m: None)


@pytest.mark.parametrize("seed", [21, 2**31 + 3])
def test_sound_run_is_correct(quiet, seed):
    line = run(seed=seed)
    assert line["correct"], line["checks"]


def test_control_is_not_correct(quiet):
    line = run(controls=("fifo", "firstfit"))
    fifo, firstfit = line["controls"]["fifo"], line["controls"]["firstfit"]
    assert not fifo["correct"]
    assert fifo["checks"]["lease_mismatches"]["value"] > 0
    assert not firstfit["correct"]
    assert firstfit["checks"]["placement_mismatches"]["value"] > 0
    assert firstfit["checks"]["lease_mismatches"]["value"] == 0
    # The program's own verdict on the same run stands beside them.
    assert line["correct"], line["checks"]


def _unchanged(out, sched):
    out["scheduled_mask"][sched] = False


def _half(out, sched):
    out["scheduled_mask"][sched[::2]] = False


def _altered(out, sched):
    # The first leased job's answer given to a queued job that was not.
    j = sched[0]
    free = np.flatnonzero(~out["scheduled_mask"] & (out["assigned_node"] < 0))
    j2 = free[0]
    for k in ("scheduled_mask", "assigned_node", "scheduled_priority"):
        if k in out:
            out[k][j2] = out[k][j]
    out["scheduled_mask"][j] = False
    out["assigned_node"][j] = -1


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_broken_path_is_not_correct(quiet, monkeypatch, fault):
    solve = kernel.solve_round
    calls = {"n": 0}

    def broken(*a, **kw):
        out = {k: (v if k in ("profile", "truncated") else np.array(v))
               for k, v in solve(*a, **kw).items()}
        calls["n"] += 1
        if calls["n"] == 4:  # a warm cycle's round
            fault(out, np.flatnonzero(out["scheduled_mask"]))
        return out

    ladder = failover.build_ladder
    monkeypatch.setattr(failover, "build_ladder", lambda *a, **kw: ladder(*a, **kw)[:1])
    monkeypatch.setattr(kernel, "solve_round", broken)
    line = run()
    assert calls["n"] >= 4
    assert not line["correct"], line["checks"]


def _no_lanes(fill, self, keys, mask, caps, gids, B, path="lax", nbits=None):
    # The best-fit key with its resource lanes dropped: node order only.
    return fill(self, [gids.to(keys[0].dtype)], mask, caps, gids, B, "lax", None)


def _skip_best(fill, self, keys, mask, caps, gids, B, path="lax", nbits=None):
    # The candidates' best node left out: the fill starts at the second.
    c, g = fill(self, keys, mask, caps, gids, B + 1, path, nbits)
    return c[1:], g[1:]


@pytest.mark.parametrize("fault", [_no_lanes, _skip_best])
def test_wrong_node_is_not_correct(quiet, monkeypatch, fault):
    # Until jobs complete, a pool filled in node order has its fullest
    # nodes first, where first fit and best fit agree: warm up past the
    # shortest runtime (6 periods), so completions free room out of order.
    fill = dist.LocalDist.fill_candidates
    monkeypatch.setattr(dist.LocalDist, "fill_candidates",
                        lambda self, *a, **kw: fault(fill, self, *a, **kw))
    monkeypatch.setattr(failover, "build_ladder",
                        (lambda ladder: lambda *a, **kw: ladder(*a, **kw)[:1])(
                            failover.build_ladder))
    line = run(warm=12)
    assert not line["correct"], line["checks"]
    assert line["checks"]["placement_mismatches"]["value"] > 0
    assert line["checks"]["lease_mismatches"]["value"] == 0


def test_cut_warm_round_is_not_correct(quiet, monkeypatch):
    solve = kernel.solve_round
    calls = {"n": 0}

    def cut(*a, **kw):
        out = dict(solve(*a, **kw))
        calls["n"] += 1
        out["truncated"] = calls["n"] == 3
        return out

    monkeypatch.setattr(kernel, "solve_round", cut)
    line = run()
    assert calls["n"] >= 3
    assert not line["correct"], line["checks"]
    assert line["checks"]["truncated_rounds"]["value"] == 1
