"""The generator: seeds, balance, a steady backlog; and the run's last
line."""

import json

import numpy as np
import pytest
from conftest import tiny

from portbench import run as run_mod
from portbench.service import Pool
from portbench.traffic import Traffic


def blocks(seed, traffic="gangs", ks=(0, 1, 2)):
    _, _, config, mix = tiny(traffic)
    t = Traffic(config, mix, seed)
    return [t.block(k) for k in ks]


def test_seeds_differ_and_repeat():
    a, b, c = blocks(7), blocks(7), blocks(2**31 + 11)
    for x, y, z in zip(a, b, c):
        for f in ("queue", "cpu", "runtime", "gang_card"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
        assert not np.array_equal(x.queue, z.queue) or not np.array_equal(x.cpu, z.cpu)


@pytest.mark.parametrize("traffic", ["steady", "gangs"])
def test_every_seed_gets_the_same_work(traffic):
    for x, y in zip(blocks(1, traffic), blocks(99, traffic)):
        for f in ("cpu", "runtime", "gang_card"):
            assert sorted(getattr(x, f)) == sorted(getattr(y, f))
        if traffic == "steady":
            assert sorted(x.queue) == sorted(y.queue)


def test_gangs_share_queue_size_and_runtime():
    for b in blocks(5):
        lead = b.gang_lead - b.first
        assert np.array_equal(b.queue, b.queue[lead])
        assert np.array_equal(b.cpu, b.cpu[lead])
        assert np.array_equal(b.runtime, b.runtime[lead])
        assert (b.gang_card > 1).any()


def test_steady_backlog_holds(quiet):
    _, _, config, mix = tiny("steady")
    pool = Pool(config, mix, 3, device="cpu")
    pool.start()
    for k in range(8):
        pool.step(k)
    leased = [len(d["leases"]) for d in pool.decode()]
    # Each period submits what the burst lets a round lease.
    assert leased == [mix["submit_per_period"]] * 8


def test_last_line_keys(quiet):
    bench, cell, config, mix = tiny("steady")
    line = run_mod.run_cell(bench, cell, config, mix, seed=11, seconds=0.5, trace=False,
                            t0=0.0, device="cpu", log=lambda m: None)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"leases_per_s", "cycle_p80_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_traced_line_keys(quiet, monkeypatch):
    """A traced run's per-layer metrics; on the CPU nothing reads the
    device, so the device's metrics are left out rather than 0."""
    bench, cell, config, mix = tiny("steady")
    line = run_mod.run_cell(bench, cell, config, mix, seed=12, seconds=0.5, trace=True,
                            t0=0.0, device="cpu", log=lambda m: None)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"submit_s", "executor_tick_s", "collector_s", "cycle_rest_s",
                                    "snapshot_s", "sync_s", "sync_bytes", "round_s"}


def test_no_card_no_result(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    assert run_mod.main(["--workload", "pool5k.steady", "--seed", "1", "--seconds", "1",
                         "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
