"""A cell at a size a CPU test run holds: pool5k's settings scaled by 1/25
(200 nodes, a backlog of 400, 40 jobs a period and a burst of 40, so the
pool runs near 28% of its cpu as pool5k does), on the CPU, where the
port's "cuda" kernel path runs its plain versions."""

import json
import logging
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def tiny(traffic: str = "steady", warm: int = 3):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "portbench/configs/pool5k.json").read_text())
    mix = json.loads((ROOT / f"portbench/traffic/{traffic}.json").read_text())
    config.update(nodes=200, executors=2, backlog_jobs=400, max_warm_cycles=warm,
                  maximum_scheduling_burst=40, maximum_per_queue_scheduling_burst=40,
                  maximum_scheduling_rate=4.0, maximum_per_queue_scheduling_rate=2.0)
    mix.update(submit_per_period=40)
    cell = {"name": f"pool5k.{traffic}", "config": "pool5k", "traffic": traffic, "chips": 1}
    return bench, cell, config, mix


@pytest.fixture
def quiet():
    """The program logs a line a round; keep the test output short."""
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)
