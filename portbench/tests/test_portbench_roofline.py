"""The kernels' byte counts from the round's shapes, against the bounds
PERF.md gives for the shapes chip_smoke.py times (N = 65,536, R = 4, one
taint and one label word, an affinity row; fill_take at B = 512)."""

import json
import pathlib

import pytest

from portbench import roofline
from portbench.roofline import fill_take, score_nodes

SMOKE = {"nodes": 65536, "lanes": 4, "taint_words": 1, "label_words": 1, "window": 512}


def ms(nbytes):
    return roofline.least_seconds(nbytes) * 1e3


def test_score_nodes_bound():
    assert ms(score_nodes.launch_bytes(SMOKE, affinity=True)) == pytest.approx(0.00122, rel=5e-3)
    # The rounds here carry no affinity: one bit a node less.
    assert score_nodes.launch_bytes(SMOKE) == score_nodes.launch_bytes(SMOKE, affinity=True) - 65536 // 8


def test_fill_take_bound():
    assert ms(fill_take.launch_bytes(SMOKE)) == pytest.approx(0.000158, rel=5e-3)
    assert fill_take.launch_bytes({**SMOKE, "nodes": 8192, "window": 512}) == 8192 * 8 + 512 * 12


@pytest.mark.parametrize("name,nodes,window", [("pool5k", 8192, 2048), ("pool50k", 65536, 2048)])
def test_round_shape(name, nodes, window):
    config = json.loads((pathlib.Path(roofline.__file__).parents[1] / f"configs/{name}.json").read_text())
    shape = roofline.round_shape(config)
    assert (shape["nodes"], shape["lanes"], shape["window"]) == (nodes, 4, window)
