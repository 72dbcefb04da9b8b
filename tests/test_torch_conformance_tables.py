"""The Go table cases and the scale sweep held side by side with the JAX
package (ROADMAP C1).

tests/test_reference_tables.py's 27 cases (taken from Go's
preempting_queue_scheduler_test.go, with the scheduled and preempted sets
Go expects each round) and tests/test_parity_scale.py's sweep (128 and
256 nodes; its 1,000-node x 2,000-job case behind the reference's own
switch, ARMADA_TPU_BIG_PARITY) run as they are on the JAX package, then
compiled from their source with the port in place of the JAX package and
`torch_conformance.assert_parity` in place of tests/test_kernel_parity.py's
(`run_side_by_side`). Every round of the reference's run is recorded, and
the port's twin holds the same round, in the same order:

- the port's padded round equal to the reference's, field for field;
- the port's "lax" solve equal to the port's host oracle under the
  reference's checks;
- the port's solve equal to the reference's `solve_round`: the decisions,
  num_loops and spot_price bit for bit, the fair shares within 4 ULP (16
  for the uncapped accumulator).

The tables' expected sets hold on both packages (each side's own
assertions). chip_smoke.py's phase 19 runs the same port copies on the
card, "cuda" against "lax".
"""

import importlib

import pytest
import torch_cpu  # noqa: F401

from torch_conformance import PARITY_IMPORT, case_names, parity, record_reference
from torch_control_plane import case_marks, run_side_by_side

TO_TWIN = ((PARITY_IMPORT, "from torch_conformance import assert_parity"),)


def _cases():
    out = [("test_reference_tables", t, ()) for t in
           case_names(importlib.import_module("test_reference_tables"))]
    scale = importlib.import_module("test_parity_scale")
    for mark in scale.test_scale_parity.pytestmark:
        if mark.name == "parametrize":
            out += [("test_parity_scale", "test_scale_parity", tuple(a)) for a in mark.args[1]]
    return out + [("test_parity_scale", "test_thousand_node_parity", ())]


CASES = _cases()


def test_every_case_is_collected():
    """The 27 table cases, the two default scale cases and the opt-in
    1,000-node case."""
    assert len(CASES) == 27 + 2 + 1


@pytest.mark.parametrize(
    "name, test, args",
    [pytest.param(n, t, a, marks=case_marks(n, t)) for n, t, a in CASES],
    ids=[f"{n}::{t}{list(a) if a else ''}" for n, t, a in CASES],
)
def test_case_matches_reference(name, test, args, monkeypatch, tmp_path):
    rounds = record_reference(monkeypatch)
    with parity(device="cpu", paths=("lax",), reference=rounds) as state:
        run_side_by_side(name, test, monkeypatch, tmp_path, args=args, port_subs=TO_TWIN)
        assert state.rounds > 0
    assert not rounds, f"{name}::{test}: the port solved fewer rounds than the reference"
