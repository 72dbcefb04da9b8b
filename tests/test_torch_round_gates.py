"""Whole-round parity for the rate, fraction and lookback gates and the
gang scenarios (uniformity search, atomicity): the same check as
tests/test_torch_round.py, in a file of its own so the two run side by
side."""

import pytest
import torch_cpu  # noqa: F401

from test_torch_round import GATE_AND_GANG, check_round_matches_reference


@pytest.mark.parametrize("name", GATE_AND_GANG)
def test_round_matches_reference(name):
    check_round_matches_reference(name)
