"""Fast fill on every round of tests/torch_scenarios.py: the same check as
tests/test_torch_fast_fill.py, in a file of its own so the two run side by
side."""

import pytest
import torch_cpu  # noqa: F401

from test_torch_fast_fill import check_fast_fill, fast_round
from torch_scenarios import SCENARIOS


# Rounds of gangs only: no slot is batchable, so no loop merges.
GANGS_ONLY = ("gang_uniformity", "gang_uniformity_unknown_label")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_fast_fill_round_matches_reference(name):
    check_fast_fill(name, fast_round(*SCENARIOS[name]()), merges=name not in GANGS_ONLY)
