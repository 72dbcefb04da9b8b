"""Every round of tests/torch_scenarios.py under each fairness policy
with fast fill on (the policy's rank key leads the merged step's entry
keys and its barrier): the check of tests/test_torch_policy.py, in a
file of its own so the sweeps run side by side."""

import pytest
import torch_cpu  # noqa: F401

from test_policy import NON_DRF
from test_torch_policy import check_policy_scenario
from torch_scenarios import SCENARIOS


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("kind", NON_DRF)
def test_policy_fast_fill_round_matches_reference(kind, name):
    check_policy_scenario(kind, name, fast=True)
