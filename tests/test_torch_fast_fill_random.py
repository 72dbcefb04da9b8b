"""Fast fill on the random rounds of tests/test_fill.py: seeds 0 to 5
queued-only with gangs, seeds 6 to 9 with running jobs, the same check as
tests/test_torch_fast_fill.py, in a file of its own so the two run side
by side."""

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from test_kernel_parity import PREEMPT_CFG, rand_scenario
from test_torch_fast_fill import check_fast_fill, fast_round


@pytest.mark.parametrize("seed", range(10))
def test_random_fast_fill_round_matches_reference(seed):
    rng = np.random.default_rng(1000 + seed)
    if seed < 6:
        nodes, queues, running, queued = rand_scenario(rng, with_running=False, with_gangs=True)
        running = []
    else:
        nodes, queues, running, queued = rand_scenario(rng, with_running=True)
    check_fast_fill(f"seed={seed}", fast_round(PREEMPT_CFG, nodes, queues, running, queued))
