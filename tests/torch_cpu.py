"""One torch thread per test process, for the port's CPU tests.

The tier-1 run puts six pytest workers on the machine's cores. torch
starts one intra-op thread per core in each of them, and the port's
rounds solve small tensors loop by loop, so the threads only wait on one
another: an oversubscribed worker solved a 600-job round about 50 times
slower than a worker with one thread. The processes a test starts
(launcher workers, the import guard) inherit `OMP_NUM_THREADS`. Results
do not depend on the thread count.

Every `tests/test_torch_*.py` that runs on the CPU imports this module.
"""

import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)
